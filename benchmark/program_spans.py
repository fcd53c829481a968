"""What the program's spans and its resize counter read over the traced
units: ``dasac_tpu_torch.utils.spans`` records spans only while a profiler
runs, so after ``trace.record`` its totals are those of the traced steps
or frames.  A program without the module, or a run without the spans,
reads ``None``."""

import importlib


def _spans():
    try:
        return importlib.import_module("dasac_tpu_torch.utils.spans")
    except ImportError:
        return None


def ms_per_unit(r, names, field="stream_ms"):
    """The ``field`` ms of the spans ``names``, summed, a traced unit;
    ``None`` when the program recorded none of them."""
    mod = _spans()
    if mod is None:
        return None
    totals = mod.totals()
    got = [getattr(totals[n], field) for n in names if n in totals]
    return sum(got) / r.trace.units if got else None


def host_matrix_mb_per_unit(r):
    """MB of host-built interpolation matrices copied to the device a
    traced unit (``nn.functional.HOST_MATRICES``' growth since the first
    traced span); ``None`` when the program recorded no span."""
    mod = _spans()
    got = mod.growth("host_matrices") if mod is not None else None
    return None if got is None else got["bytes"] / 1e6 / r.trace.units
