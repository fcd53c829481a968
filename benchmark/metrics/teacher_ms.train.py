"""Stream ms a SAC step of the teacher: the program's ``ema``, ``teacher``
and ``refine`` spans (the EMA, the teacher forward, refine, running
confidence and pseudo-labels) over the traced steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["ema", "teacher", "refine"])
