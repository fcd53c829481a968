"""The cell's files by name, the run's context and its result line.

``BENCHMARK.json`` names each cell's configuration and traffic; the
harness finds ``configs/<file>``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, the traffic's loop ``loops/<loop>.py`` and
each per-layer metric's reader ``metrics/<metric>.py``.  A new cell,
configuration, traffic or metric is new files and entries."""

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
BANNED = ("jax", "jaxlib", "flax", "dasac_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def applies(metric, cell, bench):
    """Whether ``metric`` is reported in ``cell``: its ``workloads``, or,
    without the key, every cell that reports the end-to-end metric it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"]
                     if m["name"] == metric["moves"])
        return applies(moved, cell, bench)
    return True


def cell(name, bench=None):
    """The cell ``name`` of the manifest, its files read."""
    bench = bench or manifest()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(ROOT, conf["file"]),
        traffic=load_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=load_json(HERE, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if applies(m, name, bench)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name, bench)])


def loop(cell):
    """The traffic's loop, ``loops/<loop>.py``."""
    return importlib.import_module("benchmark.loops." + cell.traffic["loop"])


def reader(metric_name):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cfg_keys(cell):
    """The configuration keys both sides are handed, in the YAML schema's
    dotted names: the configuration's, its stage's, then the traffic's."""
    keys = dict(cell.config["cfg"])
    keys.update(cell.config["stages"][cell.traffic["stage"]])
    keys.update(cell.traffic.get("cfg", {}))
    return keys


@dataclasses.dataclass
class Record:
    """What a loop returns from a run."""
    setup_s: float
    end_to_end: dict            # name -> value, the cell's own metrics
    attempted: int
    failed: int
    peak_bytes: int
    checks: dict                # name -> (value, limit)
    readings: object = None     # for the per-layer readers (trace runs)


def banned_modules():
    """Top-level names of loaded modules that the run must not hold."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


def correct(rec):
    return rec.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in rec.checks.values())


def result_line(cell, rec, trace, device):
    """The run's last line of standard output, as a dict."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = reader(m["name"])(rec.readings)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: rec.end_to_end[m["name"]]
                  for m in cell.end_to_end}
    line = {"correct": correct(rec), "attempted": rec.attempted,
            "failed": rec.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": dict(device, memory_peak_bytes=rec.peak_bytes)}
    if trace:
        t = rec.readings.trace
        line["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = t.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in rec.checks.items()}
    return line


def check_lines(rec):
    return ["check %s: %.6g (limit %.6g)" % (k, v, lim)
            for k, (v, lim) in rec.checks.items()]


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the trace after the window, the
    window's rate of units (steps or frames), and the plain count of a
    unit's FLOPs and of its convolutions' least time on this card."""
    trace: object
    units_per_s: float
    flops_per_unit: float
    conv_min_s_per_unit: float
    peak_flops: float
