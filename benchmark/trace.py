"""The device trace of a few units of work after the measured window:
``torch.profiler`` over the calls, reduced to the device's busy time
(the union of kernel, copy and memset intervals), its time by kernel and
by group (``kernel_groups``: by the host operator that launched it, else
by its name), and the idle gaps, each named by the innermost host
operation running at its middle."""

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.kernel_groups import group_of

TOP = 10


class Trace:
    """``busy_s``, ``window_s``, ``units``; ``by_group`` and ``by_kernel``:
    device seconds; ``gaps``: [(host op, seconds)], longest first.
    ``device_events``: (name, start, end[, launching host operator])."""

    def __init__(self, window_s, units, device_events, host_events):
        self.window_s, self.units = window_s, units
        spans = sorted((ev[1], ev[2]) for ev in device_events)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.by_kernel, self.by_group = {}, {}
        for name, s, e, *op in device_events:
            t = (e - s) / 1e6
            self.by_kernel[name] = self.by_kernel.get(name, 0.0) + t
            g = group_of(name, *op)
            self.by_group[g] = self.by_group.get(g, 0.0) + t
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])), reverse=True)
        self.gaps = [(_host_at(host_events, (s + e) / 2), g / 1e6)
                     for g, s, e in gaps[:TOP]]

    def breakdown(self):
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in self.gaps]}


def _host_at(host_events, t):
    inner = None
    for name, s, e in host_events:
        if s <= t <= e and (inner is None or e - s < inner[1]):
            inner = (name, e - s)
    return "host: " + (inner[0] if inner else "python between ops")


def record(fn, units):
    """Profile ``fn()`` (one unit of work, ending on the host once the
    device is done) ``units`` times; returns a :class:`Trace`."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return Trace(window_s, units, *split_events(prof.events()))


def split_events(events):
    """(device events with the host operator that launched each, host
    events).  The profiler lists under each host operator the kernels it
    launched (the innermost operator on the stack at the launch), each
    by name and duration; a device event takes the operator of an equal
    pair."""
    launched = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            for k in e.kernels:
                launched.setdefault((k.name, k.duration), []).append(e.name)
    device, host = [], []
    for e in events:
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            ops = launched.get((e.name, e.time_range.end - e.time_range.start))
            device.append(span + (ops.pop() if ops else None,))
        else:
            host.append(span)
    if not device:
        raise RuntimeError("the profiler saw no device time")
    return device, host
