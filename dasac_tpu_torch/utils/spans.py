"""Named spans of the port's hot paths, on the profiler's clock.

``with span("refine"): ...`` marks one phase of a step or an inference
call.  A span records only while a ``torch.profiler`` is recording or
:func:`recording` is open (tools and tests); otherwise ``span`` returns one
shared null context after a single flag check.  Nothing else turns spans
on.

A recorded span
  * enters a host-only record function (``_RecordFunctionFast``: a host
    operator event, not a user annotation, so the profiler copies nothing
    of it onto the device's timeline); in a trace it encloses the host
    operators and kernel launches of its phase, on the kernels' clock;
  * keeps its **host ms**, ``perf_counter_ns`` from entry to exit: the time
    the host took to enqueue the phase;
  * keeps its **stream ms**: when its work runs on a CUDA device (the
    ``device`` it is given, else its enclosing span's), the time between
    two timing events recorded on the current stream at entry and exit,
    from the point the stream reaches the span to the end of the span's
    last work, idle time within the span included; otherwise the host ms.

Spans are kept as aggregates by name (count, host ns, stream ms, the event
pairs not yet resolved, the names of the spans each ran directly inside),
so memory stays bounded over a long profiled run.  :func:`totals` waits
for the device once and resolves them; :func:`reset` clears them.  Spans
are opened and closed on one thread.

:func:`probe` registers a counter to read at the first span recorded
since the reset; :func:`growth` gives how far it has moved since.
"""

import contextlib
import time
from typing import FrozenSet, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
# event pairs a name keeps before those the device has reached are resolved
PENDING = 64

_forced = 0          # open recording() contexts
_stack = []          # the open spans, innermost last
_aggs = {}           # name -> _Agg
_free = []           # CUDA events to reuse
_probes = {}         # name -> fn() giving {key: number}
_first = {}          # name -> its probe's value at the first span


class Total(NamedTuple):
    """One name's spans since the last reset."""
    count: int
    host_ms: float
    stream_ms: float
    parents: FrozenSet[Optional[str]]   # None: outermost


class _Agg:
    __slots__ = ("count", "host_ns", "stream_ms", "pending", "parents")

    def __init__(self):
        self.count, self.host_ns, self.stream_ms = 0, 0, 0.0
        self.pending, self.parents = [], set()


def span(name, device=None):
    """The context of the phase ``name`` whose work runs on ``device``
    (default: its enclosing span's; see the module's docstring)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, device)


@contextlib.contextmanager
def recording():
    """Spans record inside, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def probe(name, fn):
    """Read ``fn()`` (``{key: number}``) at the first span recorded since
    the last reset, for :func:`growth`."""
    _probes[name] = fn


def growth(name):
    """``{key: fn() now - fn() at the first span}`` of the probe ``name``;
    ``None`` when no span was recorded since the last reset."""
    first = _first.get(name)
    if first is None:
        return None
    return {k: v - first[k] for k, v in _probes[name]().items()}


def _event():
    ev = _free.pop() if _free else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _resolve(agg, wait):
    """Fold ``agg``'s event pairs into its stream ms: all of them after a
    synchronize (``wait``), else those the device has reached."""
    n = 0
    for start, end in agg.pending:
        if not (wait or end.query()):
            break
        agg.stream_ms += start.elapsed_time(end)
        _free.extend((start, end))
        n += 1
    del agg.pending[:n]


class _Span:
    __slots__ = ("name", "cuda", "agg", "rf", "t0", "ev0")

    def __init__(self, name, device):
        self.name = name
        if device is not None:
            self.cuda = torch.device(device).type == "cuda"
        else:
            self.cuda = bool(_stack) and _stack[-1].cuda

    def __enter__(self):
        if len(_first) < len(_probes):
            for k, fn in _probes.items():
                if k not in _first:
                    _first[k] = fn()
        agg = _aggs.get(self.name)
        if agg is None:
            agg = _aggs[self.name] = _Agg()
        agg.parents.add(_stack[-1].name if _stack else None)
        _stack.append(self)
        self.agg = agg
        self.ev0 = _event() if self.cuda else None
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack.pop()
        agg = self.agg
        agg.count += 1
        agg.host_ns += t1 - self.t0
        if self.ev0 is None:
            agg.stream_ms += (t1 - self.t0) / 1e6
        else:
            agg.pending.append((self.ev0, _event()))
            if len(agg.pending) > PENDING:
                _resolve(agg, wait=False)


def totals():
    """``{name: Total}`` of every span since the last :func:`reset`, host
    and stream ms summed over its calls; synchronizes once when an event
    pair is pending.  Does not reset."""
    if any(a.pending for a in _aggs.values()):
        torch.cuda.synchronize()
    for a in _aggs.values():
        _resolve(a, wait=True)
    return {k: Total(a.count, a.host_ns / 1e6, a.stream_ms,
                     frozenset(a.parents)) for k, a in _aggs.items()}


def reset():
    """Forget every span recorded so far (open spans still close)."""
    totals()
    _aggs.clear()
    _first.clear()
