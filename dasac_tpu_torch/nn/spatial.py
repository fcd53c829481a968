"""Height-sharded frames: one frame's rows split over the ranks of a
process group, the work GSPMD does for ``dasac_tpu``'s ``sp`` mesh axis
(no file there holds it; XLA partitions the height and inserts the halo
exchanges).

The rule: every layer's OUTPUT rows are split evenly over the group
(global height ``H``, rank ``s`` owns rows ``[s*H//n, (s+1)*H//n)``, so
strips may differ by a row), and each rank fetches the global input rows
its own output rows need, from whichever ranks own them
(``core.dist.exchange_rows``).  A needed row outside ``[0, H_in)`` takes
the op's pad value (0 for convolutions, -inf for max pools).  This is
exact for any stride, dilation and padding, also when a halo reaches past
a neighbour's whole strip (ASPP's dilation 24 at stride 8 over 16-row
strips: 8 ranks on a 1024-row frame).

The ops that change a strip's height consult :func:`current`:
``nn.layers.Conv2d``, ``nn.functional.max_pool_ceil``, ``max_pool`` and
``resize_bilinear_align_corners``.  With no active context they run as
they always did and nothing here communicates.

A strip does not carry its frame's height, so the context keeps a record
for one frame call (:meth:`Sharded.frame`): each op records its output's
``(local rows, width)`` with the global rows, and reads its input's the
same way; a model reads a strip's frame size with :func:`frame_hw`.  Two
tensors of one call with the same local rows and width but different
global heights would make the record ambiguous: that raises.

Training: the exchanges are differentiable (``core.dist.ExchangeRows``:
the backward sends each halo row's gradient back to its owner, the plan
carried by autograd, not by :func:`current`), so a row read outside the
frame gets no gradient and an owned row gets every reader's.  A remat
replay runs in the backward, where :func:`current` is unset (autograd's
thread): ``nn.layers.checkpointed`` re-enters the frame with
:meth:`Frame.replay`, which keeps the record of heights and hands each
live BN the statistics its forward reduced (:meth:`Frame.reduced`), so
the replay reduces nothing again.  :meth:`Frame.all_gather` gives every
rank the whole frame.
"""

import contextlib
import contextvars

import torch

from dasac_tpu_torch.core import dist

_ACTIVE = contextvars.ContextVar("dasac_tpu_torch_spatial", default=None)


def current():
    """The active :class:`Sharded` context, or ``None``."""
    return _ACTIVE.get()


def split(size, n, s):
    """Rows ``[lo, hi)`` that rank ``s`` of ``n`` owns of ``size`` rows."""
    return s * size // n, (s + 1) * size // n


def frame_hw(x, dim=1):
    """``(rows, cols)`` of the frame that ``x`` is a strip of (rows along
    ``dim``, columns along ``dim + 1``): ``x``'s own with no context."""
    ctx = current()
    rows = x.shape[dim] if ctx is None else ctx.rows(x, dim)
    return rows, x.shape[dim + 1]


def _fill_rows(like, dim, n, fill):
    shape = list(like.shape)
    shape[dim] = n
    t = like.new_full(shape, fill)
    if (like.dim() == 4 and not like.is_contiguous()
            and like.is_contiguous(memory_format=torch.channels_last)):
        t = t.contiguous(memory_format=torch.channels_last)
    return t


class Sharded:
    """One frame's height over ``group``: this rank's place in it.  Its
    other methods are :class:`Frame`'s, on the frame call under way
    (:meth:`frame`)."""

    def __init__(self, group):
        self.group = group
        self.n, self.s = group.size(), group.rank()
        self._frame = None

    @contextlib.contextmanager
    def frame(self):
        """Make a fresh :class:`Frame` (a new record of heights) the
        active context for one frame call; yields it."""
        f = Frame(self.group)
        self._frame = f
        token = _ACTIVE.set(f)
        try:
            yield f
        finally:
            _ACTIVE.reset(token)
            self._frame = None

    def __getattr__(self, name):
        # own/record/rows/shard/window/fetch: the frame call's; own,
        # gather and all_gather need none
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._frame or Frame(self.group), name)


class Frame:
    """One frame call over ``group``: the record of the global heights of
    its strips, and the live BN statistics it reduced (for a replay)."""

    def __init__(self, group, rows=None, stats=None, calls=None,
                 replaying=False):
        self.group = group
        self.n, self.s = group.size(), group.rank()
        self._rows = {} if rows is None else rows
        self._stats = {} if stats is None else stats
        self._calls = {} if calls is None else calls
        self.replaying = replaying

    def mark(self):
        """Where the frame's live BN calls stand (for :meth:`replay`)."""
        return dict(self._calls)

    @contextlib.contextmanager
    def replay(self, mark):
        """Re-enter this frame for a remat replay of what ran after
        ``mark``: the same record of heights, and each live BN gets the
        statistics its forward call reduced."""
        f = Frame(self.group, self._rows, self._stats, dict(mark), True)
        token = _ACTIVE.set(f)
        try:
            yield f
        finally:
            _ACTIVE.reset(token)

    def reduced(self, module, reduce):
        """``reduce()`` for ``module``'s next call in this frame, kept;
        in a replay, what the forward's same call kept is passed to
        ``reduce(known)`` instead."""
        i = self._calls.get(id(module), 0)
        self._calls[id(module)] = i + 1
        key = (id(module), i)
        if self.replaying:
            return reduce(self._stats[key])
        y = reduce(None)
        self._stats[key] = y.detach()
        return y

    def own(self, size):
        """This rank's rows ``[lo, hi)`` of ``size``."""
        return split(size, self.n, self.s)

    def record(self, x, dim, size):
        """Note that ``x`` is this rank's strip of a ``size``-row tensor
        (rows along ``dim``); returns ``x``."""
        key = (x.shape[dim], x.shape[dim + 1])
        if self._rows.setdefault(key, size) != size:
            raise RuntimeError(
                "strips of %d and %d rows both give %s on rank %d: the "
                "record of heights is ambiguous" % (self._rows[key], size,
                                                    key, self.s))
        return x

    def rows(self, x, dim):
        """Global rows of the tensor ``x`` is this rank's strip of."""
        key = (x.shape[dim], x.shape[dim + 1])
        try:
            return self._rows[key]
        except KeyError:
            raise RuntimeError(
                "a strip of %s (rows, cols) that no sharded op made: every "
                "op that changes a strip's height goes through nn.spatial"
                % (key,)) from None

    def shard(self, x, dim):
        """This rank's rows of the whole-frame tensor ``x``, which every
        rank of the group holds."""
        size = x.shape[dim]
        lo, hi = self.own(size)
        return self.record(x.narrow(dim, lo, hi - lo), dim, size)

    def window(self, x, dim, size_in, size_out, span, stride, before, fill,
               kind):
        """The input rows this rank's output rows of a sliding-window op
        read (output row ``r`` reads input rows ``r*stride - before`` to
        ``r*stride - before + span - 1``), out-of-range rows ``fill``."""
        def need(t):
            lo, hi = split(size_out, self.n, t)
            if lo >= hi:
                return 0, 0
            return lo * stride - before, (hi - 1) * stride - before + span

        return self.fetch(x, dim, size_in, [need(t) for t in range(self.n)],
                          fill, kind)

    def fetch(self, x, dim, size_in, need, fill, kind):
        """Rows ``need[s]`` (global, may reach outside ``[0, size_in)``,
        where they are ``fill``) of the ``size_in``-row tensor whose strip
        ``x`` is, for each rank ``s``; every rank of the group calls it
        with the same ``need``.  Returns this rank's.  Differentiable in
        ``x`` when autograd records."""
        have = [split(size_in, self.n, t) for t in range(self.n)]
        if [tuple(r) for r in need] == have:   # each rank reads its own rows
            return x
        inside = [(max(lo, 0), min(hi, size_in)) for lo, hi in need]
        if torch.is_grad_enabled() and x.requires_grad:
            core = dist.ExchangeRows.apply(x, dim, have, inside, self.group,
                                           kind)
        else:
            core = dist.exchange_rows(x, dim, have, inside, self.group, kind)
        lo, hi = need[self.s]
        if lo >= hi:
            return core
        top = max(0, min(hi, 0) - lo)
        bottom = max(0, hi - max(lo, size_in))
        if not (top or bottom):
            return core
        parts = ([_fill_rows(core, dim, top, fill)] if top else []) + [core]
        if bottom:
            parts.append(_fill_rows(core, dim, bottom, fill))
        return torch.cat(parts, dim)

    def gather(self, x, dim, size, root=0):
        """The whole ``size``-row tensor on group rank ``root`` from every
        rank's strip ``x``; ``None`` on the other ranks."""
        need = [(0, size) if t == root else (0, 0) for t in range(self.n)]
        out = self.fetch(x, dim, size, need, 0, "gather")
        return out if self.s == root else None

    def all_gather(self, x, dim, size):
        """The whole ``size``-row tensor on every rank of the group from
        every rank's strip ``x``."""
        return self.fetch(x, dim, size, [(0, size)] * self.n, 0, "gather")
