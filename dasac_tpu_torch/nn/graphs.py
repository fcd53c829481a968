"""CUDA graphs of a model's residual branches, for a forward whose host
cannot keep pace with the card.

A branch is ``fn(x, keep) -> x'`` over tensors: ``x`` the residual stream,
``keep`` an optional tensor input (a drop-path mask), ``weights`` the
``(module, name)`` of each tensor ``fn`` reads besides (read anew at each
call, so that ``torch.func.functional_call`` swaps them).  Nothing inside
``fn`` may draw random numbers or synchronize with the host.

A model groups its calls into passes (:class:`Passes`): the calls of one
model forward with one input shape, dtype, grad mode and set of weights.
Each pass has its own memory pool and side stream.  At a branch's first
call in a pass, the branch is run twice on the side stream (cuDNN's
autotune, library handles), then its forward is captured and, with
gradients, its backward (``torch.autograd.grad`` of the captured forward,
its graph retained): the pass's graphs are captured in the order the pass
calls them, forward and backward of each branch together.  The capture
reads each weight through a leaf of its own on the same memory, so the
weights' gradient accumulators, which keep the stream they were made on,
are made by the eager passes on the caller's stream.  Every later
call copies its inputs into the captured ones and replays; a backward
copies the incoming gradient and replays.  Replayed in the pass's order
(every forward, then the backwards in reverse), no graph's scratch memory
ever overlaps what a graph of the pass keeps for its backward: what a
forward keeps stays allocated for the pass's lifetime, and a scratch
block a later capture reuses is written only after its backward has run.

A call runs eagerly (``fn`` itself) when the pass is full, when its
shape, dtype, weights or grad mode differ from the captured ones, when
the branch's last forward still waits for its backward (a second forward
would overwrite what the first keeps), or when gradients are recorded
but ``x`` does not require one or a weight is not a parameter that
does.  The graphs give the results
of ``fn``'s kernels; only the host's work changes.

``counters`` are dicts of numbers that ``fn`` adds to (a call counter):
the warm-up and capture leave them as they were, and each replay adds
what one call of ``fn`` added.
"""

import torch
from torch.autograd.function import once_differentiable

WARMUP = 2


def _ptrs(params):
    return tuple(p.data_ptr() for p in params)


class Passes:
    """A model's graphed passes by key, at most ``limit`` of them; a call
    of a pass beyond them runs eagerly (``get`` returns ``None``).  A deep
    copy starts with none: the graphs read the original's memory."""

    def __init__(self, limit):
        self.limit, self.passes = limit, {}

    def __deepcopy__(self, memo):
        return Passes(self.limit)

    def get(self, key, device):
        p = self.passes.get(key)
        if p is None and len(self.passes) < self.limit:
            p = self.passes[key] = Pass(device)
        return p


class Pass:
    """The branches of one pass, their pool and side stream."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.branches = {}

    def __call__(self, name, fn, x, keep, weights, counters=()):
        """``fn(x, keep)``, replayed from the graphs of branch ``name``
        (captured at its first call) where they fit, else eagerly."""
        params = [getattr(m, k) for m, k in weights]
        grad = torch.is_grad_enabled()
        if grad and not (x.requires_grad and all(
                isinstance(p, torch.nn.Parameter) and p.requires_grad
                for p in params)):
            return fn(x, keep)
        b = self.branches.get(name)
        if b is None:
            b = self.branches[name] = Branch(fn, x, keep, weights, grad,
                                             self.pool, self.stream,
                                             counters)
        if not b.fits(x, keep, params, grad):
            return fn(x, keep)
        if grad:
            return _Replay.apply(b, x, keep, *params)
        return b.forward(x, keep)


class Branch:
    """One branch's captured forward and, with ``grad``, backward."""

    def __init__(self, fn, x, keep, weights, grad, pool, stream, counters):
        self.grad, self.pending, self.counters = grad, False, counters
        params = [getattr(m, k) for m, k in weights]
        self.ptrs = _ptrs(params)
        self.x = x.detach().clone().requires_grad_(grad)
        self.keep = None if keep is None else keep.clone()
        self.gy = torch.empty_like(self.x) if grad else None
        leaves = ([torch.nn.Parameter(p.detach()) for p in params] if grad
                  else params)
        before = [dict(c) for c in counters]
        stream.wait_stream(torch.cuda.current_stream())
        try:
            if grad:
                for (m, k), p in zip(weights, leaves):
                    setattr(m, k, p)
            with torch.cuda.stream(stream):
                self._capture(fn, leaves, pool, before)
        finally:
            if grad:
                for (m, k), p in zip(weights, params):
                    setattr(m, k, p)
        torch.cuda.current_stream().wait_stream(stream)

    def _capture(self, fn, leaves, pool, before):
        for _ in range(WARMUP):
            y = fn(self.x, self.keep)
            if self.grad:
                torch.autograd.grad(y, (self.x, *leaves), torch.ones_like(y))
        del y
        self._restore(before)
        self.fwd = torch.cuda.CUDAGraph()
        self.fwd.capture_begin(pool=pool)
        self.y = fn(self.x, self.keep)
        self.fwd.capture_end()
        self.adds = [{k: c[k] - b[k] for k in b}
                     for c, b in zip(self.counters, before)]
        self._restore(before)
        if self.grad:
            self.bwd = torch.cuda.CUDAGraph()
            self.bwd.capture_begin(pool=pool)
            self.gx, *self.gp = torch.autograd.grad(
                self.y, (self.x, *leaves), self.gy, retain_graph=True)
            self.bwd.capture_end()

    def _restore(self, before):
        for c, b in zip(self.counters, before):
            c.update(b)

    def fits(self, x, keep, params, grad):
        return (grad == self.grad and not self.pending
                and x.shape == self.x.shape and x.dtype == self.x.dtype
                and (keep is None) == (self.keep is None)
                and _ptrs(params) == self.ptrs)

    def forward(self, x, keep):
        if x.data_ptr() != self.x.data_ptr():
            self.x.detach().copy_(x)
        if keep is not None:
            self.keep.copy_(keep)
        self.fwd.replay()
        for c, add in zip(self.counters, self.adds):
            for k, v in add.items():
                c[k] += v
        self.pending = self.grad
        return self.y.detach()

    def backward(self, gy):
        if gy.data_ptr() != self.gy.data_ptr():
            self.gy.copy_(gy)
        self.bwd.replay()
        self.pending = False
        # the weights' gradients as fresh tensors: a ``.grad`` may keep
        # them, and the next replay rewrites the captured ones
        return self.gx.detach(), torch._foreach_mul(self.gp, 1.0)


class _Replay(torch.autograd.Function):
    """A branch's replay as one autograd node over ``x`` and the
    weights."""

    @staticmethod
    def forward(ctx, branch, x, keep, *params):
        ctx.branch = branch
        return branch.forward(x, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        gx, gp = ctx.branch.backward(gy)
        return (None, gx, None, *gp)
