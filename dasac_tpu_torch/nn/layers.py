"""Core layers: a convolution with explicit compute dtype and BatchNorm with
optional cross-replica statistics (counterpart of
``dasac_tpu/nn/layers.py``).

Modules take NCHW-shaped tensors; the models permute their NHWC input to an
NCHW-shaped view in ``channels_last`` memory, which the convolutions run on
directly.  Parameters and BN statistics are f32; each layer casts its input
and weights to its compute ``dtype`` (the flax convention, without
autocast).

BN modes:
  * frozen (SAC student/teacher): normalize with the running statistics;
  * batch stats (ABN baseline): normalize with the batch statistics and
    update the running ones with torch's conventions; with a process
    group, the statistics are those of the global batch (one collective a
    layer in the forward and one in the backward).  The passes over the
    activation (the sums, the apply with its residual and ReLU, their
    backwards) are ``ops/live_bn.py``'s kernels on the card.

Remat (:func:`checkpointed`, ``TPU.REMAT``): a model runs a block or a
chunk of layers under ``torch.utils.checkpoint``, which replays its forward
in the backward.  The replay recomputes batch statistics (and, with a
group, their all-reduce; under a height-sharded frame it takes the
forward's reduced sums instead) but leaves the running ones alone, so a
live BN updates its buffers once a forward, as flax's ``nn.remat`` applies
the ``batch_stats`` mutation once.
"""

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.nn import spatial
from dasac_tpu_torch.ops import live_bn


class Conv2d(nn.Module):
    """2-D convolution; weight OIHW f32, computed in ``dtype``.

    ``padding`` is an int (symmetric) or ``"same"`` (flax/XLA SAME: the odd
    pixel of padding goes after).  ``groups`` splits the channels as
    ``F.conv2d``'s does (``in_ch`` of them: depthwise).  Under a
    height-sharded frame (``nn/spatial.py``) it computes this rank's output
    rows.
    """

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 dilation=1, bias=False, dtype=torch.float32, init_std=None,
                 groups=1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.kernel, self.groups = kernel, groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        # normal(0, 0.01) is the reference init for from-scratch convs;
        # otherwise lecun-normal (flax's default kernel init)
        self.init_std = init_std
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        std = self.init_std if self.init_std is not None \
            else math.sqrt(1.0 / fan_in)
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _pads(self, size):
        """``(before, after)`` padding of a side of ``size`` pixels."""
        if self.padding != "same":
            return self.padding, self.padding
        out = -(-size // self.stride)
        total = max((out - 1) * self.stride
                    + (self.kernel - 1) * self.dilation + 1 - size, 0)
        return total // 2, total - total // 2

    def forward(self, x):
        ctx = spatial.current()
        if ctx is not None:
            return self._forward_strip(x, ctx)
        pad = self.padding
        if pad == "same":
            pads = [*self._pads(x.shape[-1]), *self._pads(x.shape[-2])]
            x = F.pad(x, pads) if any(pads) else x  # F.pad order: W then H
            pad = 0
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, pad,
                        self.dilation, self.groups)

    def _forward_strip(self, x, ctx):
        """This rank's output rows of a height-sharded frame
        (``nn/spatial.py``): the H padding comes from the frame's height,
        the rows from ``ctx.window``; W is padded as above."""
        h, w_in = ctx.rows(x, 2), x.shape[-1]
        span = (self.kernel - 1) * self.dilation + 1
        top, bottom = self._pads(h)
        left, right = self._pads(w_in)
        h_out = (h + top + bottom - span) // self.stride + 1
        x = ctx.window(x, 2, h, h_out, span, self.stride, top, 0.0, "conv")
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if x.shape[2] == 0:   # this rank owns no output row
            w_out = (w_in + left + right - span) // self.stride + 1
            y = empty_rows(x, (x.shape[0], w.shape[0], 0, w_out),
                           self.dtype)
        elif left == right:
            y = F.conv2d(x.to(self.dtype), w, b, self.stride, (0, left),
                         self.dilation, self.groups)
        else:
            y = F.conv2d(F.pad(x.to(self.dtype), (left, right)), w, b,
                         self.stride, 0, self.dilation, self.groups)
        return ctx.record(y, 2, h_out)


class Linear(nn.Module):
    """``y = x w^T + b`` over the last axis of ``x`` (tokens, NHWC); weight
    ``[out, in]`` and bias f32 under ``nn.Linear``'s keys, computed in
    ``dtype``; the weight starts normal(0, 0.02) (the transformer init),
    the bias at 0."""

    INIT_STD = 0.02

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.INIT_STD, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis of ``x`` under ``nn.LayerNorm``'s keys:
    f32 weight (1) and bias (0) cast to ``dtype`` with the input."""

    def __init__(self, features, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x.to(self.dtype), (x.shape[-1],),
                            self.weight.to(self.dtype),
                            self.bias.to(self.dtype), self.eps)


def empty_rows(x, shape, dtype):
    """An empty output of ``shape`` that depends on ``x`` (a rank that
    owns no output row still takes part in its input's backward
    exchange)."""
    return (x.sum() * 0).to(dtype).expand(shape)


class SyncBatchNorm(nn.Module):
    """BatchNorm2d with optional cross-replica statistics.

    Statistics and affine parameters are float32 regardless of compute
    dtype.  Running-stat update matches torch: ``running <- (1-m)*running +
    m*batch`` with momentum m=0.1 and the unbiased variance.  The state-dict
    keys are torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``).

    With a process ``group`` the live statistics are averaged over its
    ranks as ``dasac_tpu``'s ``lax.pmean`` over the mesh axis does: one
    all-reduce of ``[mean, mean_sq]`` (2C floats), and the pixel count of
    the unbiased variance times the world size.  Under a height-sharded
    frame (``nn/spatial.py``; ``group`` then spans every rank of the
    world, whose strips may differ by a row) they are sums and a count
    over the group, ``[sum, sum_sq, count]`` in one all-reduce, which a
    remat replay takes from its forward instead of reducing again.
    Frozen BN never communicates.
    """

    def __init__(self, features, momentum=0.1, eps=1e-5,
                 dtype=torch.float32, group=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.group = group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def _update_running(self, mean, var, count):
        if torch.is_tensor(count):
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
        else:
            unbiased = var * (count / max(count - 1.0, 1.0))
        self.running_mean.mul_(1.0 - self.momentum).add_(
            mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(
            unbiased, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def forward(self, x, use_running_average, residual=None, relu=False):
        """``relu?(bn(x) [+ residual])``.  Frozen, the bf16 multiply-add,
        then ``torch.relu``, each its own op, and no residual (a frozen
        bottleneck adds its own after its projection, as it always has);
        live, the passes over the activation are ``ops/live_bn``'s kernels
        (their plain versions on the CPU) and the per-channel chain between
        them stays in autograd."""
        if use_running_average:
            if residual is not None:
                raise ValueError("frozen BN takes no residual")
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            shift = self.bias - self.running_mean * inv
            y = (x.to(self.dtype) * inv.to(self.dtype)[:, None, None]
                 + shift.to(self.dtype)[:, None, None])
            return torch.relu(y) if relu else y

        frame = spatial.current()
        if frame is not None and self.group is None:
            raise RuntimeError(
                "batch statistics over a height-sharded frame need the BN "
                "layers built with the world's group")
        x = live_bn.channels_last(x)
        c = x.shape[1]
        sums = live_bn.bn_sums(x)
        if frame is not None:
            local = torch.cat([sums, sums.new_full((1,), x.numel() // c)])
            stats = frame.reduced(self, lambda known: dist.AllReduceSum.apply(
                local, self.group, known))
            count = stats[-1:]   # a tensor: no wait for the device
            mean, mean_sq = (stats[:-1] / count).split(c)
        else:
            count = x.numel() // c
            mean, mean_sq = (sums / count).split(c)
            if self.group is not None:
                world = self.group.size()
                stats = dist.AllReduceSum.apply(
                    torch.cat([mean, mean_sq]), self.group) / world
                mean, mean_sq = stats.split(c)
                count *= world
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if not _RECOMPUTING.get():
            self._update_running(mean, var, count)
        # the f32 per-channel coefficients, used unrounded by the apply
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        if residual is not None:
            residual = live_bn.channels_last(residual.to(self.dtype))
        return live_bn.bn_apply(x.to(self.dtype), inv, shift, residual, relu)


# (n, d): a forward sees slice d of n equal slices of its global batch
# (the gspmd steps), so a draw per sample covers the global batch
_BATCH_SLICE = contextvars.ContextVar("dasac_tpu_torch_batch_slice",
                                      default=None)


@contextlib.contextmanager
def batch_slice(n, d):
    """Forwards inside see slice ``d`` of ``n`` of the global batch: the
    dropout masks are drawn for the global batch, and slice ``d`` taken
    (the draws of the one-process global step)."""
    token = _BATCH_SLICE.set((n, d))
    try:
        yield
    finally:
        _BATCH_SLICE.reset(token)


def sample_keep(generator, shape, rate, device):
    """A keep mask of ``shape`` (its first axis the batch's): each bool
    kept with probability ``1 - rate``, drawn from ``generator`` (on
    ``device``; ``None`` draws from torch's default generator); under
    :func:`batch_slice`, the global batch's rows of this slice."""
    part = _BATCH_SLICE.get()
    if part is None:
        return torch.rand(shape, generator=generator, device=device) >= rate
    n, d = part
    b = shape[0]
    u = torch.rand((b * n, *shape[1:]), generator=generator, device=device)
    return u[d * b:(d + 1) * b] >= rate


def sample_channel_dropout_draws(generator, x, rate):
    """The keep mask of channel dropout for the NCHW-shaped ``x``: one
    bool per (sample, channel) (:func:`sample_keep`)."""
    return sample_keep(generator, tuple(x.shape[:2]), rate, x.device)


def apply_channel_dropout(x, keep, rate):
    """Channel dropout with a given ``keep`` mask ``[N, C]``: each kept
    channel scaled by ``1 / (1 - rate)``, the others zeroed, the same over
    H and W (flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NHWC)."""
    return x * (keep.to(x.dtype) / (1.0 - rate))[:, :, None, None]


# True while a checkpoint replays its forward in the backward (set in the
# thread that replays it: autograd's, for CUDA tensors)
_RECOMPUTING = contextvars.ContextVar("dasac_tpu_torch_recompute",
                                      default=False)


@contextlib.contextmanager
def _replaying(inner):
    token = _RECOMPUTING.set(True)
    try:
        with inner:
            yield
    finally:
        _RECOMPUTING.reset(token)


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The ``convs`` policy: keep every convolution's output, recompute
    the rest (``dasac_tpu``'s ``save_only_these_names("conv_out")``)."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(mode):
    if mode == "convs":
        forward, replay = create_selective_checkpoint_contexts(
            _save_conv_outputs)
        return forward, _replaying(replay)
    return contextlib.nullcontext(), _replaying(contextlib.nullcontext())


def checkpointed(fn, mode, *args):
    """``fn(*args)`` under remat ``mode`` (``nn.resnet.remat_mode``):
    "block" keeps only the inputs and replays the whole forward in the
    backward; "convs" also keeps every convolution's output, so the replay
    recomputes only the elementwise chain between them.  ``fn`` runs
    directly for "none", and when no gradient is recorded (a no-grad
    forward has nothing to replay).  Nothing inside ``fn`` may draw random
    numbers: the replay does not restore a ``torch.Generator``, so the RNG
    state is not saved at all.  Under a height-sharded frame the replay
    re-enters it (``nn.spatial.Frame.replay``): the same record of
    heights, its halo exchanges again, its live BN statistics from the
    forward."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    frame = spatial.current()
    if frame is not None:
        fn = functools.partial(_in_frame, frame, frame.mark(), fn)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, mode))


def _in_frame(frame, mark, fn, *args):
    if not _RECOMPUTING.get():
        return fn(*args)
    with frame.replay(mark):
        return fn(*args)
