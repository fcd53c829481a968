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
    layer in the forward and one in the backward).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from dasac_tpu_torch.core import dist


class Conv2d(nn.Module):
    """2-D convolution; weight OIHW f32, computed in ``dtype``.

    ``padding`` is an int (symmetric) or ``"same"`` (flax/XLA SAME: the odd
    pixel of padding goes after).
    """

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 dilation=1, bias=False, dtype=torch.float32, init_std=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.kernel = kernel
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
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

    def forward(self, x):
        pad = self.padding
        if pad == "same":
            pads = []
            for size in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
                out = -(-size // self.stride)
                total = max((out - 1) * self.stride
                            + (self.kernel - 1) * self.dilation + 1 - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads) if any(pads) else x
            pad = 0
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, pad,
                        self.dilation)


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
    the unbiased variance times the world size.  Frozen BN never
    communicates.
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

    def forward(self, x, use_running_average):
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            dims = (0, 2, 3)
            mean = xf.mean(dim=dims)
            mean_sq = (xf * xf).mean(dim=dims)
            count = x.numel() // x.shape[1]
            if self.group is not None:
                world = self.group.size()
                stats = dist.AllReduceSum.apply(
                    torch.cat([mean, mean_sq]), self.group) / world
                mean, mean_sq = stats.split(mean.shape[0])
                count *= world
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * (count / max(count - 1.0, 1.0))
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    unbiased, alpha=self.momentum)
                self.num_batches_tracked.add_(1)

        # fold (mean, var, scale, bias) into one per-channel multiply-add
        # applied in the compute dtype: the f32 coefficients are exact, the
        # per-pixel arithmetic stays in the activations' dtype
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return (x.to(self.dtype) * inv.to(self.dtype)[:, None, None]
                + shift.to(self.dtype)[:, None, None])


def sample_channel_dropout_draws(generator, x, rate):
    """The keep mask of channel dropout for the NCHW-shaped ``x``: one
    bool per (sample, channel), kept with probability ``1 - rate``, drawn
    from ``generator`` (on ``x``'s device; ``None`` draws from torch's
    default generator)."""
    return torch.rand(x.shape[:2], generator=generator,
                      device=x.device) >= rate


def apply_channel_dropout(x, keep, rate):
    """Channel dropout with a given ``keep`` mask ``[N, C]``: each kept
    channel scaled by ``1 / (1 - rate)``, the others zeroed, the same over
    H and W (flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NHWC)."""
    return x * (keep.to(x.dtype) / (1.0 - rate))[:, :, None, None]
