"""Layers of the plain reference models: a convolution whose operands can
be rounded to fp8, BatchNorm (frozen or on batch statistics), the pools,
the align-corners bilinear resize as two interpolation-matrix products,
the antialiased half-pixel resize and FCN's channel dropout.

Layout: the models take NHWC input and run on an NCHW view of it; the
per-channel BN arithmetic is folded into one multiply-add whose
coefficients are float32 and whose per-pixel part is in the compute
dtype."""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Precision:
    """``dtype``: activations and convolutions; ``fp8``: round each
    convolution's input and weight to float8 e4m3 (per-tensor scale) in
    the forward, the gradient passing straight through; ``refine``: the
    no-grad refine and pseudo-label chain (None: float32)."""
    dtype: torch.dtype = torch.float32
    fp8: bool = False
    refine: torch.dtype = None


REFERENCE = Precision()
CONTROL = Precision(torch.bfloat16, True, torch.bfloat16)
E4M3_MAX = 448.0


def round_fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in ``t``'s dtype; the gradient passes
    through unchanged."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(t.dtype)
    return t + (q - t.detach())


class Conv2d(nn.Module):
    """OIHW f32 weight; ``y = conv(x, w) + b`` in the model's precision."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 bias=False, init_std=None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.k = (
            stride, padding, dilation, k)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        # normal(0, 0.01) for the reference's from-scratch convs, else
        # lecun normal
        self.init_std = (init_std if init_std is not None
                         else math.sqrt(1.0 / (cin * k * k)))

    def forward(self, x, prec):
        w = self.weight.to(prec.dtype)
        x = x.to(prec.dtype)
        if prec.fp8:
            x, w = round_fp8(x), round_fp8(w)
        b = None if self.bias is None else self.bias.to(prec.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation)


class BatchNorm(nn.Module):
    """BatchNorm2d: frozen (running statistics) or on the batch's
    statistics, updating the running ones with momentum 0.1 and the
    unbiased variance."""

    def __init__(self, c, eps=1e-5, momentum=0.1, init_weight=1.0):
        super().__init__()
        self.eps, self.momentum, self.init_weight = eps, momentum, init_weight
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, prec, live):
        if live:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var * (n / max(n - 1.0, 1.0)), alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return (x.to(prec.dtype) * inv.to(prec.dtype)[:, None, None]
                + shift.to(prec.dtype)[:, None, None])


def init_spec(model):
    """How each state-dict entry of ``model`` starts: ``("normal", std)``
    for convolution weights, ``("const", w)`` for BN weights, ``("ones",)``
    for running variances, ``("zeros",)`` for the rest."""
    spec = {}
    for name, m in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, Conv2d):
            spec[pre + "weight"] = ("normal", m.init_std)
            if m.bias is not None:
                spec[pre + "bias"] = ("zeros",)
        elif isinstance(m, BatchNorm):
            spec.update({pre + "weight": ("const", m.init_weight),
                         pre + "bias": ("zeros",),
                         pre + "running_mean": ("zeros",),
                         pre + "running_var": ("ones",),
                         pre + "num_batches_tracked": ("zeros",)})
    return spec


def max_pool_ceil(x, window=3, stride=2, padding=1):
    """torch's ceil-mode max pool, padded with -inf to the extent every
    window needs."""
    h, w = x.shape[-2:]

    def out(s):
        return int(np.ceil((s + 2 * padding - window) / stride)) + 1

    oh, ow = out(h), out(w)
    xp = F.pad(x, (padding, (ow - 1) * stride + window - w - padding,
                   padding, (oh - 1) * stride + window - h - padding),
               value=float("-inf"))
    return F.max_pool2d(xp, window, stride)


def _interp_matrix(n_in, n_out):
    """[n_out, n_in] align-corners linear interpolation (two taps a row)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    w = (src - i0).astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i0 + 1), w)
    return m


def resize_align_corners(x, size, dtype=torch.float32):
    """Bilinear align-corners resize of NHWC ``x`` to ``size``, as the
    products with the two interpolation matrices, in ``dtype``; returns
    ``x``'s dtype."""
    b, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    if (h, w) == (oh, ow):
        return x
    mh = torch.from_numpy(_interp_matrix(h, oh)).to(x.device, dtype)
    mw = torch.from_numpy(_interp_matrix(w, ow)).to(x.device, dtype)
    y = torch.matmul(mh, x.to(dtype).reshape(b, h, w * c))
    y = torch.matmul(mw, y.view(b * oh, w, c))
    return y.view(b, oh, ow, c).to(x.dtype)


def resize_linear(x, hw):
    """Half-pixel linear resize of NHWC ``x``, antialiased when it
    shrinks."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


def channel_dropout(x, rate, generator):
    """Channel dropout of the NCHW ``x``: one keep draw a (sample,
    channel) from ``generator``, kept channels scaled by 1/(1-rate)."""
    keep = torch.rand(x.shape[:2], generator=generator,
                      device=x.device) >= rate
    return x * (keep.to(x.dtype) / (1.0 - rate))[:, :, None, None]
