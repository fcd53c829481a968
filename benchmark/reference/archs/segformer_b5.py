"""SegFormer-B5 (Xie et al., NeurIPS 2021, arXiv:2105.15203): the MiT-B5
encoder and the All-MLP decode head at embedding 768, written from the
paper's equations and the official code (NVlabs/SegFormer,
``mix_transformer.py`` ``mit_b5``, ``segformer_head.py``).

Encoder: widths (64, 128, 320, 512), heads (1, 2, 5, 8), depths
(3, 6, 40, 3), spatial-reduction ratios (8, 4, 2, 1), MLP ratio 4.  An
overlapped patch embedding (7x7 stride 4 pad 3, then 3x3 stride 2 pad 1,
each with a bias, then LayerNorm eps 1e-5) starts each stage; a block is
``x += dp(Attn(LN1 x)); x += dp(MixFFN(LN2 x))`` (LN eps 1e-6), with
``Attn`` ``softmax(q k^T / sqrt(64)) v`` over keys and values from
``LN(conv_RxR/R(x))`` (LN eps 1e-5) where R > 1, then ``proj``, and
``MixFFN`` ``fc2(GELU(DWConv3x3(fc1 x)))``; a LayerNorm (eps 1e-6) ends
each stage.  Stochastic depth rises linearly from 0 to 0.1 over the 52
blocks.  Head: ``Linear(C_i, 768)`` a stage, upsampled half-pixel to the
first stage's grid, concatenated [c4, c3, c2, c1], a 1x1 conv without a
bias, BN, ReLU, channel dropout 0.1, a 1x1 conv to the classes.  The
logits (stride 4, f32) are upsampled half-pixel to the frame.  Module
names are the official state-dict keys.

The attention is written out, ``softmax((q * scale) k^T) v`` (the scale
is a power of two, so it rounds nothing); at the SAC cell's sizes its
float32 probabilities and the rest of the student pass take ~45 GB, which
fit once the program is freed.  Products (linear layers, convolutions and
both attention products) take their operands in ``prec.dtype``, rounded
to fp8 under ``prec.fp8``; the LayerNorms run in ``prec.dtype``.

Random draws, as the program makes them: block by block, the attention
branch's stochastic depth (one ``rand(B) >= rate`` a block at a rate
above 0), then the FFN branch's, then the head's channel dropout.

Departures from the official code:
  * starting weights normal where the official ones are truncated normal:
    linear layers normal(0, 0.02), convolutions normal(0, sqrt(2 /
    fan_out)), LayerNorms 1 and 0, ``linear_pred`` normal(0, 0.01), a
    stand-in for the ImageNet-1k MiT-B5 weights (none are in the repo);
  * the recipe's SGD (``steps.build_sgd``), where DAFormer trains with
    AdamW;
  * the head's BN frozen in SAC, as for every arch of the recipe;
  * no unused ``conv_seg`` (mmseg's base head builds one the SegFormer
    head never calls)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (BatchNorm, Conv2d, channel_dropout,
                                        round_fp8)

NEW_SCOPES = ("decode_head",)
WIDTHS = (64, 128, 320, 512)
HEADS = (1, 2, 5, 8)
DEPTHS = (3, 6, 40, 3)
SR_RATIOS = (8, 4, 2, 1)
DROP_PATH_RATE = 0.1
DROP_RATE = 0.1


def _operands(prec, *ts):
    ts = [t.to(prec.dtype) for t in ts]
    return [round_fp8(t) for t in ts] if prec.fp8 else ts


def he_fan_out(cout, k, groups=1):
    return math.sqrt(2.0 * groups / (k * k * cout))


class Linear(Conv2d):
    """``x W^T + b`` over the last axis; ``[out, in]`` weight."""

    def __init__(self, cin, cout, init_std=0.02):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.init_std = init_std

    def forward(self, x, prec):
        x, w = _operands(prec, x, self.weight)
        return F.linear(x, w, self.bias.to(prec.dtype))


class Conv(Conv2d):
    """A convolution of ``groups`` groups with a bias (or none), started
    normal(0, sqrt(2 / fan_out))."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 bias=True, init_std=None):
        nn.Module.__init__(self)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.init_std = (he_fan_out(cout, k, groups) if init_std is None
                         else init_std)

    def forward(self, x, prec):
        x, w = _operands(prec, x, self.weight)
        b = None if self.bias is None else self.bias.to(prec.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, 1, self.groups)


class LayerNorm(BatchNorm):
    """LayerNorm over the last axis: weight 1, bias 0, no statistics."""

    def __init__(self, c, eps):
        nn.Module.__init__(self)
        self.eps, self.init_weight = eps, 1.0
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, prec):
        return F.layer_norm(x.to(prec.dtype), (x.shape[-1],),
                            self.weight.to(prec.dtype),
                            self.bias.to(prec.dtype), self.eps)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def attention(q, k, v, prec):
    """``softmax((q * scale) k^T) v`` of ``[B, heads, N, d]`` tensors in
    ``prec.dtype``."""
    q, k, v = _operands(prec, q * (q.shape[-1] ** -0.5), k, v)
    p = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
    return (round_fp8(p) if prec.fp8 else p) @ v


class PatchEmbed(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.proj = Conv(cin, cout, k, stride, k // 2)
        self.norm = LayerNorm(cout, 1e-5)

    def forward(self, x, prec):
        return self.norm(nhwc(self.proj(nchw(x), prec)), prec)


class Attention(nn.Module):
    def __init__(self, dim, heads, sr):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr > 1:
            self.sr = Conv(dim, dim, sr, sr)
            self.norm = LayerNorm(dim, 1e-5)

    def forward(self, x, prec):
        b, h, w, c = x.shape
        d = c // self.heads
        q = self.q(x, prec).reshape(b, h * w, self.heads, d).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(nhwc(self.sr(nchw(x), prec)), prec)
        kv = self.kv(x.reshape(b, -1, c), prec).reshape(
            b, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        o = attention(q, kv[0], kv[1], prec)
        return self.proj(o.transpose(1, 2).reshape(b, h, w, c), prec)


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, 1, 1, groups=dim)


class MixFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, prec):
        y = nhwc(self.dwconv.dwconv(nchw(self.fc1(x, prec)), prec))
        return self.fc2(F.gelu(y), prec)


class Block(nn.Module):
    def __init__(self, dim, heads, sr, rate):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = MixFFN(dim, 4 * dim)

    def _drop_path(self, y, train, generator):
        if not train or self.rate == 0.0:
            return y
        keep = torch.rand((y.shape[0],), generator=generator,
                          device=y.device) >= self.rate
        return y * (keep.to(y.dtype) / (1.0 - self.rate))[:, None, None, None]

    def forward(self, x, prec, train, generator):
        x = x + self._drop_path(self.attn(self.norm1(x, prec), prec), train,
                                generator)
        return x + self._drop_path(self.mlp(self.norm2(x, prec), prec),
                                   train, generator)


class MiT(nn.Module):
    def __init__(self, widths, heads, depths, sr_ratios):
        super().__init__()
        cin = 3
        for i, c in enumerate(widths, start=1):
            k, s = (7, 4) if i == 1 else (3, 2)
            setattr(self, "patch_embed%d" % i, PatchEmbed(cin, c, k, s))
            cin = c
        rates = torch.linspace(0, DROP_PATH_RATE, sum(depths),
                               device="cpu").tolist()
        at = 0
        for i, (c, n, r, dep) in enumerate(
                zip(widths, heads, sr_ratios, depths), start=1):
            setattr(self, "block%d" % i, nn.ModuleList([
                Block(c, n, r, rates[at + j]) for j in range(dep)]))
            setattr(self, "norm%d" % i, LayerNorm(c, 1e-6))
            at += dep
        self.stages = len(widths)

    def forward(self, x, prec, train, generator):
        outs = []
        for i in range(1, self.stages + 1):
            x = getattr(self, "patch_embed%d" % i)(x, prec)
            for block in getattr(self, "block%d" % i):
                x = block(x, prec, train, generator)
            x = getattr(self, "norm%d" % i)(x, prec)
            outs.append(x)
        return outs


class MLP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = Linear(cin, cout)


class ConvModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False)
        self.bn = BatchNorm(cout)


def resize_half_pixel(x, hw):
    """Half-pixel bilinear resize of NHWC ``x`` (``align_corners=False``,
    no antialiasing)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return nhwc(F.interpolate(nchw(x), size=tuple(hw), mode="bilinear",
                              align_corners=False))


class Head(nn.Module):
    def __init__(self, widths, width, num_classes):
        super().__init__()
        self.n = len(widths)
        for i in range(self.n, 0, -1):
            setattr(self, "linear_c%d" % i, MLP(widths[i - 1], width))
        self.linear_fuse = ConvModule(self.n * width, width)
        self.linear_pred = Conv(width, num_classes, 1, init_std=0.01)

    def forward(self, feats, prec, live, train, generator):
        hw = feats[0].shape[1:3]
        x = torch.cat([resize_half_pixel(getattr(self, "linear_c%d" % i).proj(
            feats[i - 1], prec), hw) for i in range(self.n, 0, -1)], dim=-1)
        f = self.linear_fuse
        x = torch.relu(f.bn(f.conv(nchw(x), prec), prec, live))
        if train:
            x = channel_dropout(x, DROP_RATE, generator)
        return self.linear_pred(x, prec)


class Model(nn.Module):
    def __init__(self, num_classes, widths=WIDTHS, heads=HEADS,
                 depths=DEPTHS, sr_ratios=SR_RATIOS, head_width=768):
        super().__init__()
        self.backbone = MiT(widths, heads, depths, sr_ratios)
        self.decode_head = Head(widths, head_width, num_classes)

    def forward(self, x, prec, live=False, train=False, generator=None,
                upsample=True):
        """NHWC ``x`` -> ``(logits, logits_up)``, NHWC f32; with ``train``
        stochastic depth and the head's dropout draw from ``generator``."""
        h, w = x.shape[1:3]
        feats = self.backbone(x.to(prec.dtype), prec, train, generator)
        logits = nhwc(self.decode_head(feats, prec, live, train,
                                       generator).float())
        if not upsample:
            return logits, None
        return logits, resize_half_pixel(logits, (h, w))
