"""SegFormer-B5: the MiT-B5 encoder and the All-MLP decode head (Xie et
al., NeurIPS 2021, arXiv:2105.15203; the official code's
``mix_transformer.py`` ``mit_b5`` and ``segformer_head.py``).

Encoder (MiT-B5): four stages of widths (64, 128, 320, 512), heads
(1, 2, 5, 8) of 64 channels, depths (3, 6, 40, 3) and spatial-reduction
ratios (8, 4, 2, 1).  Each stage starts with an overlapped patch embedding
(a 7x7 stride-4 conv for the first, 3x3 stride 2 after; each with a bias,
then LayerNorm eps 1e-5) and ends with a LayerNorm (eps 1e-6).  A block is

    x = x + dp(Attn(LN1 x));  x = x + dp(MixFFN(LN2 x))

with LN eps 1e-6.  ``Attn``: ``q = Wq x``; where the ratio R > 1 the keys
and values come from ``LN(conv_RxR/R(x))`` (eps 1e-5), else from ``x``;
``softmax(q k^T / sqrt(64)) v``, then ``Wproj``.  ``MixFFN``:
``fc2(GELU(DWConv3x3(fc1 x)))`` at 4C hidden channels.  Stochastic depth
``dp`` rises linearly from 0 to 0.1 over the 52 blocks; no other dropout.

Head: each stage's output through its own ``Linear(C_i, 768)``, upsampled
half-pixel (align_corners=False) to the first stage's grid, concatenated
as [c4, c3, c2, c1], ``linear_fuse`` (1x1 conv without bias, BN, ReLU),
channel dropout 0.1 and ``linear_pred`` (1x1 conv to the classes).

The model returns ``(logits at stride 4, logits upsampled half-pixel to
the frame)``, both NHWC f32, with the arguments of the other archs.  Tokens
stay NHWC ``[B, H, W, C]``: the linear layers act on the last axis, and
the convolutions run on the ``channels_last`` NCHW view of the same
memory.  Parameters are f32, cast to ``dtype`` at use.  Attention is
``F.scaled_dot_product_attention``, held on the card to a fused backend
(flash, memory-efficient or cuDNN): the math one would hold every score;
on the CPU it is its plain version (:func:`attend`).

Random draws (``train=True``, from ``generator``): block by block, one
keep value a sample for the attention branch's stochastic depth, then one
for the FFN branch's (``rand(B) >= rate``, kept branches scaled by
``1 / (1 - rate)``; a block at rate 0 draws nothing), then the head's
channel dropout.  The draws are made outside the remat checkpoints.

``remat``: "none", or "block", which checkpoints each transformer block.
On the card under "none", each block's two residual branches replay CUDA
graphs (``nn/graphs.py``): one pass of graphs a (frame shape, dtype, grad
mode, ``train``, weights), at most ``GRAPH_PASSES`` of them in
``backbone.graph_passes`` (``graphs.Passes(0)`` runs every branch
eagerly), so the student's passes with gradients and the teacher's without
each capture theirs at their first call, and the host enqueues a few calls
a branch instead of each of its operators; the kernels are those of the
eager branch.

Module names are the official state-dict keys (``backbone.patch_embed1.
proj``, ``backbone.block3.17.attn.sr``, ``backbone.block1.0.mlp.dwconv.
dwconv``, ``backbone.norm4``, ``decode_head.linear_c1.proj``,
``decode_head.linear_fuse.conv`` / ``.bn``, ``decode_head.linear_pred``),
registered in the official order.

Spans (``utils/spans.py``), around each branch whether eager or replayed:
``attention`` (LN1, q, the reduction conv and its LN, kv, the attention,
proj, the drop path and the residual add), ``mix_ffn`` (LN2, fc1, the
depthwise conv, GELU, fc2, the drop path and the residual add) and
``decode_head``.  ``ATTENTION`` counts the attention calls and their
query-key ``pairs`` (B x heads x Nq x Nkv), graph and remat replays
included; the span probe ``attention`` reads it.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from dasac_tpu_torch.nn import graphs, spatial
from dasac_tpu_torch.nn.functional import upsample_half_pixel
from dasac_tpu_torch.nn.layers import (Conv2d, LayerNorm, Linear,
                                       SyncBatchNorm, apply_channel_dropout,
                                       checkpointed,
                                       sample_channel_dropout_draws,
                                       sample_keep)
from dasac_tpu_torch.nn.resnet import remat_mode
from dasac_tpu_torch.utils import spans
from dasac_tpu_torch.utils.spans import span

WIDTHS = (64, 128, 320, 512)
HEADS = (1, 2, 5, 8)
DEPTHS = (3, 6, 40, 3)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIO = 4
DROP_PATH_RATE = 0.1
HEAD_WIDTH = 768
DROP_RATE = 0.1         # the head's channel dropout
PRED_STD = 0.01         # linear_pred, normal(0, 0.01)
# passes a model whose blocks' branches replay CUDA graphs (nn/graphs.py)
GRAPH_PASSES = 4

# the attention calls and their query-key pairs, always on
ATTENTION = {"calls": 0, "pairs": 0}
spans.probe("attention", lambda: dict(ATTENTION))


def he_fan_out(out_ch, k, groups=1):
    """The official conv init's std, ``sqrt(2 / fan_out)``."""
    return math.sqrt(2.0 * groups / (k * k * out_ch))


def attend(q, k, v):
    """``softmax(q k^T / sqrt(d)) v`` of ``[B, heads, N, d]`` operands,
    counted in ``ATTENTION``.  On the card, ``F.scaled_dot_product_attention``
    on a fused backend (flash, memory-efficient or cuDNN), or an error;
    elsewhere its plain version, the scale applied to ``q``."""
    ATTENTION["calls"] += 1
    ATTENTION["pairs"] += q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
    if q.is_cuda:
        # the math backend off for this call: a fused one runs, or it raises
        # (``sdpa_kernel`` does the same at ~20x the host's time a call)
        math = torch.backends.cuda.math_sdp_enabled()
        torch.backends.cuda.enable_math_sdp(False)
        try:
            return F.scaled_dot_product_attention(q, k, v)
        finally:
            torch.backends.cuda.enable_math_sdp(math)
    p = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1), dim=-1)
    return p @ v


def _nchw(x):
    """The NCHW view of NHWC ``x`` (``channels_last`` when contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """Overlapped patch embedding: a ``k x k`` stride-``s`` conv with a
    bias, padded ``k // 2``, then LayerNorm; NHWC in and out."""

    def __init__(self, cin, cout, k, stride, dtype):
        super().__init__()
        self.proj = Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                           bias=True, dtype=dtype,
                           init_std=he_fan_out(cout, k))
        self.norm = LayerNorm(cout, eps=1e-5, dtype=dtype)

    def forward(self, x):
        return self.norm(_nhwc(self.proj(_nchw(x))))


class Attention(nn.Module):
    """Efficient self-attention with spatial reduction ``sr_ratio``."""

    def __init__(self, dim, heads, sr_ratio, dtype):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, bias=True,
                             dtype=dtype, init_std=he_fan_out(dim, sr_ratio))
            self.norm = LayerNorm(dim, eps=1e-5, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        d = c // self.heads
        q = self.q(x).reshape(b, h * w, self.heads, d).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(_nhwc(self.sr(_nchw(x))))
        kv = self.kv(x.reshape(b, -1, c)).reshape(
            b, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        o = attend(q, kv[0], kv[1])
        return self.proj(o.transpose(1, 2).reshape(b, h, w, c))


class DWConv(nn.Module):
    """The 3x3 depthwise conv (with a bias) of the Mix-FFN, NHWC in and
    out (the official module holds it as ``dwconv``)."""

    def __init__(self, dim, dtype):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, bias=True, groups=dim,
                             dtype=dtype, init_std=he_fan_out(dim, 3, dim))

    def forward(self, x):
        return _nhwc(self.dwconv(_nchw(x)))


class MixFFN(nn.Module):
    def __init__(self, dim, hidden, dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = DWConv(hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class Block(nn.Module):
    """A transformer block; ``drop_path`` is its stochastic-depth rate.
    Its two residual branches, ``x + dp(Attn(LN1 x))`` under the span
    ``attention`` and ``x + dp(MixFFN(LN2 x))`` under ``mix_ffn``, run
    eagerly or from a pass's CUDA graphs (``nn/graphs.py``)."""

    def __init__(self, dim, heads, sr_ratio, drop_path, dtype):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = Attention(dim, heads, sr_ratio, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = MixFFN(dim, MLP_RATIO * dim, dtype)
        # each branch's weights as (module, name), read at each call
        self._weights = {
            name: [(m, k) for mod in mods for m in mod.modules()
                   for k, _ in m.named_parameters(recurse=False)]
            for name, mods in (("attention", (self.norm1, self.attn)),
                               ("mix_ffn", (self.norm2, self.mlp)))}

    def keeps(self, x, train, generator):
        """The two branches' keep masks ``[B]`` (``None``: no draw)."""
        if not train or self.drop_path == 0.0:
            return None, None
        return tuple(sample_keep(generator, (x.shape[0],), self.drop_path,
                                 x.device) for _ in range(2))

    def _drop(self, y, keep):
        if keep is None:
            return y
        scale = keep.to(y.dtype) / (1.0 - self.drop_path)
        return y * scale[:, None, None, None]

    def _attention(self, x, keep):
        return x + self._drop(self.attn(self.norm1(x)), keep)

    def _mix_ffn(self, x, keep):
        return x + self._drop(self.mlp(self.norm2(x)), keep)

    def _branch(self, name, fn, x, keep, graphed):
        with span(name):
            if graphed is None:
                return fn(x, keep)
            return graphed((id(self), name), fn, x, keep,
                           self._weights[name], (ATTENTION,))

    def forward(self, x, keep_attn, keep_ffn, graphed=None):
        """``graphed``: the pass (``nn/graphs.Pass``) the branches run
        in, ``None`` for eagerly."""
        x = self._branch("attention", self._attention, x, keep_attn,
                         graphed)
        return self._branch("mix_ffn", self._mix_ffn, x, keep_ffn, graphed)


class MiT(nn.Module):
    """The Mix Transformer encoder; returns the four stages' NHWC
    outputs."""

    def __init__(self, widths, heads, depths, sr_ratios, dtype, remat):
        super().__init__()
        self.remat, self.depths = remat, depths
        self.graph_passes = graphs.Passes(GRAPH_PASSES)
        cin = 3
        for i, c in enumerate(widths, start=1):
            k, s = (7, 4) if i == 1 else (3, 2)
            setattr(self, "patch_embed%d" % i, PatchEmbed(cin, c, k, s,
                                                          dtype))
            cin = c
        rates = torch.linspace(0, DROP_PATH_RATE, sum(depths),
                               device="cpu").tolist()
        at = 0
        for i, (c, n, r) in enumerate(zip(widths, heads, sr_ratios), start=1):
            setattr(self, "block%d" % i, nn.ModuleList([
                Block(c, n, r, rates[at + j], dtype)
                for j in range(depths[i - 1])]))
            setattr(self, "norm%d" % i, LayerNorm(c, eps=1e-6, dtype=dtype))
            at += depths[i - 1]

    def _pass(self, x, train):
        """The blocks' graphed pass for this call, or ``None`` (eager):
        on the card without remat, one pass a (shape, dtype, grad mode,
        ``train``, weights)."""
        if not (x.is_cuda and self.remat == "none"):
            return None
        key = (tuple(x.shape), x.dtype, torch.is_grad_enabled(), train,
               self.patch_embed1.proj.weight.data_ptr())
        return self.graph_passes.get(key, x.device)

    def forward(self, x, train, generator):
        outs, graphed = [], self._pass(x, train)
        for i in range(1, len(self.depths) + 1):
            x = getattr(self, "patch_embed%d" % i)(x)
            for block in getattr(self, "block%d" % i):
                keep_attn, keep_ffn = block.keeps(x, train, generator)
                if graphed is None:
                    x = checkpointed(block, self.remat, x, keep_attn,
                                     keep_ffn)
                else:
                    x = block(x, keep_attn, keep_ffn, graphed)
            x = getattr(self, "norm%d" % i)(x)
            outs.append(x)
        return outs


class MLP(nn.Module):
    """The head's per-stage embedding (the official ``MLP``: ``proj``)."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.proj = Linear(cin, cout, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class ConvModule(nn.Module):
    """``relu(bn(conv1x1(x)))``, the conv without a bias (mmseg's
    ``ConvModule`` with a norm)."""

    def __init__(self, cin, cout, dtype, group):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, dtype=dtype,
                           init_std=he_fan_out(cout, 1))
        self.bn = SyncBatchNorm(cout, dtype=dtype, group=group)

    def forward(self, x, frozen):
        return self.bn(self.conv(x), frozen, relu=True)


class SegFormerHead(nn.Module):
    """The All-MLP decode head; NHWC stage outputs in, NCHW-shaped
    (``channels_last``) logits at the first stage's grid out."""

    def __init__(self, widths, width, num_classes, dtype, group):
        super().__init__()
        self.n = len(widths)
        for i in range(self.n, 0, -1):
            setattr(self, "linear_c%d" % i, MLP(widths[i - 1], width, dtype))
        self.linear_fuse = ConvModule(self.n * width, width, dtype, group)
        self.linear_pred = Conv2d(width, num_classes, 1, bias=True,
                                  dtype=dtype, init_std=PRED_STD)

    def forward(self, feats, frozen, train, generator):
        with span("decode_head"):
            hw = feats[0].shape[1:3]
            x = torch.cat([upsample_half_pixel(
                getattr(self, "linear_c%d" % i)(feats[i - 1]), hw)
                for i in range(self.n, 0, -1)], dim=-1)
            x = self.linear_fuse(_nchw(x), frozen)
            if train:
                x = apply_channel_dropout(x, sample_channel_dropout_draws(
                    generator, x, DROP_RATE), DROP_RATE)
            return self.linear_pred(x)


class SegFormerB5(nn.Module):
    """Takes NHWC input; returns ``(logits_s4, logits_up)``, both NHWC
    f32.  The widths, heads, depths, ratios and head width default to
    SegFormer-B5's (tests build smaller ones)."""

    def __init__(self, num_classes=19, dtype=torch.float32, remat="none",
                 group=None, widths=WIDTHS, heads=HEADS, depths=DEPTHS,
                 sr_ratios=SR_RATIOS, head_width=HEAD_WIDTH):
        super().__init__()
        mode = remat_mode(remat)
        if mode not in ("none", "block"):
            raise ValueError("SegFormer's remat is none or block, got %r"
                             % (remat,))
        self.dtype = dtype
        self.backbone = MiT(widths, heads, depths, sr_ratios, dtype, mode)
        self.decode_head = SegFormerHead(widths, head_width, num_classes,
                                         dtype, group)

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        """``upsample=False`` returns ``(logits_s4, None)``."""
        if spatial.current() is not None:
            raise RuntimeError("SegFormer's attention runs on whole frames, "
                               "not on a height-sharded one")
        h, w = x.shape[1:3]
        feats = self.backbone(x.to(self.dtype), train, generator)
        logits = _nhwc(self.decode_head(feats, not update_stats, train,
                                        generator).float())
        if not upsample:
            return logits, None
        return logits, upsample_half_pixel(logits, (h, w))
