"""Shared functional ops for the model layer (counterpart of
``dasac_tpu/nn/functional.py``).

  * ``align_corners=True`` bilinear resize on NHWC tensors, as two
    interpolation-matrix products (the JAX ``"matmul"`` method), so the
    output stays NHWC-contiguous and the weights are the JAX ones;
  * ceil-mode max pooling, padded with -inf to the extent the JAX version
    computes, and VGG's plain floor-mode 2x2 max pooling;
  * half-pixel linear resize, antialiased when it shrinks (the counterpart
    of ``jax.image.resize(..., "linear")``).
"""

import numpy as np
import torch
import torch.nn.functional as F


def _linear_indices_weights(in_size, out_size):
    """Gather indices + lerp weights for align_corners=True resampling."""
    if out_size == 1 or in_size == 1:
        idx0 = np.zeros(out_size, dtype=np.int64)
        return idx0, idx0.copy(), np.zeros(out_size, dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    idx0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    w = (src - idx0).astype(np.float32)
    return idx0, idx0 + 1, w


def _linear_matrix(in_size, out_size):
    """Dense [out, in] align-corners interpolation matrix (two taps/row)."""
    i0, i1, w = _linear_indices_weights(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i1), w)
    return m


def resize_bilinear_align_corners(x, size, compute_dtype=torch.float32):
    """Bilinear resize with align_corners=True semantics.

    Args:
        x: [B, H, W, C] tensor.
        size: (out_h, out_w) python ints.
        compute_dtype: interpolation dtype (matrices and products).
    Returns:
        NHWC-contiguous [B, out_h, out_w, C] tensor, same dtype as ``x``.
    """
    out_h, out_w = int(size[0]), int(size[1])
    b, in_h, in_w, c = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    orig_dtype = x.dtype
    mh = torch.from_numpy(_linear_matrix(in_h, out_h)).to(x.device, compute_dtype)
    mw = torch.from_numpy(_linear_matrix(in_w, out_w)).to(x.device, compute_dtype)
    xf = x.to(compute_dtype).reshape(b, in_h, in_w * c)
    xf = torch.matmul(mh, xf)                                # [B, oh, W*C]
    xf = torch.matmul(mw, xf.view(b * out_h, in_w, c))       # [B*oh, ow, C]
    return xf.view(b, out_h, out_w, c).to(orig_dtype)


def max_pool_ceil(x, window=3, stride=2, padding=1):
    """Max pool with torch ceil_mode=True output size.

    ``x`` is NCHW-shaped (any memory format).  The input is padded with -inf
    up to the extent every window needs, as the JAX version does, so no
    window that starts in the right padding is dropped.
    """
    h, w = x.shape[-2], x.shape[-1]

    def _out_size(s):
        return int(np.ceil((s + 2 * padding - window) / stride)) + 1

    oh, ow = _out_size(h), _out_size(w)
    pad_h_hi = (oh - 1) * stride + window - h - padding
    pad_w_hi = (ow - 1) * stride + window - w - padding
    xp = F.pad(x, (padding, pad_w_hi, padding, pad_h_hi), value=float("-inf"))
    return F.max_pool2d(xp, window, stride)


def max_pool(x, window=2, stride=2):
    """Plain VALID max pool (VGG-style, floor mode, no padding) on an
    NCHW-shaped tensor (any memory format)."""
    return F.max_pool2d(x, window, stride)


def resize_linear(x, hw):
    """``jax.image.resize(x, (B, h, w, C), "linear")`` on an NHWC tensor:
    half-pixel centres (align_corners=False) and, when a side shrinks, a
    triangle filter widened by the scale (antialiasing), with the weights
    of taps outside the image dropped and the rest renormalized.  Computed
    by ``F.interpolate(mode="bilinear", antialias=True)`` on an NCHW view
    of the same memory; returns NHWC."""
    out_h, out_w = int(hw[0]), int(hw[1])
    if (x.shape[1], x.shape[2]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
