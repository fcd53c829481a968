"""Shared functional ops for the model layer (counterpart of
``dasac_tpu/nn/functional.py``).

  * ``align_corners=True`` bilinear resize on NHWC tensors, as two
    interpolation-matrix products (the JAX ``"matmul"`` method), so the
    output stays NHWC-contiguous and the weights are the JAX ones;
  * ceil-mode max pooling, padded with -inf to the extent the JAX version
    computes, and VGG's plain floor-mode 2x2 max pooling;
  * half-pixel linear resize, antialiased when it shrinks (the counterpart
    of ``jax.image.resize(..., "linear")``), and the plain half-pixel
    bilinear resize of ``F.interpolate(..., align_corners=False)`` that
    SegFormer's head upsamples with.

Under a height-sharded frame (``nn/spatial.py``) the resize and the pools
compute this rank's output rows from the rows they fetch, and their
backward sends each fetched row's gradient back to its owner (rows outside
the frame get none); the half-pixel resize runs on whole frames only (the
inference program and the gspmd steps apply it before the frame is
sharded).

``HOST_MATRICES`` counts the interpolation matrices the align-corners
resize builds on the host and copies to the input's device, and their
bytes (``spans.growth("host_matrices")`` over recorded spans); each resize
that changes the size is a ``resize`` span (``utils/spans.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from dasac_tpu_torch.nn import spatial
from dasac_tpu_torch.nn.layers import empty_rows
from dasac_tpu_torch.utils import spans

# the numpy-built interpolation matrices copied to a device, always on
HOST_MATRICES = {"count": 0, "bytes": 0}
spans.probe("host_matrices", lambda: dict(HOST_MATRICES))


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
    ctx = spatial.current()
    b, in_h, in_w, c = x.shape
    if ctx is not None:
        in_h = ctx.rows(x, 1)
    if (in_h, in_w) == (out_h, out_w):
        return x
    with spans.span("resize", x.device):
        return _resize_products(x, ctx, (in_h, in_w), (out_h, out_w),
                                compute_dtype)


def _host_to_device(m, device, dtype):
    HOST_MATRICES["count"] += 1
    HOST_MATRICES["bytes"] += m.nbytes
    return torch.from_numpy(m).to(device, dtype)


def _resize_products(x, ctx, in_hw, out_hw, compute_dtype):
    """The resize's matrices and products (``ctx``: the frame or None)."""
    b, _, _, c = x.shape
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    orig_dtype = x.dtype
    mh = _linear_matrix(in_h, out_h)
    if ctx is not None:
        # this rank's output rows read the input rows from the first tap
        # of its first row to the second tap of its last
        i0, i1, _ = _linear_indices_weights(in_h, out_h)

        def need(t):
            lo, hi = spatial.split(out_h, ctx.n, t)
            return (int(i0[lo]), int(i1[hi - 1]) + 1) if lo < hi else (0, 0)

        needs = [need(t) for t in range(ctx.n)]
        x = ctx.fetch(x, 1, in_h, needs, 0.0, "resize")
        (lo, hi), (r0, r1) = ctx.own(out_h), needs[ctx.s]
        mh, in_h, out_rows = mh[lo:hi, r0:r1], r1 - r0, hi - lo
    else:
        out_rows = out_h
    mh = _host_to_device(np.ascontiguousarray(mh), x.device, compute_dtype)
    mw = _host_to_device(_linear_matrix(in_w, out_w), x.device, compute_dtype)
    xf = x.to(compute_dtype).reshape(b, in_h, in_w * c)
    xf = torch.matmul(mh, xf)                                # [B, oh, W*C]
    xf = torch.matmul(mw, xf.view(b * out_rows, in_w, c))    # [B*oh, ow, C]
    y = xf.view(b, out_rows, out_w, c).to(orig_dtype)
    return y if ctx is None else ctx.record(y, 1, out_h)


def max_pool_ceil(x, window=3, stride=2, padding=1):
    """Max pool with torch ceil_mode=True output size.

    ``x`` is NCHW-shaped (any memory format).  The input is padded with -inf
    up to the extent every window needs, as the JAX version does, so no
    window that starts in the right padding is dropped.
    """
    ctx = spatial.current()
    h, w = x.shape[-2], x.shape[-1]
    if ctx is not None:
        h = ctx.rows(x, 2)   # the ceil-mode bottom pad is the frame's

    def _out_size(s):
        return int(np.ceil((s + 2 * padding - window) / stride)) + 1

    oh, ow = _out_size(h), _out_size(w)
    pad_h_hi = (oh - 1) * stride + window - h - padding
    pad_w_hi = (ow - 1) * stride + window - w - padding
    if ctx is None:
        xp = F.pad(x, (padding, pad_w_hi, padding, pad_h_hi),
                   value=float("-inf"))
        return F.max_pool2d(xp, window, stride)
    x = ctx.window(x, 2, h, oh, window, stride, padding, float("-inf"),
                   "pool")
    return _pool_strip(ctx, F.pad(x, (padding, pad_w_hi),
                                  value=float("-inf")), window, stride, oh)


def max_pool(x, window=2, stride=2):
    """Plain VALID max pool (VGG-style, floor mode, no padding) on an
    NCHW-shaped tensor (any memory format)."""
    ctx = spatial.current()
    if ctx is None:
        return F.max_pool2d(x, window, stride)
    h = ctx.rows(x, 2)
    oh = (h - window) // stride + 1
    x = ctx.window(x, 2, h, oh, window, stride, 0, float("-inf"), "pool")
    return _pool_strip(ctx, x, window, stride, oh)


def _pool_strip(ctx, x, window, stride, oh):
    """Max pool of this rank's input rows ``x`` (already padded) into its
    share of ``oh`` output rows."""
    if x.shape[2] == 0:   # this rank owns no output row
        y = empty_rows(x, (*x.shape[:2], 0,
                           (x.shape[3] - window) // stride + 1), x.dtype)
    else:
        y = F.max_pool2d(x, window, stride)
    return ctx.record(y, 2, oh)


def resize_linear(x, hw):
    """``jax.image.resize(x, (B, h, w, C), "linear")`` on an NHWC tensor:
    half-pixel centres (align_corners=False) and, when a side shrinks, a
    triangle filter widened by the scale (antialiasing), with the weights
    of taps outside the image dropped and the rest renormalized.  Computed
    by ``F.interpolate(mode="bilinear", antialias=True)`` on an NCHW view
    of the same memory; returns NHWC."""
    out_h, out_w = int(hw[0]), int(hw[1])
    if spatial.current() is not None:
        raise RuntimeError("resize_linear runs on whole frames, before a "
                           "frame's height is sharded")
    if (x.shape[1], x.shape[2]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def upsample_half_pixel(x, hw):
    """``F.interpolate(mode="bilinear", align_corners=False)`` of the NHWC
    ``x`` to ``hw`` (no antialiasing), on its NCHW view; returns NHWC in
    ``x``'s dtype.  Runs on whole frames only."""
    if (x.shape[1], x.shape[2]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
