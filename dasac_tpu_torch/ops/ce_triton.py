"""The fused-CE pair as Triton kernels: the port's first design of K1/K2,
kept off the main path as a yardstick for the CUDA kernels in
``dasac_tpu_torch/csrc/ce.cu`` (``chip_smoke.py`` checks and times both in
one call).  Nothing on the training path calls it.

A program takes ``_BLOCK_R`` rows; the class axis is padded to a power of
two of at least 32 and masked.  Rows are 19 classes (76 bytes) apart, so the
loads are never 16-byte vectors.  The kernels take the row and class strides
they are given.  ``triton`` is imported and the kernels compiled at the
first launch; a CPU tensor runs the plain version of ``ops/ce.py``.
``LAUNCHES`` counts kernel launches.
"""

import os

import torch

from dasac_tpu_torch.ops.ce import (IGNORE, check_inputs, nll_bwd_plain,
                                    nll_fwd_plain)
from dasac_tpu_torch.ops.cuda_build import REPO

LAUNCHES = {"nll_fwd": 0, "nll_bwd": 0}

_BLOCK_R = 128     # rows per program
_NUM_WARPS = 4
_KERNELS = {}
tl = None  # triton.language, bound by _kernels()


def _block_c(c):
    """Class axis padded to a power of two, at least 32."""
    return max(32, 1 << (int(c) - 1).bit_length())


def _kernels():
    """Import triton and define the kernels (once, at the first launch)."""
    if _KERNELS:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
    # ``tl`` is bound module-wide: Triton compiles a kernel from its source
    # and resolves the names it uses among the function's globals
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def nll_fwd(x_ptr, lbl_ptr, nll_ptr, n_rows, n_cls,
                stride_row, stride_cls, stride_lbl,
                IGNORE_ID: tl.constexpr, BLOCK_R: tl.constexpr,
                BLOCK_C: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_R \
            + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        row_ok = rows < n_rows
        col_ok = cols < n_cls
        x = tl.load(x_ptr + rows[:, None] * stride_row
                    + cols[None, :] * stride_cls,
                    mask=row_ok[:, None] & col_ok[None, :],
                    other=float("-inf")).to(tl.float32)
        lbl = tl.load(lbl_ptr + rows * stride_lbl, mask=row_ok,
                      other=IGNORE_ID).to(tl.int32)
        m = tl.max(x, axis=1)
        lse = tl.log(tl.sum(tl.exp(x - m[:, None]), axis=1)) + m
        hit = (cols[None, :] == lbl[:, None]) & col_ok[None, :]
        picked = tl.sum(tl.where(hit, x, 0.0), axis=1)
        nll = tl.where(lbl != IGNORE_ID, lse - picked, 0.0)
        tl.store(nll_ptr + rows, nll, mask=row_ok)

    @triton.jit
    def nll_bwd(x_ptr, lbl_ptr, g_ptr, dx_ptr, n_rows, n_cls,
                stride_row, stride_cls, stride_lbl, stride_g,
                IGNORE_ID: tl.constexpr, BLOCK_R: tl.constexpr,
                BLOCK_C: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_R \
            + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        row_ok = rows < n_rows
        col_ok = cols < n_cls
        mask = row_ok[:, None] & col_ok[None, :]
        x = tl.load(x_ptr + rows[:, None] * stride_row
                    + cols[None, :] * stride_cls,
                    mask=mask, other=float("-inf")).to(tl.float32)
        lbl = tl.load(lbl_ptr + rows * stride_lbl, mask=row_ok,
                      other=IGNORE_ID).to(tl.int32)
        g = tl.load(g_ptr + rows * stride_g, mask=row_ok,
                    other=0.0).to(tl.float32)
        e = tl.exp(x - tl.max(x, axis=1)[:, None])
        p = e / tl.sum(e, axis=1)[:, None]
        hit = (cols[None, :] == lbl[:, None]) & col_ok[None, :]
        onehot = tl.where(hit, 1.0, 0.0)
        gv = tl.where(lbl != IGNORE_ID, g, 0.0)
        dx = gv[:, None] * (p - onehot)
        tl.store(dx_ptr + rows[:, None] * n_cls + cols[None, :],
                 dx.to(dx_ptr.dtype.element_ty), mask=mask)

    _KERNELS.update(nll_fwd=nll_fwd, nll_bwd=nll_bwd)
    return _KERNELS


def _grid(n):
    return ((n + _BLOCK_R - 1) // _BLOCK_R,)


def nll_fwd(x2, lbl):
    """Per-row NLL of ``x2`` [N, C] against ``lbl`` [N] (f32 [N])."""
    if x2.device.type == "cpu":
        return nll_fwd_plain(x2, lbl)
    if x2.device.type != "cuda":
        raise ValueError("no CE kernel for device %s" % x2.device)
    check_inputs(x2, lbl)
    n, c = x2.shape
    out = torch.empty(n, device=x2.device, dtype=torch.float32)
    if n:
        _kernels()["nll_fwd"][_grid(n)](
            x2, lbl, out, n, c, x2.stride(0), x2.stride(1), lbl.stride(0),
            IGNORE_ID=IGNORE, BLOCK_R=_BLOCK_R, BLOCK_C=_block_c(c),
            num_warps=_NUM_WARPS)
        LAUNCHES["nll_fwd"] += 1
    return out


def nll_bwd(x2, lbl, g):
    """Gradient of ``sum(g * nll_fwd(x2, lbl))`` w.r.t. ``x2`` (contiguous
    [N, C] in ``x2``'s dtype)."""
    if x2.device.type == "cpu":
        return nll_bwd_plain(x2, lbl, g)
    if x2.device.type != "cuda":
        raise ValueError("no CE kernel for device %s" % x2.device)
    check_inputs(x2, lbl, g)
    n, c = x2.shape
    dx = torch.empty((n, c), device=x2.device, dtype=x2.dtype)
    if n:
        _kernels()["nll_bwd"][_grid(n)](
            x2, lbl, g, dx, n, c, x2.stride(0), x2.stride(1), lbl.stride(0),
            g.stride(0), IGNORE_ID=IGNORE, BLOCK_R=_BLOCK_R,
            BLOCK_C=_block_c(c), num_warps=_NUM_WARPS)
        LAUNCHES["nll_bwd"] += 1
    return dx
