"""Fused per-pixel cross-entropy: a hand-written CUDA C++ kernel pair for
Hopper (``dasac_tpu_torch/csrc/ce.cu``), its plain PyTorch version, and
the autograd glue.

Counterpart of ``dasac_tpu/ops/ce.py``:

  * ``nll_fwd`` replaces the Pallas ``_fwd_kernel`` (``:49``, reached
    through ``_fwd_call``): per row ``nll = logsumexp(x) - x[label]`` in
    f32, 0 where ``label == 255``.
  * ``nll_bwd`` replaces the Pallas ``_bwd_kernel`` (``:60``, reached
    through ``_bwd_call``): it recomputes the softmax from the logits and
    writes ``dx = g * (softmax(x) - onehot(label))`` in the logits' dtype,
    0 at ignored rows.

Both run twice per SAC step: the source ``cross_entropy_mean`` and the
target ``focal_ce`` each take one forward and one backward.

What bounds them: both are single streaming passes over the logits with no
matrix product, so bytes, not operations, set their floor.  At the flagship
shape (f32 logits ``[8,512,1024,19]``, N = 4,194,304 rows, int32 labels)
the forward reads 318.8 MB of logits and 16.8 MB of labels and writes
16.8 MB; the backward reads the logits, labels and upstream gradient
(318.8 + 16.8 + 16.8 MB) and writes 318.8 MB of ``dx``.  A 19-wide row is
76 bytes, never 16-byte aligned, so loads that follow the rows cannot be
vectors and keep too few bytes in flight.  What the design does about it
(the bulk path, every launch of the training step): tiles of 256 rows are
flat runs of ``256 * C`` elements whose size and offset are multiples of 16
bytes, moved whole into shared memory by the Tensor Memory Accelerator's
1-D bulk copy through a ring of stages, in a persistent grid; one thread
reduces one row from shared memory in f32, and the backward's ``dx`` tile
leaves by one bulk store.  One pass over the logits in each direction, no
log-softmax residual kept between forward and backward (only the logits
and labels are saved), ``dx`` written straight in the logits' dtype.
Inputs that are strided or not 16-byte aligned take a simple
one-thread-per-row kernel (the strided path); :func:`kernel_path` chooses.

The kernels take f32, bf16 and f16 logits and int32 or int64 labels; other
label types raise ``TypeError``.  The wrapper views ``[..., C]`` as
``[N, C]`` rows and raises when that needs a copy: a hidden
``.contiguous()`` would add a full read and write of the logits.  The
model's ``logits_up`` is NHWC-contiguous, so on the main path the view is
free.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel (``nvcc`` builds ``csrc/ce.cu`` into ``build/kernels/``
at the first launch) or raise.  ``LAUNCHES`` counts kernel launches by
kernel and ``PATH_LAUNCHES`` by kernel and path.  The port's earlier Triton
pair is kept off the main path in ``ops/ce_triton.py`` as a yardstick.
"""

import ctypes

import torch

from dasac_tpu_torch.ops import cuda_build

IGNORE = 255

# kernel launches, by kernel and by path; plain-version calls are not
# counted
LAUNCHES = {"nll_fwd": 0, "nll_bwd": 0}
PATH_LAUNCHES = {k: {"bulk": 0, "strided": 0} for k in LAUNCHES}

SOURCE = cuda_build.REPO / "dasac_tpu_torch" / "csrc" / "ce.cu"

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# entry points of csrc/ce.cu: name -> (restype, argtypes)
SIGNATURES = {
    "ce_nll_fwd_bulk": (_INT, (_P, _P, _P, _I64, _I64, _INT, _INT, _INT,
                               _P)),
    "ce_nll_fwd_strided": (_INT, (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                  _INT, _INT, _INT, _P)),
    "ce_nll_bwd_bulk": (_INT, (_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT,
                               _P)),
    "ce_nll_bwd_strided": (_INT, (_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                  _I64, _I64, _INT, _INT, _INT, _P)),
    "ce_error_string": (ctypes.c_char_p, (_INT,)),
}
_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}

# the bulk path's tiles and shared memory, as csrc/ce.cu lays them out
_ROWS = 256
_FWD_STAGES, _BWD_STAGES, _OUT_BUFS, _BAR_BYTES = 4, 3, 2, 128
_SMEM_MAX = 232448     # shared memory one block may take on Hopper

_LIB = None


# ---------------------------------------------------------------------------
# plain versions (row-wise, f32) — the CPU path and the oracle on the card
# ---------------------------------------------------------------------------

def nll_fwd_plain(x2, lbl):
    """``x2`` [N, C], ``lbl`` [N] integer -> f32 [N] NLL, 0 at ignore."""
    x = x2.float()
    m = x.amax(dim=1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(dim=1)) + m[:, 0]
    cls = torch.arange(x.shape[1], device=x.device)
    picked = torch.where(cls[None, :] == lbl[:, None], x, 0.0).sum(dim=1)
    return torch.where(lbl != IGNORE, lse - picked, 0.0)


def nll_bwd_plain(x2, lbl, g):
    """``dx = g * (softmax(x) - onehot(lbl))`` in ``x2``'s dtype, 0 at
    ignored rows; ``g`` [N] f32."""
    x = x2.float()
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    p = e / e.sum(dim=1, keepdim=True)
    cls = torch.arange(x.shape[1], device=x.device)
    onehot = (cls[None, :] == lbl[:, None]).float()
    gv = torch.where(lbl != IGNORE, g.float(), 0.0)
    return (gv[:, None] * (p - onehot)).to(x2.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def check_inputs(x2, lbl, *per_row):
    """Raise on inputs the kernels do not take."""
    if x2.dim() != 2:
        raise ValueError("CE kernel takes [N, C] rows, got shape %s"
                         % (tuple(x2.shape),))
    if x2.dtype not in _X_CODES:
        raise TypeError("CE kernel takes f32/bf16/f16 logits, got %s"
                        % x2.dtype)
    if lbl.dtype not in _LABEL_CODES:
        raise TypeError("CE kernel takes int32 or int64 integer labels, "
                        "got %s" % lbl.dtype)
    for t in (lbl,) + per_row:
        if t.device != x2.device:
            raise ValueError("CE kernel inputs on %s and %s"
                             % (x2.device, t.device))
        if tuple(t.shape) != (x2.shape[0],):
            raise ValueError("CE kernel: per-row input of shape %s for %d "
                             "rows" % (tuple(t.shape), x2.shape[0]))
    for t in per_row:
        if t.dtype != torch.float32:
            raise TypeError("CE kernel takes an f32 upstream gradient, got "
                            "%s" % t.dtype)


def _bulk_smem(kind, c, x_size, lbl_size):
    """Shared memory of one bulk-path block, as csrc/ce.cu lays it out."""
    x_tile = _ROWS * c * x_size
    if kind == "nll_fwd":
        return _BAR_BYTES + _FWD_STAGES * (x_tile + _ROWS * lbl_size)
    return (_BAR_BYTES + _BWD_STAGES * (x_tile + _ROWS * lbl_size + _ROWS * 4)
            + _OUT_BUFS * x_tile)


def kernel_path(kind, x2, lbl, *per_row):
    """``"bulk"`` when the logits, the labels and every per-row input
    (``g``) are contiguous with 16-byte aligned bases and a block's tiles
    fit in shared memory; ``"strided"`` otherwise (an offset view such as
    ``x2[1:]``, a class slice, a transposed view)."""
    smem = _bulk_smem(kind, x2.shape[1], x2.element_size(),
                      lbl.element_size())
    aligned = all(t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (x2, lbl) + per_row)
    return "bulk" if aligned and smem <= _SMEM_MAX else "strided"


def _library(device):
    global _LIB
    if _LIB is None:
        _LIB = cuda_build.load(SOURCE, SIGNATURES)
    cuda_build.require_hopper(device)
    return _LIB


def _call(lib, kind, path, x2, args):
    """Launch ``kind`` on ``path`` on the current stream; raise if CUDA
    refused it."""
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = getattr(lib, "ce_%s_%s" % (kind, path))(*args, x2.device.index,
                                                 stream)
    if rc:
        raise RuntimeError("CE kernel %s (%s path) failed: CUDA error %d, %s"
                           % (kind, path, rc,
                              lib.ce_error_string(rc).decode()))
    LAUNCHES[kind] += 1
    PATH_LAUNCHES[kind][path] += 1


def _launch_fwd(x2, lbl):
    check_inputs(x2, lbl)
    n, c = x2.shape
    out = torch.empty(n, device=x2.device, dtype=torch.float32)
    if n:
        path = kernel_path("nll_fwd", x2, lbl)
        lib = _library(x2.device)
        head = (x2.data_ptr(), lbl.data_ptr(), out.data_ptr(), n, c)
        strides = (x2.stride(0), x2.stride(1), lbl.stride(0))
        codes = (_X_CODES[x2.dtype], _LABEL_CODES[lbl.dtype])
        _call(lib, "nll_fwd", path, x2,
              head + (strides if path == "strided" else ()) + codes)
    return out


def _launch_bwd(x2, lbl, g):
    check_inputs(x2, lbl, g)
    n, c = x2.shape
    dx = torch.empty((n, c), device=x2.device, dtype=x2.dtype)
    if n:
        path = kernel_path("nll_bwd", x2, lbl, g)
        lib = _library(x2.device)
        head = (x2.data_ptr(), lbl.data_ptr(), g.data_ptr(), dx.data_ptr(),
                n, c)
        strides = (x2.stride(0), x2.stride(1), lbl.stride(0), g.stride(0))
        codes = (_X_CODES[x2.dtype], _LABEL_CODES[lbl.dtype])
        _call(lib, "nll_bwd", path, x2,
              head + (strides if path == "strided" else ()) + codes)
    return dx


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA, nothing else
# ---------------------------------------------------------------------------

def nll_fwd(x2, lbl):
    """Per-row NLL of ``x2`` [N, C] against ``lbl`` [N] (f32 [N])."""
    if x2.device.type == "cpu":
        return nll_fwd_plain(x2, lbl)
    if x2.device.type == "cuda":
        return _launch_fwd(x2, lbl)
    raise ValueError("no CE kernel for device %s" % x2.device)


def nll_bwd(x2, lbl, g):
    """Gradient of ``sum(g * nll_fwd(x2, lbl))`` w.r.t. ``x2`` (contiguous
    [N, C] in ``x2``'s dtype)."""
    if x2.device.type == "cpu":
        return nll_bwd_plain(x2, lbl, g)
    if x2.device.type == "cuda":
        return _launch_bwd(x2, lbl, g)
    raise ValueError("no CE kernel for device %s" % x2.device)


def as_rows(logits):
    """View ``[..., C]`` as ``[N, C]`` rows; raises where that needs a copy."""
    c = logits.shape[-1]
    try:
        return logits.view(-1, c)
    except RuntimeError as e:
        raise ValueError(
            "CE kernel: logits of shape %s and strides %s cannot be viewed "
            "as [N, %d] rows without a copy; keep them channels-last"
            % (tuple(logits.shape), logits.stride(), c)) from e


class _NllRows(torch.autograd.Function):
    """Saves only the logits and labels; the backward recomputes the
    softmax (``nll_bwd``).  Labels get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        nll = nll_fwd(as_rows(logits), labels.reshape(-1))
        return nll.view(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        dx = nll_bwd(as_rows(logits), labels.reshape(-1), g.reshape(-1))
        return dx.view(logits.shape), None


def nll_fused(logits, labels):
    """Per-pixel NLL with ignore masking, softmax recomputed in backward
    (counterpart of ``dasac_tpu.ops.ce.nll_pallas``).

    Args:
        logits: ``[..., C]`` float tensor (f32, bf16 or f16), rows
            viewable without a copy.
        labels: ``[...]`` integer labels, 255 = ignore (int32 or int64 on
            the card).
    Returns:
        f32 ``[...]`` NLL, zero at ignored pixels; differentiable w.r.t.
        ``logits`` (gradient in the logits' dtype).
    """
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError("labels %s do not match logits %s"
                         % (tuple(labels.shape), tuple(logits.shape)))
    return _NllRows.apply(logits, labels)
