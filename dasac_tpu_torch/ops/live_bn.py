"""Live batch normalisation's big passes: hand-written CUDA C++ kernels for
Hopper (``dasac_tpu_torch/csrc/live_bn.cu``), their plain PyTorch
versions, and two autograd Functions.

``SyncBatchNorm``'s batch-statistics path (``nn/layers.py``) is

    sums = bn_sums(x)                       # [sum x, sum x*x], f32 [2C]
    ... mean, variance, rsqrt, scale = inv * weight, shift = bias - mean *
    scale, the group all-reduce and the running statistics, per channel,
    in autograd as before ...
    y = bn_apply(x, scale, shift, residual, relu)

so only the passes over the whole activation move into kernels:

  * ``bn_sums`` (kernel ``live_bn_sums``): both sums in one pass over the
    bf16 input, accumulated in f32; its backward (``live_bn_sums_bwd``)
    writes ``dx = g_sum + 2 * g_sumsq * x`` in one pass.
  * ``bn_apply`` (kernel ``live_bn_apply``): ``relu?(x * scale + shift [+
    residual])`` in one pass, with the f32 coefficients unrounded and one
    rounding to the input's type; its backward (``live_bn_apply_bwd``) reads
    ``dy``, ``x`` and, with the ReLU, ``y`` (its mask), writes ``dx`` and
    ``dresidual``, and leaves the per-channel sums of the masked ``dy`` and
    of it times ``x`` (the gradients of ``shift`` and ``scale``).

They replace no Pallas kernel: ``dasac_tpu``'s BN is ``jnp`` code
(``dasac_tpu/nn/layers.py``).  What bounds them is bytes (``csrc/live_bn.cu``
says how the design meets that): a forward reads the activation twice and
writes it once, a backward reads ``dy``, ``x`` and ``y`` and writes ``dx``,
then reads ``x`` and writes its part of ``dx``; the step keeps no f32 copy,
only the bf16 input and output that it holds anyway.  The sums are
deterministic: per-block partial rows added in a fixed order, in the same
launch.

Rows are the channels_last layout's ``[N * H * W, C]``: on a CUDA tensor
the wrappers take NCHW-shaped tensors in ``channels_last`` memory (f32 or
bf16, contiguous f32 per-channel coefficients) and raise on anything else;
they never copy to make a layout fit (:func:`channels_last` is the caller's
copy, a no-op for the models' activations).  On a CPU tensor they run the
plain version; on a CUDA tensor they launch the kernel (``nvcc`` builds
``csrc/live_bn.cu`` into ``build/kernels/`` at the first launch) or raise.
``bn_sums`` and ``bn_apply`` skip autograd's bookkeeping when nothing asks
for a gradient (the ABN step's target pass).  ``LAUNCHES`` counts kernel
launches by kernel (plain-version calls are not counted); the span probe
``live_bn`` reads it.
"""

import ctypes

import torch

from dasac_tpu_torch.ops import cuda_build
from dasac_tpu_torch.utils import spans

# kernel launches by kernel; plain-version calls are not counted
LAUNCHES = {"live_bn_sums": 0, "live_bn_sums_bwd": 0, "live_bn_apply": 0,
            "live_bn_apply_bwd": 0}
spans.probe("live_bn", lambda: dict(LAUNCHES))

SOURCE = cuda_build.REPO / "dasac_tpu_torch" / "csrc" / "live_bn.cu"

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_GEOM = (_I64, _I64, _INT, _INT, _INT, _INT)     # m, c, vec, cw, gx, gy
_TAIL = (_INT, _INT, _P)                          # dtype, device, stream
# entry points of csrc/live_bn.cu: name -> (restype, argtypes)
SIGNATURES = {
    "live_bn_sums": (_INT, (_P, _P, _P, _P) + _GEOM + _TAIL),
    "live_bn_sums_bwd": (_INT, (_P, _P, _P) + _GEOM + _TAIL),
    "live_bn_apply": (_INT, (_P, _P, _P, _P, _P) + _GEOM + (_INT,) + _TAIL),
    "live_bn_apply_bwd": (_INT, (_P,) * 9 + _GEOM + (_INT,) + _TAIL),
    "live_bn_error_string": (ctypes.c_char_p, (_INT,)),
}
_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the grid, as csrc/live_bn.cu walks it: blocks of _THREADS threads over at
# most _COLS 16-byte columns, each with at least _MIN_STEPS steps of rows,
# as many blocks as fit on the card at once (a kernel's blocks an SM, by
# its launch bounds)
_THREADS, _COLS, _MIN_STEPS = 512, 8, 8
BLOCKS_PER_SM = {"live_bn_sums": 2, "live_bn_sums_bwd": 2,
                 "live_bn_apply": 2, "live_bn_apply_bwd": 1}

_LIB = None
_SMS = {}        # device index -> SM count, once it passed the Hopper check
_GEOMETRY = {}   # (kernel, m, c, vec, device index) -> (cw, gx, gy)
_TICKETS = {}    # (device index, stream) -> int32 counters, zero between
#                  launches


# ---------------------------------------------------------------------------
# plain versions (f32 arithmetic) — the CPU path and the oracle on the card
# ---------------------------------------------------------------------------

def _c(v):
    """A per-channel vector ``[C]`` as ``[C, 1, 1]`` against NCHW."""
    return v[:, None, None]


def sums_plain(x):
    """``[sum x, sum x*x]`` over N, H and W of the NCHW-shaped ``x``, f32
    ``[2C]``."""
    xf = x.float()
    return torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])


def sums_bwd_plain(x, g):
    """``g_sum + 2 * g_sumsq * x`` in ``x``'s type; ``g`` f32 ``[2C]``."""
    gs, gq = g.split(x.shape[1])
    return (_c(gs) + 2.0 * _c(gq) * x.float()).to(x.dtype)


def apply_plain(x, scale, shift, residual=None, relu=False):
    """``relu?(x * scale + shift [+ residual])`` in f32, rounded once to
    ``x``'s type."""
    y = x.float() * _c(scale) + _c(shift)
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def apply_bwd_plain(dy, x, y, scale, relu, residual):
    """``(dx, dresidual or None, [sum d, sum d*x] f32 [2C])`` with ``d`` the
    upstream gradient, 0 where the ReLU's output ``y`` is <= 0."""
    d = dy.float()
    if relu:
        d = torch.where(y <= 0, 0.0, d)
    dx = (d * _c(scale)).to(x.dtype)
    dres = d.to(dy.dtype) if residual else None
    return dx, dres, torch.cat([d.sum(dim=(0, 2, 3)),
                                (d * x.float()).sum(dim=(0, 2, 3))])


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def check_inputs(x, *same, channels=()):
    """Raise on inputs the kernels do not take: ``x`` and each of ``same``
    NCHW-shaped, channels_last, f32 or bf16, all of one type, shape and
    device; each of ``channels`` contiguous f32 ``[C]`` on that device."""
    if x.dim() != 4:
        raise ValueError("live BN kernel takes NCHW-shaped tensors, got %s"
                         % (tuple(x.shape),))
    if x.dtype not in _CODES:
        raise TypeError("live BN kernel takes f32 or bf16, got %s" % x.dtype)
    for t in (x,) + same:
        if t is not x and (t.dtype, t.shape, t.device) != (
                x.dtype, x.shape, x.device):
            raise ValueError("live BN kernel: %s %s on %s beside %s %s on %s"
                             % (t.dtype, tuple(t.shape), t.device, x.dtype,
                                tuple(x.shape), x.device))
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(
                "live BN kernel: a tensor of shape %s and strides %s is not "
                "channels_last" % (tuple(t.shape), t.stride()))
    for t in channels:
        if (t.dtype, t.shape, t.device) != (torch.float32, x.shape[1:2],
                                            x.device) or t.stride(0) != 1:
            raise ValueError("live BN kernel takes contiguous f32 [%d] "
                             "coefficients on %s, got %s %s on %s"
                             % (x.shape[1], x.device, t.dtype,
                                tuple(t.shape), t.device))


def vector_width(*ts):
    """Elements a thread moves at once: 16 bytes' worth when C is a
    multiple of it and every base is 16-byte aligned, else 1."""
    v = 16 // ts[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in ts)
    return v if ts[0].shape[1] % v == 0 and aligned else 1


def geometry(m, c, vec, slots):
    """``(cw, gx, gy)``: vector columns a block, row blocks, column chunks,
    for ``m`` rows of ``c`` channels moved ``vec`` at a time, with at most
    ``slots`` blocks (the card's SMs times a kernel's blocks an SM): one
    wave of blocks."""
    cv = c // vec
    cw = min(cv, _COLS)
    gy = -(-cv // cw)
    steps = -(-m // (_THREADS // cw))
    gx = max(1, min(-(-steps // _MIN_STEPS), slots // gy))
    return cw, gx, gy


def _library(device):
    """The loaded library, built at the first call; raises off Hopper."""
    global _LIB
    if _LIB is None:
        _LIB = cuda_build.load(SOURCE, SIGNATURES)
    if device.index not in _SMS:
        cuda_build.require_hopper(device)
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _LIB


def _tickets(device, stream, n):
    """The address of ``n`` (or more) zeroed ticket counters of
    ``stream``: the kernels leave them at 0, and launches on one stream do
    not overlap."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return t.data_ptr()


def _launch(kind, x, ptrs, flags=(), reduce=False):
    """Launch ``kind`` over ``x``'s ``[N * H * W, C]`` rows on the current
    stream, the grid chosen by :func:`geometry`; ``ptrs`` are its tensors
    (or None), to which a reduction (``reduce``) adds its scratch and its
    f32 ``[2C]`` output, which it returns."""
    dev = x.device
    lib = _library(dev)
    c = x.shape[1]
    m = x.numel() // c
    vec = vector_width(*[p for p in ptrs if p is not None and p.dim() == 4])
    key = (kind, m, c, vec, dev.index)
    geo = _GEOMETRY.get(key)
    if geo is None:
        geo = _GEOMETRY[key] = geometry(m, c, vec,
                                        _SMS[dev.index] * BLOCKS_PER_SM[kind])
    cw, gx, gy = geo
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = [None if p is None else p.data_ptr() for p in ptrs]
    out = None
    if reduce:
        out = torch.empty(2 * c, dtype=torch.float32, device=dev)
        partials = torch.empty(gx * 2 * c, dtype=torch.float32, device=dev)
        args += [partials.data_ptr(), _tickets(dev, stream, gy),
                 out.data_ptr()]
    rc = getattr(lib, kind)(*args, m, c, vec, cw, gx, gy, *flags,
                            _CODES[x.dtype], dev.index, stream)
    if rc:
        raise RuntimeError("live BN kernel %s failed: CUDA error %d, %s"
                           % (kind, rc, lib.live_bn_error_string(rc).decode()))
    LAUNCHES[kind] += 1
    return out


def _zeros(x):
    return torch.zeros(2 * x.shape[1], dtype=torch.float32, device=x.device)


def _launch_sums(x):
    check_inputs(x)
    if x.numel() == 0:
        return _zeros(x)
    return _launch("live_bn_sums", x, [x], reduce=True)


def _launch_sums_bwd(x, g):
    check_inputs(x)
    if g.shape != (2 * x.shape[1],) or g.dtype != torch.float32:
        raise ValueError("live BN kernel: sums gradient %s %s for %d "
                         "channels" % (g.dtype, tuple(g.shape), x.shape[1]))
    dx = torch.empty_like(x)
    if x.numel():
        _launch("live_bn_sums_bwd", x, [x, g.contiguous(), dx])
    return dx


def _launch_apply(x, scale, shift, residual, relu):
    check_inputs(x, *(() if residual is None else (residual,)),
                 channels=(scale, shift))
    y = torch.empty_like(x)
    if x.numel():
        _launch("live_bn_apply", x, [x, scale, shift, residual, y],
                (int(relu),))
    return y


def _launch_apply_bwd(dy, x, y, scale, relu, residual):
    check_inputs(x, dy, *((y,) if relu else ()), channels=(scale,))
    dx = torch.empty_like(x)
    dres = torch.empty_like(dy) if residual else None
    if x.numel() == 0:
        return dx, dres, _zeros(x)
    sums = _launch("live_bn_apply_bwd", x,
                   [dy, x, y if relu else None, scale, dx, dres],
                   (int(relu),), reduce=True)
    return dx, dres, sums


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA, nothing else
# ---------------------------------------------------------------------------

def _route(x, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError("no live BN kernel for device %s" % x.device)


def sums(x):
    """``[sum x, sum x*x]`` per channel of the NCHW-shaped ``x``, f32
    ``[2C]``."""
    return _route(x, sums_plain, _launch_sums)(x)


def sums_bwd(x, g):
    """The gradient of ``(g * sums(x)).sum()`` w.r.t. ``x``."""
    return _route(x, sums_bwd_plain, _launch_sums_bwd)(x, g)


def apply(x, scale, shift, residual=None, relu=False):
    """``relu?(x * scale + shift [+ residual])`` per channel, in ``x``'s
    type."""
    return _route(x, apply_plain, _launch_apply)(x, scale, shift, residual,
                                                 relu)


def apply_bwd(dy, x, y, scale, relu, residual):
    """``apply``'s backward: ``(dx, dresidual or None, [g_shift,
    g_scale])``; ``y`` is ``apply``'s output (read only with ``relu``)."""
    return _route(x, apply_bwd_plain, _launch_apply_bwd)(dy, x, y, scale,
                                                         relu, residual)


def channels_last(t):
    """``t`` in the kernels' layout on the card (a copy only where it is
    not channels_last already, which the models' tensors are); as it is
    elsewhere."""
    if t.is_cuda and not t.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


class _Sums(torch.autograd.Function):
    """Saves only ``x``; the backward is ``sums_bwd``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sums(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return sums_bwd(x, g)


class _Apply(torch.autograd.Function):
    """Saves ``x``, ``scale`` and, with the ReLU, the output ``y``: the
    tensors the step holds anyway, and no f32 copy."""

    @staticmethod
    def forward(ctx, x, scale, shift, residual, relu):
        y = apply(x, scale, shift, residual, relu)
        ctx.relu, ctx.residual = relu, residual is not None
        ctx.save_for_backward(x, scale, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, y = ctx.saved_tensors
        dx, dres, g = apply_bwd(channels_last(dy), x, y, scale, ctx.relu,
                                ctx.residual)
        g_shift, g_scale = g.split(x.shape[1])
        return dx, g_scale, g_shift, dres, None


def _recorded(*ts):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def bn_sums(x):
    """Differentiable :func:`sums`: f32 ``[sum x, sum x*x]`` ``[2C]`` of the
    NCHW-shaped ``x`` (channels_last on the card)."""
    return _Sums.apply(x) if _recorded(x) else sums(x)


def bn_apply(x, scale, shift, residual=None, relu=False):
    """Differentiable :func:`apply` w.r.t. ``x``, ``scale``, ``shift`` and
    ``residual``: ``relu?(x * scale + shift [+ residual])``, ``scale`` and
    ``shift`` f32 ``[C]``, ``residual`` of ``x``'s type and shape."""
    if _recorded(x, scale, shift, residual):
        return _Apply.apply(x, scale, shift, residual, relu)
    return apply(x, scale, shift, residual, relu)
