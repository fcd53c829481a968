"""Live BN's kernels (``dasac_tpu_torch/ops/live_bn.py``,
``csrc/live_bn.cu``) and the batch-statistics path of ``SyncBatchNorm``
that runs on them.

On the CPU the path runs the kernels' plain versions through the two
autograd Functions; each case holds it against the expression the path
had before the kernels (an f32 copy, two means, the multiply-add, then
``+ residual`` and ``torch.relu``, all in autograd), kept here as the
reference, in f32: the output, the running statistics and the gradients
of x, the weight, the bias and the residual.  Both sides do the same f32
arithmetic, but the gradient of x adds its three terms (the apply's, the
sum's, the sum of squares') in another order, so it is held to 1e-6 of
its largest entry (it lands within 1e-7) and the rest to 1e-5 relative
(they land equal).  The shapes are ragged against the kernels' tiles: C not a multiple of a
block's 64 bf16 channels, N*H*W not a multiple of its 64 rows.

Card-only (``-m gpu``; on a machine without JAX, ``python -m pytest
tests/test_torch_live_bn.py --noconftest -q``): each kernel against its
plain version in bf16 on channels_last at the r101 ABN step's shapes, the
sums bit for bit between two calls and, on small integers (exact in f32),
equal to the plain version's at those shapes and a ragged one, and one ABN
step's launches.
"""

import pytest
import torch

from dasac_tpu_torch.nn.layers import SyncBatchNorm
from dasac_tpu_torch.nn.resnet import Bottleneck
from dasac_tpu_torch.ops import live_bn

SHAPES = [(2, 70, 5, 7), (3, 13, 5, 7)]   # (N, C, H, W)


def _reference(bn, x, residual, relu):
    """The batch-statistics path as it was written before the kernels:
    returns the output, updates ``bn``'s running statistics."""
    xf = x.float()
    dims = (0, 2, 3)
    mean = xf.mean(dim=dims)
    mean_sq = (xf * xf).mean(dim=dims)
    count = x.numel() // x.shape[1]
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    bn._update_running(mean, var, count)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * inv
    out = (x.to(bn.dtype) * inv.to(bn.dtype)[:, None, None]
           + shift.to(bn.dtype)[:, None, None])
    if residual is not None:
        out = out + residual.to(out.dtype)
    return torch.relu(out) if relu else out


def _case(shape, seed):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn(n, h, w, c, generator=g) * 2 + 0.5).permute(0, 3, 1, 2)
    res = torch.randn(n, h, w, c, generator=g).permute(0, 3, 1, 2)
    dy = torch.randn(n, h, w, c, generator=g).permute(0, 3, 1, 2)
    weight = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.1
    return x, res, dy, weight, bias


def _bn(c, weight, bias):
    bn = SyncBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.normal_(0.0, 0.1, generator=torch.Generator()
                                .manual_seed(1))
    return bn


def _run(fn, bn, x, res, dy):
    xg = x.clone().requires_grad_(True)
    rg = None if res is None else res.clone().requires_grad_(True)
    y = fn(bn, xg, rg)
    y.backward(dy)
    return (y.detach(), xg.grad, bn.weight.grad, bn.bias.grad,
            None if rg is None else rg.grad)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_live_path_matches_the_autograd_expression(shape, residual, relu):
    x, res, dy, weight, bias = _case(shape, 0)
    res = res if residual else None
    ours, ref = _bn(shape[1], weight, bias), _bn(shape[1], weight, bias)
    launches = dict(live_bn.LAUNCHES)
    got = _run(lambda bn, xg, rg: bn(xg, False, residual=rg, relu=relu),
               ours, x, res, dy)
    want = _run(lambda bn, xg, rg: _reference(bn, xg, rg, relu), ref, x,
                res, dy)
    assert live_bn.LAUNCHES == launches      # the CPU runs no kernel
    names = ("y", "dx", "dweight", "dbias", "dresidual")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
        elif name == "dx":
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-6 * b.abs().max().item(), msg=name)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(ours, k), getattr(ref, k),
                                   rtol=1e-5, atol=1e-7, msg=k)
    assert int(ours.num_batches_tracked) == int(ref.num_batches_tracked) == 1


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_frozen_path_is_the_multiply_add_then_the_residual_and_relu(
        residual, relu):
    """The frozen branch keeps its ops: bit for bit the bf16 multiply-add,
    then ``torch.relu``; it refuses a residual, which a frozen bottleneck
    adds itself after bn3 and its projection, then the ReLU, as before."""
    x, res, _, weight, bias = _case(SHAPES[0], 1)
    bn = _bn(SHAPES[0][1], weight, bias)
    bn.dtype = torch.bfloat16
    x, res = x.bfloat16(), res.bfloat16()
    with torch.no_grad():
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        shift = bn.bias - bn.running_mean * inv
        want = (x * inv.bfloat16()[:, None, None]
                + shift.bfloat16()[:, None, None])
        if residual:
            with pytest.raises(ValueError, match="no residual"):
                bn(x, True, residual=res, relu=relu)
            block = Bottleneck(8, SHAPES[0][1] // 4, has_downsample=True,
                               dtype=torch.bfloat16)
            xb = torch.randn(2, 8, 5, 7, generator=torch.Generator()
                             .manual_seed(2)).bfloat16()
            got = block(xb, False)
            ds = block.downsample
            out = block.bn3(block.conv3(block.bn2(block.conv2(block.bn1(
                block.conv1(xb), True, relu=True)), True, relu=True)), True)
            assert torch.equal(got, torch.relu(out + ds[1](ds[0](xb), True)))
            return
        got = bn(x, True, relu=relu)
        if relu:
            want = torch.relu(want)
    assert torch.equal(got, want)
    assert int(bn.num_batches_tracked) == 0


def test_plain_versions_agree_with_their_formulas():
    x, res, dy, weight, bias = _case(SHAPES[1], 2)
    c = x.shape[1]
    s = live_bn.sums(x)
    torch.testing.assert_close(s[:c], x.sum(dim=(0, 2, 3)))
    torch.testing.assert_close(s[c:], (x * x).sum(dim=(0, 2, 3)))
    g = torch.randn(2 * c, generator=torch.Generator().manual_seed(3))
    xg = x.clone().requires_grad_(True)
    (g * live_bn.sums(xg)).sum().backward()
    torch.testing.assert_close(live_bn.sums_bwd(x, g), xg.grad)
    y = live_bn.apply(x, weight, bias, res, relu=True)
    torch.testing.assert_close(
        y, torch.relu(x * weight[:, None, None] + bias[:, None, None] + res))
    dx, dres, gs = live_bn.apply_bwd(dy, x, y, weight, True, True)
    d = torch.where(y > 0, dy, 0.0)
    torch.testing.assert_close(dx, d * weight[:, None, None])
    torch.testing.assert_close(dres, d)
    torch.testing.assert_close(gs, torch.cat([d.sum(dim=(0, 2, 3)),
                                              (d * x).sum(dim=(0, 2, 3))]))


@pytest.mark.parametrize("m,c,vec,slots,want", [
    (1_228_800, 64, 8, 264, (8, 264, 1)),   # stem, 12 x 320 x 320, bf16
    (76_800, 1024, 8, 264, (8, 16, 16)),    # layer3's bn3, 12 x 80 x 80
    (76_800, 1024, 8, 132, (8, 8, 16)),     # its apply_bwd, 1 block an SM
    (76_800, 256, 8, 264, (8, 66, 4)),      # layer3's bn1, bn2
    (105, 13, 1, 264, (8, 1, 2)),           # ragged: one element a thread
    (4_096, 8, 4, 264, (2, 2, 1)),          # the tiny arch in f32
])
def test_geometry(m, c, vec, slots, want):
    """(vector columns a block, row blocks, column chunks) on a card of
    132 SMs: one wave of blocks, at least 8 steps of rows a block."""
    assert live_bn.geometry(m, c, vec, slots) == want


def test_kernels_refuse_devices_they_have_no_kernel_for():
    x = torch.zeros(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no live BN kernel"):
        live_bn.sums(x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the r101 ABN step's rows: layer3's bn3, its bn1/bn2, the stem's BN
GPU_SHAPES = [(12, 1024, 80, 80), (12, 256, 80, 80), (12, 64, 320, 320)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _gpu_case(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = _cl((torch.randn(shape, generator=g, device=dev) * 2 + 0.5)
            .bfloat16())
    res = _cl(torch.randn(shape, generator=g, device=dev).bfloat16())
    dy = _cl(torch.randn(shape, generator=g, device=dev).bfloat16())
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    shift = torch.randn(c, generator=g, device=dev) * 0.1
    return x, res, dy, scale, shift


def _one_ulp(a, b, terms):
    """Both sides round to bf16 an f32 value that may differ in its last
    bits (an FMA against a multiply and an add): at most one bf16 ulp
    (2^-7 relative) apart, plus a few f32 ulps (2^-22) of the summed
    magnitude ``terms`` of what was added, where terms cancel."""
    a, b = a.float(), b.float()
    assert ((a - b).abs() <= b.abs() * 2.0 ** -7 + terms * 2.0 ** -22).all()


def _sums_close(a, b, mag):
    """f32 sums of ~1e5-1e6 terms in two orders: within 1e-5 of the sum of
    the terms' magnitudes ``mag`` (about 20 f32 ulps of it)."""
    assert ((a - b).abs() <= 1e-5 * mag).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernels_match_plain_in_bf16_at_the_abn_shapes(cuda, shape):
    x, res, dy, scale, shift = _gpu_case(cuda, shape)
    c = shape[1]
    xf = x.float()
    mag = torch.cat([xf.abs().sum(dim=(0, 2, 3)),
                     (xf * xf).sum(dim=(0, 2, 3))])
    _sums_close(live_bn.sums(x), live_bn.sums_plain(x), mag)
    g = torch.randn(2 * c, device=cuda)
    gs, gq = (v[:, None, None] for v in g.split(c))
    _one_ulp(live_bn.sums_bwd(x, g), live_bn.sums_bwd_plain(x, g),
             gs.abs() + (2 * gq * xf).abs())
    for r in (None, res):
        terms = (xf * scale[:, None, None]).abs() + shift.abs()[:, None, None]
        if r is not None:
            terms = terms + r.float().abs()
        for relu in (False, True):
            y = live_bn.apply(x, scale, shift, r, relu)
            want = live_bn.apply_plain(x, scale, shift, r, relu)
            assert y.is_contiguous(memory_format=torch.channels_last)
            _one_ulp(y, want, terms)
            # the same y on both sides: the mask and dx are then exact
            dx, dres, gs = live_bn.apply_bwd(dy, x, want, scale, relu,
                                             r is not None)
            dx0, dres0, gs0 = live_bn.apply_bwd_plain(dy, x, want, scale,
                                                      relu, r is not None)
            assert torch.equal(dx, dx0)
            assert (dres is None and dres0 is None) or torch.equal(dres,
                                                                   dres0)
            d = dy.float().abs()
            _sums_close(gs, gs0, torch.cat([d.sum(dim=(0, 2, 3)), (
                d * xf.abs()).sum(dim=(0, 2, 3))]))


@pytest.mark.gpu
def test_sums_repeat_bit_for_bit(cuda):
    x, res, dy, scale, _ = _gpu_case(cuda, GPU_SHAPES[0], seed=1)
    assert torch.equal(live_bn.sums(x), live_bn.sums(x))
    y = live_bn.apply(x, scale, scale, res, True)
    a = live_bn.apply_bwd(dy, x, y, scale, True, True)[2]
    b = live_bn.apply_bwd(dy, x, y, scale, True, True)[2]
    assert torch.equal(a, b)


# M = 3 * 37 * 41 = 4551 rows, a multiple neither of a block's 64 rows nor of
# a grid's rows (gx blocks of 8 steps); C = 13 takes the scalar kernels
EXACT_SHAPES = GPU_SHAPES + [(3, 256, 37, 41), (3, 13, 37, 41)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EXACT_SHAPES)
def test_sums_of_small_integers_are_exact(cuda, shape):
    """bf16 integers in [-3, 3]: every partial sum of x, x*x, the masked dy
    and dy*x is an integer under 2^24 (at most 9 * 1.23e6), which f32 holds
    exactly in any order, so each kernel's sums equal the plain version's:
    a row dropped or taken twice moves a channel's sum by a whole number."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dy = (_cl(torch.randint(-3, 4, shape, generator=g, device=cuda)
                 .bfloat16()) for _ in range(2))
    assert torch.equal(live_bn.sums(x), live_bn.sums_plain(x))
    scale = torch.ones(shape[1], device=cuda)
    y = live_bn.apply_plain(x, scale, scale - 1.0, None, True)
    got = live_bn.apply_bwd(dy, x, y, scale, True, False)[2]
    assert torch.equal(got, live_bn.apply_bwd_plain(dy, x, y, scale, True,
                                                    False)[2])


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset", [(13, 0), (16, 1)])
def test_ragged_channels_and_offset_bases_take_the_scalar_kernels(
        cuda, c, offset):
    """C = 13 (no 16-byte vector), or a base one element past 16-byte
    alignment: one element a thread, the same answers."""
    x, res, dy, scale, shift = _gpu_case(cuda, (3, c, 5, 7))
    if offset:
        buf = torch.empty(offset + x.numel(), device=cuda, dtype=x.dtype)
        moved = buf[offset:].view(3, 5, 7, c).permute(0, 3, 1, 2)
        moved.copy_(x)
        x = moved
        assert live_bn.vector_width(x) == 1
    xf = x.float()
    mag = torch.cat([xf.abs().sum(dim=(0, 2, 3)),
                     (xf * xf).sum(dim=(0, 2, 3))])
    _sums_close(live_bn.sums(x), live_bn.sums_plain(x), mag)
    terms = ((xf * scale[:, None, None]).abs() + shift.abs()[:, None, None]
             + res.float().abs())
    y = live_bn.apply(x, scale, shift, res, True)
    _one_ulp(y, live_bn.apply_plain(x, scale, shift, res, True), terms)
    dx, dres, gs = live_bn.apply_bwd(dy, x, y, scale, True, True)
    dx0, dres0, gs0 = live_bn.apply_bwd_plain(dy, x, y, scale, True, True)
    assert torch.equal(dx, dx0) and torch.equal(dres, dres0)
    d = dy.float().abs()
    _sums_close(gs, gs0, torch.cat([d.sum(dim=(0, 2, 3)),
                                    (d * xf.abs()).sum(dim=(0, 2, 3))]))


@pytest.mark.gpu
def test_layouts_the_kernels_do_not_take_raise(cuda):
    x = torch.zeros(2, 8, 4, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        live_bn.sums(x)
    with pytest.raises(TypeError):
        live_bn.sums(_cl(x.half()))


class _MC:
    LR = 2.5e-4
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw,layers", [
    ("tiny", {}, 2),
    ("deeplabv2_resnet101", dict(layers=(1, 1, 1, 1),
                                 dtype=torch.bfloat16), 17)])
def test_abn_step_launches_two_kernels_a_layer_pass(cuda, arch, kw, layers):
    """One ABN step: the source forward (2 launches a live BN: sums,
    apply), its backward (2: apply_bwd, sums_bwd) and the no-grad target
    forward (2)."""
    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    scfg = steps.StepConfig(num_classes=5, crop_hw=(32, 48),
                            src_scale=(0.5, 2.0), src_jitter=0.5,
                            ce_impl="kernel")
    model = build_model(arch, 5, device=cuda, **kw)
    state = create_train_state(model, optim.build_optimizer(_MC, arch,
                                                            model),
                               5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    u8 = dict(generator=g, device=cuda, dtype=torch.uint8)
    batch = (torch.randint(0, 256, (3, 50, 70, 3), **u8),
             torch.randint(0, 5, (3, 50, 70), **u8),
             torch.randint(0, 256, (2, 40, 80, 3), **u8),
             torch.randint(0, 5, (2, 40, 80), **u8))
    step = steps.make_abn_step(scfg, device=cuda)
    step(state, batch, g)       # builds the library outside the count
    before = dict(live_bn.LAUNCHES)
    m = step(state, batch, g)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in m.values())
    grew = {k: live_bn.LAUNCHES[k] - before[k] for k in before}
    assert grew == {"live_bn_sums": 2 * layers, "live_bn_apply": 2 * layers,
                    "live_bn_apply_bwd": layers,
                    "live_bn_sums_bwd": layers}
