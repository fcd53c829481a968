"""SegFormer-B5 (``dasac_tpu_torch/nn/segformer.py``) against its plain
reference (``benchmark/reference/archs/segformer_b5.py``) on the CPU in
float32, on a small MiT: widths (16, 32, 40, 64), heads (1, 2, 5, 8),
depths (1, 1, 2, 1), ratios (8, 4, 2, 1), a 32-wide head, 64x128 frames,
seeded weights from the benchmark's own draw (``benchmark/inputs.py``) and
the head's BN statistics moved off 0 and 1:

  * the logits at stride 4 and upsampled to the frame equal the
    reference's;
  * with ``train=True`` and one generator seed on both sides (so also the
    stochastic-depth and dropout draws, in the same order), the input's
    and every parameter's gradient equal the reference's; ``remat
    "block"`` gives the gradients of ``"none"``; the teacher's forward
    draws nothing;
  * a deep copy of the model starts without the original's graphs;
  * the reference's state dict loads into the port with ``strict=True``,
    and the port's into the reference, with the same keys in the same
    order; at full size the model has SegFormer-B5's 84,607,955
    parameters at 19 classes under the official keys;
  * ``ATTENTION`` counts the calls and the ``B x heads x Nq x Nkv`` pairs
    of the formula; the plain attention of the CPU equals
    ``F.scaled_dot_product_attention``;
  * one ``make_sac_step`` step (logits at stride 4, the refine at their
    grid) and one ``infer/engine.make_infer_fn`` call run and are finite;
  * on the card (``gpu``; skipped here), the blocks' branches replayed
    from CUDA graphs (``nn/graphs.py``) give the eager model's outputs,
    gradients and attention counts over two passes with gradients
    accumulated, a teacher's no-grad passes under other weights, and two
    forwards before one backward (the second runs eagerly).

Tolerances: the port and the reference run the same float32 operations
in the same order on the CPU (the port's plain attention there is the
reference's formula), so forward and backward agree to a few float32
ulps, ``rtol 1e-5 / atol 1e-6``; ``remat "block"`` replays the same
operations, exactly.  On the card, in float32 without TF32, graphs and
eager run the same kernels, but the attention's backward and the weight
gradients add with atomics in no fixed order, and single elements that
cancel differ by up to 1.5e-4 of themselves (the first patch embedding's
weight gradient, on the card): each tensor within 1e-4 of its norm, where
a stale or misrouted replay is off by its whole size.  Against ``F.scaled_dot_product_attention``, whose
CPU kernel sums in other blocks: ``rtol 1e-5 / atol 1e-6`` on values of
order 1.  ~10 s on one core.
"""

import copy
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference.archs import segformer_b5 as ref_arch
from benchmark.reference.layers import REFERENCE, init_spec
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.infer import engine
from dasac_tpu_torch.nn import graphs, segformer
from dasac_tpu_torch.nn.factory import build_model, new_param_scopes
from dasac_tpu_torch.tools import flagship
from dasac_tpu_torch.train import optim, steps

C = 19
CPU = torch.device("cpu")
SMALL = dict(widths=(16, 32, 40, 64), heads=(1, 2, 5, 8), depths=(1, 1, 2, 1),
             sr_ratios=(8, 4, 2, 1), head_width=32)
HW = (64, 128)
TOL = dict(rtol=1e-5, atol=1e-6)


def _weights(seed=11):
    """The reference's state dict drawn as the benchmark draws it, with
    the head's BN statistics and affine moved off their starts."""
    ref = ref_arch.Model(C, **SMALL)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in
              ref.state_dict().items()}
    w = inputs.make_weights(init_spec(ref), shapes, seed, CPU)
    g = torch.Generator().manual_seed(seed)
    pre = "decode_head.linear_fuse.bn."
    n = w[pre + "weight"].numel()
    w[pre + "running_mean"] = 0.2 * torch.randn(n, generator=g)
    w[pre + "running_var"] = 0.5 + torch.rand(n, generator=g)
    w[pre + "weight"] = 1.0 + 0.1 * torch.randn(n, generator=g)
    return w


def _pair(remat="none"):
    w = _weights()
    ref = ref_arch.Model(C, **SMALL)
    ref.load_state_dict(w, strict=True)
    port = build_model("segformer_b5", C, remat=remat, device=CPU, **SMALL)
    port.load_state_dict(w, strict=True)
    return port, ref


def _frames(seed=0, b=2):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        b, *HW, 3).astype(np.float32))


def test_logits_equal_the_reference():
    port, ref = _pair()
    x = _frames()
    with torch.no_grad():
        got, want = port(x), ref(x, REFERENCE)
    assert got[0].shape == (2, HW[0] // 4, HW[1] // 4, C)
    assert got[1].shape == (2, *HW, C) and got[1].dtype == torch.float32
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    assert want[0].std() > 1e-3        # the logits are not vanishing


def _grads(model, x, call):
    x = x.clone().requires_grad_(True)
    logits, up = call(model, x)
    g = torch.Generator().manual_seed(5)
    (up * torch.randn(up.shape, generator=g)).sum().backward()
    return x.grad, {k: p.grad for k, p in model.named_parameters()}


def test_gradients_and_draws_equal_the_reference():
    port, ref = _pair()
    x = _frames(1)
    gx, gp = _grads(port, x, lambda m, x: m(
        x, train=True, generator=torch.Generator().manual_seed(3)))
    rx, rp = _grads(ref, x, lambda m, x: m(
        x, REFERENCE, train=True, generator=torch.Generator().manual_seed(3)))
    torch.testing.assert_close(gx, rx, **TOL)
    assert set(gp) == set(rp)
    for k in gp:
        torch.testing.assert_close(gp[k], rp[k], **TOL, msg=k)
    # another seed draws other masks: the draws reach the gradients
    ox, _ = _grads(port, x, lambda m, x: m(
        x, train=True, generator=torch.Generator().manual_seed(4)))
    assert not torch.allclose(ox, gx, **TOL)


def test_remat_block_replays_the_same_gradients():
    x = _frames(2)
    out = []
    for remat in ("none", "block"):
        port, _ = _pair(remat)
        out.append(_grads(port, x, lambda m, x: m(
            x, train=True, generator=torch.Generator().manual_seed(3))))
    (ax, ap), (bx, bp) = out
    assert torch.equal(ax, bx)
    for k in ap:
        assert torch.equal(ap[k], bp[k]), k
    with pytest.raises(ValueError):
        build_model("segformer_b5", C, remat="convs", device=CPU, **SMALL)


def test_the_teacher_draws_nothing():
    port, _ = _pair()
    g = torch.Generator().manual_seed(9)
    before = g.get_state()
    with torch.no_grad():
        port(_frames(), train=False, generator=g)
    assert torch.equal(g.get_state(), before)


def test_state_dicts_load_both_ways_under_the_official_keys():
    port, ref = _pair()
    assert list(port.state_dict()) == list(ref.state_dict())
    ref.load_state_dict(port.state_dict(), strict=True)
    port.load_state_dict(ref.state_dict(), strict=True)
    assert new_param_scopes("segformer_b5") == ref_arch.NEW_SCOPES
    with torch.device("meta"):
        full = build_model("segformer_b5", C, device="meta")
    keys = full.state_dict()
    assert sum(p.numel() for p in full.parameters()) == 84607955
    for k in ("backbone.patch_embed1.proj.weight",
              "backbone.block3.17.attn.sr.weight",
              "backbone.block1.0.mlp.dwconv.dwconv.weight",
              "backbone.norm4.weight", "decode_head.linear_c1.proj.weight",
              "decode_head.linear_fuse.conv.weight",
              "decode_head.linear_fuse.bn.running_var",
              "decode_head.linear_pred.bias"):
        assert k in keys, k
    assert "backbone.block4.0.attn.sr.weight" not in keys   # ratio 1
    assert len(full.backbone.block3) == 40
    assert keys["backbone.block2.0.mlp.dwconv.dwconv.weight"].shape == (
        512, 1, 3, 3)


def test_the_attention_counter_follows_the_formula():
    port, _ = _pair()
    b = 2
    calls0, pairs0 = segformer.ATTENTION["calls"], segformer.ATTENTION[
        "pairs"]
    with torch.no_grad():
        port(_frames(b=b))
    h, w = HW[0] // 4, HW[1] // 4
    want = 0
    for i, (heads, n, r) in enumerate(zip(SMALL["heads"], SMALL["depths"],
                                          SMALL["sr_ratios"])):
        hi, wi = h >> i, w >> i
        want += n * b * heads * (hi * wi) * ((hi // r) * (wi // r))
    assert segformer.ATTENTION["calls"] - calls0 == sum(SMALL["depths"])
    assert segformer.ATTENTION["pairs"] - pairs0 == want


@pytest.mark.parametrize("shape", [(2, 1, 512, 64), (2, 5, 128, 8)])
def test_the_plain_attention_equals_sdpa(shape):
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(shape, generator=g) for _ in range(2))
    v = torch.randn(shape[:2] + (shape[2] // 4, shape[3]), generator=g)
    k = k[:, :, :shape[2] // 4]
    torch.testing.assert_close(segformer.attend(q, k, v),
                               F.scaled_dot_product_attention(q, k, v), **TOL)


def test_a_sac_step_and_an_inference_call_run_at_stride_4():
    model = build_model("segformer_b5", C, device=CPU,
                        generator=torch.Generator().manual_seed(0), **SMALL)
    state = create_train_state(
        model, optim.build_optimizer(flagship.ModelCfg, "segformer_b5",
                                     model), C, device=CPU)
    scfg = steps.StepConfig(num_classes=C, crop_hw=HW, group_size=2,
                            lr_target=5.0, refine_dtype="bfloat16",
                            refine_res="stride8", ce_impl="logsoftmax")
    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(a) for a in (
        (rng.rand(2, 80, 160, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (2, 80, 160)).astype(np.uint8),
        (rng.rand(1, *HW, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (1, *HW)).astype(np.uint8)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = steps.make_sac_step(scfg, CPU)(state, batch,
                                       torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v).all() for v in m.values())
    moved = [k for k, v in model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert "backbone.block3.1.attn.kv.weight" in moved
    fn = engine.make_infer_fn(model, (0.5,) * 3, (0.2,) * 3,
                              scales=(0.75, 1.0), flip=True,
                              output="argmax", device=CPU)
    labels = fn(torch.from_numpy((rng.rand(1, *HW, 3) * 255).astype(
        np.uint8)))
    assert labels.shape == (1, *HW)
    assert int(labels.min()) >= 0 and int(labels.max()) < C


def test_a_deep_copy_starts_without_the_originals_graphs():
    """A copy's weights live elsewhere, so it captures its own graphs (a
    captured pass holds streams and graphs, which do not copy)."""
    port, _ = _pair()
    port.backbone.graph_passes.passes["captured"] = threading.Lock()
    twin = copy.deepcopy(port)
    assert twin.backbone.graph_passes.passes == {}
    assert twin.backbone.graph_passes.limit == segformer.GRAPH_PASSES
    assert "captured" in port.backbone.graph_passes.passes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _passes_of(model, dev, x):
    """Two passes with gradients accumulated, two teacher passes under
    other weights, then two forwards before one backward; returns what
    each gave by name and the attention calls a pass."""
    w = {k: (v * 1.01 if v.is_floating_point() else v)
         for k, v in model.state_dict().items()}
    out, calls = {}, []
    for k in range(2):
        xk = (x * (k + 1)).requires_grad_(True)
        n = segformer.ATTENTION["calls"]
        _, up = model(xk, train=True,
                      generator=torch.Generator(dev).manual_seed(3 + k))
        calls.append(segformer.ATTENTION["calls"] - n)
        (up * up.detach().sin()).sum().backward()
        out["up%d" % k], out["x.grad%d" % k] = up.detach(), xk.grad
    out.update(("2 passes' " + k, p.grad.clone())
               for k, p in model.named_parameters())
    with torch.no_grad():
        for k in range(2):
            out["teacher%d" % k] = torch.func.functional_call(
                model, w, (x,))[1]
    model.zero_grad(set_to_none=True)
    g = torch.Generator(dev).manual_seed(5)
    a = model(x, train=True, generator=g)[1].sum()
    b = model(2 * x, train=True, generator=g)[1].sum()
    (a + 2 * b).backward()
    out["a"], out["b"] = a.detach(), b.detach()
    out.update(("2 forwards' " + k, p.grad)
               for k, p in model.named_parameters())
    return out, calls


@pytest.mark.gpu
def test_graphed_branches_replay_the_eager_ones(cuda):
    w = _weights()
    got = {}
    for graphed in (False, True):
        model = build_model("segformer_b5", C, device=cuda, **SMALL)
        model.load_state_dict(w, strict=True)
        if not graphed:
            model.backbone.graph_passes = graphs.Passes(0)
        got[graphed] = _passes_of(model, cuda, _frames(1).to(cuda))
    passes = model.backbone.graph_passes.passes
    # the student's pass with gradients and the teacher's without, each of
    # the 5 blocks' 2 branches graphed
    assert len(passes) == 2
    assert all(len(p.branches) == 10 for p in passes.values())
    assert got[True][1] == got[False][1] == [5, 5]
    for k, v in got[False][0].items():
        gap = float((got[True][0][k] - v).norm())
        assert gap <= 1e-4 * float(v.norm()) + 1e-6, (k, gap, float(v.norm()))
