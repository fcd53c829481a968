"""Card-only tests of the port: the CUDA CE kernels of
``dasac_tpu_torch/csrc/ce.cu`` (``nll_fwd`` and ``nll_bwd``, bulk and
strided paths) against their plain versions, the autograd path through
them, and the Triton pair kept as a yardstick (``ops/ce_triton.py``).  They
import no JAX, so they also run on a machine that has only PyTorch; there,
skip the JAX-side conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

The ABN frames step on the card is held against its CPU run (the
tolerances of ``chip_smoke.check_abn_agreement``), one ABN step is counted
at 2 ``nll_fwd`` + 1 ``nll_bwd`` launches on the bulk path, and the
inference program's labels are the argmax of its probabilities, which
agree with the CPU's within 1e-5.  The kernels are held against their
plain versions at the VGG ABN step's 16x640x640 rows, one FCN8s SAC step
is counted at 2 + 2 launches on the bulk path, and ``run_inference``'s
exported labels are the argmax of its exported probabilities.  The card's
machine builds the C++ PNG decoder, and a resize-mode batch takes its
native route.  Data parallel: the ABN frames step (shallow r101, f32,
64x64, live BN) in a NCCL world of one rank equals, bit for bit, the same
step with no process group (cuDNN's deterministic algorithms on); two
gloo ranks sharing the card run the tiny arch's ABN frames step on their
shards and end with bit-equal states.

Without a card every test here skips.  Tolerances, absolute: NLL 1e-4 (a
few f32 ulps of values up to ~25), f32 dx 1e-6, bf16 dx one bf16 ulp at 1
(2^-8), since both sides round the same f32 value to bf16.
"""

import json
import os

import pytest
import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.infer import engine
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.ops import ce, ce_triton
from dasac_tpu_torch.sac import core
from dasac_tpu_torch.train import optim, steps
from dasac_tpu_torch.utils.sys_tools import find_free_port

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, shape, dtype, ignore_frac=0.2, c=19, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(*shape, c, generator=g, device=dev) * 3).to(dtype)
    lbl = torch.randint(0, c, shape, generator=g, device=dev,
                        dtype=torch.int32)
    lbl[torch.rand(shape, generator=g, device=dev) < ignore_frac] = ce.IGNORE
    gr = torch.rand(shape, generator=g, device=dev)
    return x, lbl, gr


@pytest.mark.parametrize("shape,c", [((4, 33, 65), 19), ((1, 1, 127), 19),
                                     ((2, 7, 9), 21), ((3, 5, 5), 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, shape, c, dtype):
    x, lbl, gr = _case(cuda, shape, dtype, c=c)
    x2, l1, g1 = x.view(-1, c), lbl.view(-1), gr.view(-1)
    before = dict(ce.LAUNCHES)
    nll = ce.nll_fwd(x2, l1)
    dx = ce.nll_bwd(x2, l1, g1)
    torch.cuda.synchronize()
    assert ce.LAUNCHES["nll_fwd"] == before["nll_fwd"] + 1
    assert ce.LAUNCHES["nll_bwd"] == before["nll_bwd"] + 1
    assert nll.dtype == torch.float32 and dx.dtype == dtype
    torch.testing.assert_close(nll, ce.nll_fwd_plain(x2, l1), rtol=0,
                               atol=1e-4)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(dx.float(),
                               ce.nll_bwd_plain(x2, l1, g1).float(),
                               rtol=0, atol=tol)


def _paths():
    return {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}


def _check_rows(x2, l1, g1, path, dtol=None):
    """Both kernels on these rows against the plain versions; each launch
    counted once on ``path``."""
    before = _paths()
    nll = ce.nll_fwd(x2, l1)
    dx = ce.nll_bwd(x2, l1, g1)
    torch.cuda.synchronize()
    after = _paths()
    for k in ("nll_fwd", "nll_bwd"):
        other = "strided" if path == "bulk" else "bulk"
        assert after[k][path] == before[k][path] + 1, (k, after, before)
        assert after[k][other] == before[k][other], (k, after, before)
    assert nll.dtype == torch.float32 and dx.dtype == x2.dtype
    assert dx.shape == x2.shape and dx.is_contiguous()
    torch.testing.assert_close(nll, ce.nll_fwd_plain(x2, l1), rtol=0,
                               atol=1e-4)
    if dtol is None:
        dtol = 1e-6 if x2.dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(dx.float(),
                               ce.nll_bwd_plain(x2, l1, g1).float(),
                               rtol=0, atol=dtol)


# rows: a ragged N over several 256-row tiles, N under one tile, one row,
# exactly one tile, and more tiles than the persistent grid has blocks
@pytest.mark.parametrize("n", [3 * 256 + 77, 100, 1, 256, 300 * 256 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bulk_path_ragged_rows(cuda, n, dtype):
    x, lbl, gr = _case(cuda, (n,), dtype)
    # f16 tolerance: one f16 ulp at 1 (2^-11) for dx
    dtol = 2.0 ** -11 if dtype == torch.float16 else None
    _check_rows(x, lbl, gr, "bulk", dtol)


def test_zero_rows_launch_nothing(cuda):
    x, lbl, gr = _case(cuda, (0,), torch.float32)
    before, paths = dict(ce.LAUNCHES), _paths()
    assert ce.nll_fwd(x, lbl).shape == (0,)
    assert ce.nll_bwd(x, lbl, gr).shape == (0, 19)
    assert ce.LAUNCHES == before and _paths() == paths


def test_offset_view_takes_the_strided_path(cuda):
    """``x2[1:]`` is contiguous but 76 bytes off a 16-byte boundary."""
    x, lbl, gr = _case(cuda, (1000,), torch.float32)
    assert x[1:].data_ptr() % 16 != 0
    _check_rows(x[1:], lbl[1:], gr[1:], "strided")


def test_transposed_rows_take_the_strided_path(cuda):
    x, lbl, gr = _case(cuda, (700,), torch.float32)
    xt = x.t().contiguous().t()      # [N, C] with strides (1, N)
    _check_rows(xt, lbl, gr, "strided")


@pytest.mark.parametrize("ldtype", [torch.int32, torch.int64])
def test_int64_labels_and_labels_beyond_the_classes(cuda, ldtype):
    """Labels in [19, 254] match no class: nll = lse and dx = g * p."""
    x, lbl, gr = _case(cuda, (5, 256 + 31), torch.float32)
    lbl = lbl.to(ldtype).view(-1)
    lbl[::7] = 19
    lbl[3::7] = 254
    x2, g1 = x.view(-1, 19), gr.view(-1)
    _check_rows(x2, lbl, g1, "bulk")
    _check_rows(x2[1:], lbl[1:], g1[1:], "strided")
    nll = ce.nll_fwd(x2, lbl)
    lse = torch.logsumexp(x2, dim=1)
    torch.testing.assert_close(nll[::7], lse[::7], rtol=0, atol=1e-4)


@pytest.mark.parametrize("path", ["bulk", "strided"])
def test_all_ignored_rows_are_exactly_zero(cuda, path):
    x, lbl, gr = _case(cuda, (4 * 256 + 9,), torch.float32, ignore_frac=1.0)
    if path == "strided":
        x, lbl, gr = x[1:], lbl[1:], gr[1:]
    before = _paths()
    nll = ce.nll_fwd(x, lbl)
    dx = ce.nll_bwd(x, lbl, gr)
    torch.cuda.synchronize()
    assert not nll.any() and not dx.any()
    for k in ("nll_fwd", "nll_bwd"):
        assert ce.PATH_LAUNCHES[k][path] == before[k][path] + 1


def test_label_types_the_kernels_do_not_take_raise(cuda):
    x, lbl, gr = _case(cuda, (300,), torch.float32)
    before = dict(ce.LAUNCHES)
    with pytest.raises(TypeError, match="int32 or int64"):
        ce.nll_fwd(x, lbl.to(torch.uint8))
    with pytest.raises(TypeError, match="int32 or int64"):
        ce.nll_bwd(x, lbl.to(torch.int16), gr)
    assert ce.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triton_yardstick_matches_plain(cuda, dtype):
    x, lbl, gr = _case(cuda, (3 * 256 + 77,), dtype)
    before = dict(ce_triton.LAUNCHES)
    nll = ce_triton.nll_fwd(x, lbl)
    dx = ce_triton.nll_bwd(x, lbl, gr)
    torch.cuda.synchronize()
    assert ce_triton.LAUNCHES["nll_fwd"] == before["nll_fwd"] + 1
    assert ce_triton.LAUNCHES["nll_bwd"] == before["nll_bwd"] + 1
    torch.testing.assert_close(nll, ce.nll_fwd_plain(x, lbl), rtol=0,
                               atol=1e-4)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(dx.float(),
                               ce.nll_bwd_plain(x, lbl, gr).float(),
                               rtol=0, atol=tol)


def test_all_ignored_is_zero(cuda):
    x, lbl, gr = _case(cuda, (2, 9, 31), torch.float32, ignore_frac=1.0)
    x = x.requires_grad_(True)
    nll = ce.nll_fused(x, lbl)
    (nll * gr).sum().backward()
    torch.cuda.synchronize()
    assert not nll.any() and not x.grad.any()


def test_strided_rows_are_read_in_place(cuda):
    """A class-sliced view is viewable as rows with a row stride of 40: the
    kernel reads it with the strides it is given (the strided path),
    without a copy."""
    x, lbl, gr = _case(cuda, (2, 6, 8), torch.float32, c=40)
    xs = x[..., :19]
    before = _paths()
    ref = ce.nll_fwd_plain(xs.reshape(-1, 19), lbl.view(-1).clamp(max=18))
    got = ce.nll_fused(xs, lbl.clamp(max=18))
    torch.testing.assert_close(got.view(-1), ref, rtol=0, atol=1e-4)
    assert ce.PATH_LAUNCHES["nll_fwd"]["strided"] == \
        before["nll_fwd"]["strided"] + 1
    assert ce.PATH_LAUNCHES["nll_fwd"]["bulk"] == before["nll_fwd"]["bulk"]
    _check_rows(xs.reshape(-1, 19), lbl.view(-1).clamp(max=18),
                gr.view(-1), "strided")


def test_unviewable_layout_raises(cuda):
    x = torch.randn(2, 19, 6, 8, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="without a copy"):
        ce.nll_fused(x, torch.zeros(2, 6, 8, dtype=torch.int32, device=cuda))


def test_inputs_the_kernels_do_not_take_raise(cuda):
    x, lbl, gr = _case(cuda, (2, 3, 5), torch.float32)
    x2, l1 = x.view(-1, 19), lbl.view(-1)
    with pytest.raises(TypeError, match="integer labels"):
        ce.nll_fwd(x2, l1.float())
    with pytest.raises(ValueError, match="per-row input"):
        ce.nll_fwd(x2, l1[:-1])
    with pytest.raises(ValueError, match="per-row input"):
        ce.nll_bwd(x2, l1, gr.view(-1)[:-1])
    with pytest.raises(ValueError, match="on cuda"):
        ce.nll_fwd(x2, l1.cpu())


@pytest.mark.parametrize("use_conf", [True, False])
def test_losses_through_the_kernels_match_plain_formula(cuda, use_conf):
    x, lbl, gr = _case(cuda, (4, 17, 23), torch.float32, seed=1)
    conf = torch.rand(lbl.shape, device=cuda)
    rc = torch.rand(19, device=cuda) * 0.1
    grads = {}
    for impl in ("kernel", "logsoftmax"):
        xi = x.clone().requires_grad_(True)
        src = core.cross_entropy_mean(xi, lbl, impl=impl)
        tgt, per_class = core.focal_ce(xi, lbl, conf, rc, use_conf=use_conf,
                                       impl=impl)
        (src + tgt).backward()
        grads[impl] = (src.detach(), tgt.detach(), per_class, xi.grad)
    for a, b in zip(grads["kernel"], grads["logsoftmax"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the ABN step and the inference program on the card
# ---------------------------------------------------------------------------

class _MC:
    LR = 2.5e-4
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


def test_abn_frames_step_matches_cpu(cuda):
    import chip_smoke

    out = chip_smoke.check_abn_agreement(cuda)
    assert out["iterations"] == 2


def test_abn_step_launches_two_forward_one_backward_on_the_bulk_path(cuda):
    scfg = steps.StepConfig(num_classes=5, crop_hw=(32, 48),
                            src_scale=(0.5, 2.0), src_jitter=0.5,
                            ce_impl="kernel")
    model = build_model("tiny", 5, device=cuda)
    state = create_train_state(model, optim.build_optimizer(_MC, "tiny",
                                                            model),
                               5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = (torch.randint(0, 256, (3, 50, 70, 3), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 5, (3, 50, 70), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 256, (2, 40, 80, 3), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 5, (2, 40, 80), generator=g, device=cuda,
                           dtype=torch.uint8))
    step = steps.make_abn_step(scfg, device=cuda)
    step(state, batch, g)       # builds the library outside the count
    before, paths = dict(ce.LAUNCHES), _paths()
    m = step(state, batch, g)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in m.values())
    assert ce.LAUNCHES["nll_fwd"] == before["nll_fwd"] + 2
    assert ce.LAUNCHES["nll_bwd"] == before["nll_bwd"] + 1
    after = _paths()
    assert after["nll_fwd"]["bulk"] == paths["nll_fwd"]["bulk"] + 2
    assert after["nll_bwd"]["bulk"] == paths["nll_bwd"]["bulk"] + 1
    assert all(after[k]["strided"] == paths[k]["strided"] for k in after)


@pytest.mark.parametrize("kw", [dict(scales=(1.0,)),
                                dict(scales=(0.75, 1.0), flip=True),
                                dict(scales=(0.75, 1.0, 1.25), flip=True,
                                     fuse="stride8")])
def test_infer_labels_are_the_argmax_of_probs(cuda, kw):
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    model = build_model("tiny", 19, device=cuda)
    img = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    probs = engine.make_infer_fn(model, mean, std, device=cuda, **kw)(img)
    labels = engine.make_infer_fn(model, mean, std, output="argmax",
                                  device=cuda, **kw)(img)
    assert labels.dtype == torch.uint8 and labels.shape == (2, 64, 96)
    differ = probs.argmax(-1).to(torch.uint8) != labels
    top2 = probs[differ].topk(2, dim=-1).values
    assert bool((top2[:, 0] == top2[:, 1]).all())
    model_cpu = build_model("tiny", 19, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    ref = engine.make_infer_fn(model_cpu, mean, std, device="cpu", **kw)(img)
    torch.testing.assert_close(probs.cpu(), ref, rtol=0, atol=1e-5)


def test_kernels_match_plain_at_the_vgg_abn_rows(cuda):
    """16x640x640 rows (6,553,600), 10% ignored plus 80 rows of crop
    padding per image: the VGG ABN step's source loss."""
    x, lbl, gr = _case(cuda, (16, 640, 640), torch.float32, ignore_frac=0.1)
    lbl[:, -80:] = ce.IGNORE
    _check_rows(x.view(-1, 19), lbl.view(-1), gr.view(-1), "bulk")


def test_fcn_sac_step_launches_two_forward_two_backward_on_the_bulk_path(
        cuda):
    scfg = steps.StepConfig(num_classes=19, crop_hw=(64, 96), group_size=2,
                            run_conf_lower=0.01, ce_impl="kernel",
                            refine_dtype="bfloat16", refine_res="stride8")
    model = build_model("fcn_vgg16_bn", 19, dtype=torch.bfloat16,
                        device=cuda)
    state = create_train_state(model, optim.build_optimizer(
        _MC, "fcn_vgg16_bn", model), 19, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = (torch.randint(0, 256, (2, 80, 120, 3), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 19, (2, 80, 120), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 256, (1, 64, 96, 3), generator=g, device=cuda,
                           dtype=torch.uint8),
             torch.randint(0, 19, (1, 64, 96), generator=g, device=cuda,
                           dtype=torch.uint8))
    step = steps.make_sac_step(scfg, device=cuda)
    step(state, batch, g)       # builds the library outside the count
    before, paths = dict(ce.LAUNCHES), _paths()
    m = step(state, batch, g)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in m.values())
    for k in ("nll_fwd", "nll_bwd"):
        assert ce.LAUNCHES[k] == before[k] + 2
        assert _paths()[k] == {"bulk": paths[k]["bulk"] + 2,
                               "strided": paths[k]["strided"]}


def test_run_inference_labels_are_the_argmax_of_its_raw_probs(cuda,
                                                               tmp_path):
    import os

    import numpy as np

    from dasac_tpu_torch.data import png
    from dasac_tpu_torch.data.synth import make_synthetic_root

    root = make_synthetic_root(str(tmp_path / "root"), hw=(64, 96), n_val=2)
    model = build_model("tiny", 19, device=cuda)
    ds = engine.InferDataset(root, "val_cityscapes")
    out = str(tmp_path / "out")
    conf = engine.run_inference(model, ds, out, mean=(0.485, 0.456, 0.406),
                                std=(0.229, 0.224, 0.225), save_raw=True,
                                verbose=False, device=cuda)
    assert conf.shape == (19, 19) and conf.sum() > 0
    for i in range(len(ds)):
        name = ds.name(i)
        labels = png.read(os.path.join(out, name + ".png")).pixels
        raw = np.load(os.path.join(out, "raw", name + ".npz"))["raw"]
        # the labels come from the f32 probabilities, the file holds them
        # rounded to f16: they differ only where f16 ties the top two
        differ = raw.argmax(-1) != labels
        top2 = np.sort(raw[differ].astype(np.float32), axis=-1)[:, -2:]
        assert (top2[:, 0] == top2[:, 1]).all()
        assert differ.mean() < 0.01


def test_resize_batches_take_the_native_route_on_the_card_host(cuda,
                                                               tmp_path):
    """The card's machine builds the C++ decoder (g++, zlib) and the loader
    decodes a resize-mode batch of Paeth and Average PNGs through it."""
    import numpy as np

    from dasac_tpu_torch.data import host_loader, native, png

    rng = np.random.RandomState(0)
    images, masks = [], []
    for i, filt in enumerate((4, 3, 4)):
        images.append(str(tmp_path / ("i%d.png" % i)))
        masks.append(str(tmp_path / ("m%d.png" % i)))
        png.write(images[-1], (rng.rand(48, 80, 3) * 255).astype(np.uint8),
                  filt)
        png.write(masks[-1], rng.randint(0, 19, (48, 80)).astype(np.uint8),
                  filt)
    ds = host_loader.SegDataset(images, masks, (24, 40), "resize")
    flag, before = native.enabled(), dict(native.PATH_DECODES)
    native.set_enabled(True)
    try:
        batch = ds.load_batch([0, 1, 2, -1], threads=2)
    finally:
        native.set_enabled(flag)
    assert {k: native.PATH_DECODES[k] - before[k] for k in before} == {
        "native": 3, "python": 0}
    for (img, mask), i in zip(batch[:3], range(3)):
        want = png.to_mask(png.read(masks[i]))[1::2, 1::2]
        assert img.shape == (24, 40, 3)
        np.testing.assert_array_equal(mask, want)


def _abn_frames(dev, n, hw, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    src_y = torch.randint(0, 19, (n, *hw), generator=g, device=dev,
                          dtype=torch.int32)
    tgt_y = torch.randint(0, 19, (n, *hw), generator=g, device=dev,
                          dtype=torch.int32)
    return (torch.randn(n, *hw, 3, generator=g, device=dev), src_y,
            torch.randn(n, *hw, 3, generator=g, device=dev), tgt_y)


def _abn_state(arch, dev, group, **kw):
    model = build_model(arch, 19, device=dev, group=group,
                        generator=torch.Generator().manual_seed(0), **kw)
    return create_train_state(
        model, optim.build_optimizer(_MC, arch, model), 19, device=dev)


def test_one_rank_nccl_step_equals_the_step_without_a_group(cuda,
                                                            monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    scfg = steps.StepConfig(num_classes=19, crop_hw=(64, 64),
                            ce_impl="kernel")
    frames = _abn_frames(cuda, 2, (64, 64), 0)
    dist.init(dist.Launch("127.0.0.1:%d" % find_free_port(), 1, 0),
              torch.device("cuda", 0))
    try:
        runs = []
        for group in (dist.group(), None):
            state = _abn_state("deeplabv2_resnet101", cuda, group,
                               layers=(1, 1, 1, 1))
            calls = dict(dist.CALLS)
            m = steps.make_abn_frames_step(scfg, group=group)(state,
                                                              *frames)
            runs.append((m, state.model.state_dict(),
                         {k: dist.CALLS[k] - calls[k] for k in calls}))
    finally:
        dist.destroy()
    (m_g, sd_g, calls_g), (m_p, sd_p, calls_p) = runs
    # 17 BN layers: two batch-statistics passes forward, one backward
    assert calls_g["bn"] == 34 and calls_g["bn_grad"] == 17
    assert calls_g["mean"] == 2 and not any(calls_p.values())
    for k in m_p:
        assert torch.equal(m_g[k], m_p[k]), k
    for k in sd_p:
        assert torch.equal(sd_g[k], sd_p[k]), k


def _gloo_rank(rank, addr, out_dir):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init(dist.Launch(addr, 2, rank, rank), dev, backend="gloo")
    try:
        state = _abn_state("tiny", dev, dist.group())
        frames = [t[2 * rank:2 * rank + 2]
                  for t in _abn_frames(dev, 4, (64, 64), 1)]
        m = steps.make_abn_frames_step(
            steps.StepConfig(num_classes=19, crop_hw=(64, 64),
                             ce_impl="kernel"), group=dist.group())(
            state, *frames)
        n = dist.assert_replicas_equal(
            dist.state_tensors(state, dev, group=dist.group()), dev,
            dist.group())
    finally:
        dist.destroy()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(dict(equal=n, losses={k: float(v) for k, v in m.items()}),
                  f)


def test_two_gloo_ranks_on_one_card_end_equal(cuda, tmp_path):
    torch.multiprocessing.spawn(
        _gloo_rank, args=("127.0.0.1:%d" % find_free_port(),
                          str(tmp_path)), nprocs=2, join=True)
    out = [json.loads((tmp_path / ("rank%d.json" % r)).read_text())
           for r in range(2)]
    assert out[0]["equal"] == out[1]["equal"] > 0
    # the losses are averaged over the ranks: the same on both
    assert out[0]["losses"] == out[1]["losses"]
