"""The port's ABN (source-only baseline) step and its config slice against
dasac_tpu on the CPU.

``make_abn_frames_step`` of both packages runs 3 iterations on identical
pre-augmented frames and identical weights (carried across with
``train_state_from_jax``): live BN on the source pass, an SGD step (four
LR groups, momentum, weight decay), then a no-grad target pass that only
refreshes the BN statistics.  The model is a shallow full-width ResNet
(``layers=(1,1,1,1)`` + ASPP, 2048 trunk channels) in f32 with randomized
BN affine parameters, 64x64 crops.  Both CE implementations run: the
Pallas kernel against the port's kernel wrapper, the XLA formula against
the plain log-softmax.

Tolerances: ``src_loss_ce`` and ``loss_ce`` rtol 2e-4 (as
tests/test_torch_step.py); BN running statistics and parameters after each
step rtol 1e-3 / atol 1e-5, at the YAML's learning rate (2.5e-4); each
parameter's update of every step (-lr times the momentum buffer: gradient
plus decay, plus 0.9 times the last buffer from the second step on; each
side's parameters after the step less its own before it) within a relative
norm error of 5e-2.  The BN scales' gradients are ill-conditioned at this
size (live BN over 2x8x8 stride-8 pixels, each followed through ReLU and a
conv by another batch-statistics BN, so their gradients are sums of terms
that nearly cancel): scaling the source frames by 1 + 1e-6 noise moves the
JAX step's own first update by up to 2.9%, and the port differs from JAX
by up to 2.3%.  (At 32x48 crops, 2x4x6 pixels, the same figures are 4.7%
and 2.7%, and single weights drift past atol 1e-5 by the second step.)
The teacher tensors stay exactly unchanged.  ``renorm_stats`` and
``step_config_from_cfg`` equal the JAX ones exactly, field by field.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.core.config import cfg, cfg_from_file
from dasac_tpu.core.state import TrainState as JState
from dasac_tpu.train import optim as joptim
from dasac_tpu.train import steps as jsteps
from dasac_tpu_torch.aug import pipelines as tpipe
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import from_jax_variables, train_state_from_jax
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train import steps as tsteps
from tests.test_torch_nn import ShallowDeepLab, _randomize_stats

ARCH = "deeplabv2_resnet101"
C = 19
H, W = 64, 64
B_SRC, B_TGT = 2, 2
ITERS = 3


class _MC:
    LR = 2.5e-4     # configs/deeplabv2_resnet101.yaml
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    frames = []
    for _ in range(ITERS):
        src_x = rng.randn(B_SRC, H, W, 3).astype(np.float32)
        src_y = rng.randint(0, C, (B_SRC, H, W)).astype(np.int32)
        src_y[:, -6:] = 255
        tgt_x = (rng.randn(B_TGT, H, W, 3) * 0.8 + 0.2).astype(np.float32)
        tgt_y = rng.randint(0, C, (B_TGT, H, W)).astype(np.int32)
        tgt_y[:, :4] = 255
        frames.append((src_x, src_y, tgt_x, tgt_y))
    variables = jax.jit(lambda k: ShallowDeepLab(layers=(1, 1, 1, 1)).init(
        {"params": k}, jnp.zeros((1, H, W, 3))))(jax.random.PRNGKey(0))
    return _randomize_stats(variables, 1), frames


def _sd(params=None, stats=None):
    v = {}
    if params is not None:
        v["params"] = jax.tree.map(np.asarray, params)
    if stats is not None:
        v["batch_stats"] = jax.tree.map(np.asarray, stats)
    return {k: t for k, t in from_jax_variables(v, ARCH).items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("jax_impl,port_impl", [("pallas", "kernel"),
                                                ("xla", "logsoftmax")])
def test_abn_frames_step_matches_jax_for_three_iterations(inputs, jax_impl,
                                                          port_impl):
    variables, frames = inputs
    jmodel = ShallowDeepLab(num_classes=C, layers=(1, 1, 1, 1))
    params, stats = variables["params"], variables["batch_stats"]
    tx, _ = joptim.build_optimizer(_MC, ARCH, params)
    jstate = JState(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        teacher_params=jax.tree.map(jnp.asarray, params),
        teacher_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(params), running_conf=jnp.zeros((C,), jnp.float32),
        slow_init=jnp.zeros((), jnp.float32), step=jnp.zeros((), jnp.int32))

    model = build_model(ARCH, C, device="cpu", layers=(1, 1, 1, 1))
    state = create_train_state(model, toptim.build_optimizer(_MC, ARCH, model),
                               C, device="cpu")
    train_state_from_jax(
        dict(params=params, batch_stats=stats, teacher_params=params,
             teacher_stats=stats, running_conf=np.zeros(C, np.float32),
             slow_init=0.0, step=0), ARCH, state)
    teacher0 = {k: v.clone() for k, v in {**state.teacher_params,
                                          **state.teacher_stats}.items()}
    counts0 = {k: int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}

    jstep = jax.jit(jsteps.make_abn_frames_step(
        jmodel, tx, jsteps.StepConfig(num_classes=C, crop_hw=(H, W),
                                      ce_impl=jax_impl)))
    tstep = tsteps.make_abn_frames_step(
        tsteps.StepConfig(num_classes=C, crop_hw=(H, W), ce_impl=port_impl))
    for it, (src_x, src_y, tgt_x, tgt_y) in enumerate(frames):
        prev_ours = {k: v.detach().clone() for k, v in
                     model.named_parameters()}
        prev_ref = _sd(params=jstate.params)
        jstate, jm = jstep(jstate, *map(jnp.asarray, (src_x, src_y, tgt_x,
                                                      tgt_y)),
                           jax.random.PRNGKey(it))
        tm = tstep(state, *map(torch.from_numpy, (src_x, src_y, tgt_x,
                                                  tgt_y)))
        msg = "iter %d " % it
        for k in ("src_loss_ce", "loss_ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                       atol=1e-6, err_msg=msg + k)
        ours = {k: v.detach().clone() for k, v in
                {**dict(model.named_parameters()),
                 **dict(model.named_buffers())}.items()}
        ref = {**_sd(params=jstate.params), **_sd(stats=jstate.batch_stats)}
        for name, r in ref.items():
            np.testing.assert_allclose(ours[name].numpy(), r.numpy(),
                                       rtol=1e-3, atol=1e-5,
                                       err_msg=msg + name)
            if name in prev_ours:
                # each side's update of this step, -lr * (momentum buffer),
                # the buffer momentum * its last value + gradient + decay:
                # it holds the gradients and the momentum against each other
                d_ref = r.numpy() - prev_ref[name].numpy()
                d_ours = ours[name].numpy() - prev_ours[name].numpy()
                rel = np.linalg.norm(d_ours - d_ref) / (
                    np.linalg.norm(d_ref) + 1e-12)
                assert rel < 5e-2, msg + "update of %s: %.4f" % (name, rel)
    assert state.step == ITERS and state.slow_init == 0
    moved = [k for k in ref if k.endswith("running_mean")
             and not np.allclose(ref[k].numpy(), teacher0[k].numpy())]
    assert moved, "the BN running statistics did not move"
    for name, t in {**state.teacher_params, **state.teacher_stats}.items():
        assert torch.equal(t, teacher0[name]), name
    for name, r in {**_sd(params=jstate.teacher_params),
                    **_sd(stats=jstate.teacher_stats)}.items():
        np.testing.assert_array_equal(teacher0[name].numpy(), r.numpy())
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == counts0[k] + 2 * ITERS, k


TRAJ_ITERS = 20
TRAJ_LR = 5e-4      # the recipe's ABN stage (tools/recipe.py --lr-abn)


@pytest.fixture
def two_threads():
    """Two intra-op threads, whatever the host has: the steps are small,
    and several test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _traj_rtol(it):
    """Per-iteration loss tolerance: 2e-5 at the first iteration, doubling
    with each, at most 5e-3."""
    return min(5e-3, 2e-5 * 2 ** it)


def test_abn_trajectory_matches_jax_over_twenty_iterations(inputs,
                                                           two_threads):
    """The CPU forecast of the recipe's first stage: 20 ABN iterations of
    both packages from the same weights (the shallow r101 above) on the
    same 20 pre-augmented batches, at the recipe's ABN learning rate, the
    CE kernels (Pallas in interpret mode, the port's wrapper) on both
    sides.  The trajectories separate as f32 rounding is amplified by live
    BN, as JAX's own does: the port's losses differ from JAX's by 3.0e-7
    at the first iteration, 9.6e-5 at the fifth and 2.2e-3 at worst (the
    fourteenth); JAX's own trajectory with the source frames scaled by
    1 + 1e-6 noise differs from it by 1.9e-6, 3.1e-5 and 2.0e-3; after the
    twenty, the worst tensor's relative norm error is 5.2% for the port
    and 6.3% for the perturbed JAX run (the ill-conditioned BN scales, see
    the module's docstring).  Tolerances: ``src_loss_ce`` and ``loss_ce``
    of iteration ``it`` (from 0) within rtol ``min(5e-3, 2e-5 * 2**it)``
    (at least 2.2 times the port's difference at every iteration); every
    parameter and BN running statistic after the last within a relative
    norm error of 0.1; the running statistics moved."""
    variables, _ = inputs
    rng = np.random.RandomState(1)
    frames = []
    for _ in range(TRAJ_ITERS):
        src_y = rng.randint(0, C, (B_SRC, H, W)).astype(np.int32)
        src_y[:, -6:] = 255
        frames.append((rng.randn(B_SRC, H, W, 3).astype(np.float32), src_y,
                       (rng.randn(B_TGT, H, W, 3) * 0.8 + 0.2).astype(
                           np.float32),
                       rng.randint(0, C, (B_TGT, H, W)).astype(np.int32)))

    class MC(_MC):
        LR = TRAJ_LR

    params, stats = variables["params"], variables["batch_stats"]
    tx, _ = joptim.build_optimizer(MC, ARCH, params)
    jstate = JState(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        teacher_params=jax.tree.map(jnp.asarray, params),
        teacher_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(params), running_conf=jnp.zeros((C,), jnp.float32),
        slow_init=jnp.zeros((), jnp.float32), step=jnp.zeros((), jnp.int32))
    model = build_model(ARCH, C, device="cpu", layers=(1, 1, 1, 1))
    state = create_train_state(model, toptim.build_optimizer(MC, ARCH, model),
                               C, device="cpu")
    train_state_from_jax(
        dict(params=params, batch_stats=stats, teacher_params=params,
             teacher_stats=stats, running_conf=np.zeros(C, np.float32),
             slow_init=0.0, step=0), ARCH, state)
    stats0 = {k: v.clone() for k, v in state.teacher_stats.items()}
    jstep = jax.jit(jsteps.make_abn_frames_step(
        ShallowDeepLab(num_classes=C, layers=(1, 1, 1, 1)), tx,
        jsteps.StepConfig(num_classes=C, crop_hw=(H, W), ce_impl="pallas")))
    tstep = tsteps.make_abn_frames_step(
        tsteps.StepConfig(num_classes=C, crop_hw=(H, W), ce_impl="kernel"))
    for it, batch in enumerate(frames):
        jstate, jm = jstep(jstate, *map(jnp.asarray, batch),
                           jax.random.PRNGKey(it))
        tm = tstep(state, *map(torch.from_numpy, batch))
        for k in ("src_loss_ce", "loss_ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=_traj_rtol(it),
                                       err_msg="iter %d %s" % (it, k))
    ours = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    ref = {**_sd(params=jstate.params), **_sd(stats=jstate.batch_stats)}
    for name, r in ref.items():
        got = ours[name].detach().numpy()
        rel = np.linalg.norm(got - r.numpy()) / (np.linalg.norm(r.numpy())
                                                 + 1e-12)
        assert rel < 0.1, "%s after %d iterations: %.4f" % (
            name, TRAJ_ITERS, rel)
    assert state.step == TRAJ_ITERS
    assert any(not torch.allclose(model.get_buffer(k), v)
               for k, v in stats0.items() if k.endswith("running_mean"))


def test_abn_step_end_to_end_on_tiny():
    """``make_abn_step`` on the CPU: source pipeline on raw frames larger
    than the crop (with the anti-alias pre-blur and jitter), target frames
    through the same pipeline with the standard statistics, live BN, one
    SGD step, the stats-only target pass."""
    scfg = tsteps.StepConfig(num_classes=5, crop_hw=(24, 32),
                             src_scale=(0.5, 2.0), src_jitter=0.5,
                             src_mean=(0.5, 0.4, 0.3), src_std=(0.2, 0.3, 0.25))
    model = build_model("tiny", 5, device="cpu")
    state = create_train_state(model, toptim.build_optimizer(_MC, "tiny", model),
                               5, device="cpu")
    step = tsteps.make_abn_step(scfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 256, (3, 41, 57, 3)).astype(np.uint8),
             rng.randint(0, 5, (3, 41, 57)).astype(np.uint8),
             rng.randint(0, 256, (2, 36, 60, 3)).astype(np.uint8),
             rng.randint(0, 5, (2, 36, 60)).astype(np.uint8))
    mean0 = model.bn_a.running_mean.clone()
    w0 = model.aspp.weight.detach().clone()
    teacher0 = {k: v.clone() for k, v in state.teacher_params.items()}
    for i in range(3):
        m = step(state, batch, gen)
        assert set(m) == {"src_loss_ce", "loss_ce"}
        for k, v in m.items():
            assert v.shape == () and torch.isfinite(v), k
    assert state.step == 3
    assert int(model.bn_a.num_batches_tracked) == 6
    assert not torch.equal(mean0, model.bn_a.running_mean)
    assert not torch.equal(w0, model.aspp.weight)
    assert all(torch.equal(v, teacher0[k])
               for k, v in state.teacher_params.items())
    assert not state.running_conf.any() and state.slow_init == 0


def test_abn_step_normalizes_target_with_the_standard_stats(monkeypatch):
    """The target frames take ``mean``/``std``; the source frames the
    renormalized ``src_mean``/``src_std``."""
    seen = []
    real = tpipe.augment_source_batch

    def spy(*a, **kw):
        seen.append((kw["mean"], kw["std"], kw["scale_range"],
                     kw["jitter"]))
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "augment_source_batch", spy)
    scfg = tsteps.StepConfig(num_classes=5, crop_hw=(16, 16),
                             src_scale=(0.5, 2.0), src_jitter=0.5,
                             src_mean=(0.5, 0.4, 0.3), src_std=(0.2, 0.3, 0.25))
    model = build_model("tiny", 5, device="cpu")
    state = create_train_state(model, toptim.build_optimizer(_MC, "tiny", model),
                               5, device="cpu")
    rng = np.random.RandomState(1)
    batch = (rng.randint(0, 256, (2, 20, 20, 3)).astype(np.uint8),
             rng.randint(0, 5, (2, 20, 20)).astype(np.uint8)) * 2
    tsteps.make_abn_step(scfg, device="cpu")(state, batch,
                                             torch.Generator())
    assert seen == [(scfg.src_mean, scfg.src_std, (0.5, 2.0), 0.5),
                    (scfg.mean, scfg.std, (0.5, 2.0), 0.5)]


def test_renorm_stats_matches_jax():
    args = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
            (0.481, 0.479, 0.465), (0.243, 0.239, 0.237),
            (0.300, 0.344, 0.297), (0.175, 0.180, 0.177))
    assert tpipe.renorm_stats(*args) == jpipe.renorm_stats(*args)


def _yaml_step_config(name):
    cfg_from_file("configs/%s.yaml" % name)
    return cfg


@pytest.mark.parametrize("name", ["deeplabv2_resnet101",
                                  "deeplabv2_resnet101_train"])
@pytest.mark.parametrize("ce", ["pallas", "xla"])
def test_step_config_from_cfg_matches_jax(name, ce):
    c = _yaml_step_config(name)
    c.TPU.CE_IMPL = ce
    ref = jsteps.step_config_from_cfg(c)._asdict()
    ours = tsteps.step_config_from_cfg(c)._asdict()
    assert ref.pop("ckpt_loss") is False
    assert ours.pop("ce_impl") == {"pallas": "kernel", "xla": "logsoftmax"}[
        ref.pop("ce_impl")]
    assert ours == ref


def test_step_config_from_cfg_rejects_an_unknown_ce_impl():
    c = _yaml_step_config("deeplabv2_resnet101")
    c.TPU.CE_IMPL = "triton"
    with pytest.raises(ValueError, match="CE_IMPL"):
        tsteps.step_config_from_cfg(c)


def test_chip_smoke_abn_config_is_the_yaml_one():
    """``chip_smoke.py`` cannot read the YAML (it imports nothing of
    ``dasac_tpu``); its ABN phase spells the config out, which must equal
    ``configs/deeplabv2_resnet101.yaml`` over the defaults, with the CE
    kernels chosen explicitly."""
    import chip_smoke

    want = tsteps.step_config_from_cfg(
        _yaml_step_config("deeplabv2_resnet101"))._replace(ce_impl="kernel")
    assert chip_smoke.abn_step_config() == want
    assert want.crop_hw == (640, 640) and want.src_scale == (0.5, 2.0)
    assert want.src_jitter == 0.5 and want.src_mean != want.mean
