"""The port's VGG-16 family (``dasac_tpu_torch/nn/vgg.py``: DeepLabv2-VGG16
and FCN8s) against dasac_tpu on the CPU, at full width and depth.

Each arch's variables are built once per module (FCN's ``head_fc6`` alone
is 103 M parameters) and carried across with ``from_jax_variables``;
inputs are 64x64 (FCN's 1/32 grid is then 2x2) made with numpy from a seed.

  * logits and upsampled logits, f32, rtol/atol 1e-4 (as
    tests/test_torch_nn.py);
  * ``param_group_names`` equals ``dasac_tpu.tools.torch_param_groups``'s
    reference order, group for group and name for name;
  * ``load_torchvision_backbone`` of a synthetic torchvision ``vgg16_bn``
    ``state_dict`` equals JAX's ``apply_state_dict(..., "torchvision")``
    carried across;
  * channel dropout: mask shape, keep rate within 3 sigma, scale, and the
    same masks from the same generator seed;
  * the SAC views step against JAX's with ``drop_rate=0`` on both sides
    (DeepLab-VGG 2 iterations, FCN8s 1), with the tolerances of
    tests/test_torch_step.py;
  * one ABN frames step of DeepLab-VGG at 64x64 with the tolerances of
    tests/test_torch_abn.py: losses rtol 2e-4, parameters and BN running
    statistics rtol 1e-3 / atol 1e-5, and each conv's update within a
    relative norm error of 5e-2.  The BN scales' and shifts' updates are
    held by the parameter bound only: a live BN is followed by ReLU, a
    conv and another live BN, which undo a common scaling of its scale and
    shift, so their gradients are sums that nearly cancel.  Scaling the
    source frames by 1 + 1e-6 noise moves JAX's own update of them by up
    to 6.3% (5.5% at 96x96, 7.7% with 4 frames); the port's differs from
    JAX's by up to 8.2%, and every conv's by under 2%.

Wall time of this file on the CPU host the tier-1 tests run on: ~105 s run
alone (most of it JAX's compile of the two views steps and the ABN step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.core.state import TrainState as JState
from dasac_tpu.nn.convert import apply_state_dict
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.nn.vgg import VGG16FCN8s as JFCN
from dasac_tpu.tools.torch_param_groups import PARAM_GROUPS
from dasac_tpu.train import optim as joptim
from dasac_tpu.train import steps as jsteps
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn import layers
from dasac_tpu_torch.nn.convert import (from_jax_variables,
                                        load_torchvision_backbone,
                                        train_state_from_jax)
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.nn.vgg import VGG16_BN_LAYOUT
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train import steps as tsteps
from tests.test_torch_nn import _randomize_stats

C = 19
H, W = 64, 64
ARCHS = ("deeplabv2_vgg16_bn", "fcn_vgg16_bn")


def _jmodel(arch):
    """The JAX model; FCN8s without dropout (the port's ``drop_rate=0``)
    where two frameworks' random streams would otherwise meet."""
    if arch == "fcn_vgg16_bn":
        return JFCN(num_classes=C, drop_rate=0.0)
    return jbuild(arch, C)


@pytest.fixture(scope="module")
def variables():
    """Each arch's flax variables (numpy), BN statistics and affine
    parameters randomized so frozen BN is not the identity."""
    out = {}
    for seed, arch in enumerate(ARCHS):
        v = jax.jit(lambda k, m=_jmodel(arch): m.init(
            {"params": k}, jnp.zeros((1, H, W, 3)), train=False,
            update_stats=False))(jax.random.PRNGKey(seed))
        out[arch] = _randomize_stats(v, seed + 1)
    return out


def _port(arch, v):
    model = build_model(arch, C, device="cpu",
                        **({"drop_rate": 0.0} if arch == "fcn_vgg16_bn"
                           else {}))
    model.load_state_dict(from_jax_variables(v, arch), strict=True)
    return model


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(variables, arch):
    v = variables[arch]
    x = np.random.RandomState(3).randn(2, H, W, 3).astype(np.float32)
    j_logits, j_up = jax.jit(lambda v, x: _jmodel(arch).apply(
        v, x, train=False, update_stats=False))(v, jnp.asarray(x))
    model = _port(arch, v)
    with torch.no_grad():
        logits, up = model(torch.from_numpy(x))
        lg_only, none = model(torch.from_numpy(x), upsample=False)
    assert none is None and torch.equal(lg_only, logits)
    assert tuple(logits.shape) == (2, H // 8, W // 8, C)
    assert up.dtype == torch.float32 and up.is_contiguous()
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(up.numpy(), np.asarray(j_up), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_groups_are_the_reference_order(arch):
    model = build_model(arch, C, device="cpu")
    names = toptim.param_group_names(model, arch)
    assert [names[g] for g in toptim.GROUPS] == PARAM_GROUPS[arch]
    # the optimizer holds exactly those tensors in that order
    opt = toptim.build_optimizer(_MC, arch, model)
    params = dict(model.named_parameters())
    for group, ref in zip(opt.param_groups, PARAM_GROUPS[arch]):
        assert [id(p) for p in group["params"]] == [id(params[n])
                                                    for n in ref]


def _torchvision_vgg16_bn(seed):
    """A synthetic torchvision ``vgg16_bn`` state_dict: the feature keys
    at their real shapes, the ImageNet classifier's keys (skipped by both
    loaders) at small ones."""
    rng = np.random.RandomState(seed)
    sd, in_ch = {}, 3
    for idx, kind, ch in VGG16_BN_LAYOUT:
        if kind == "conv":
            sd["features.%d.weight" % idx] = rng.randn(
                ch, in_ch, 3, 3).astype(np.float32) * 0.05
            sd["features.%d.bias" % idx] = rng.randn(ch).astype(np.float32)
            in_ch = ch
        elif kind == "bn":
            for part in ("weight", "bias", "running_mean"):
                sd["features.%d.%s" % (idx, part)] = rng.randn(ch).astype(
                    np.float32)
            sd["features.%d.running_var" % idx] = rng.uniform(
                0.5, 1.5, ch).astype(np.float32)
            sd["features.%d.num_batches_tracked" % idx] = np.int64(7)
    for i in (0, 3, 6):
        sd["classifier.%d.weight" % i] = rng.randn(4, 4).astype(np.float32)
        sd["classifier.%d.bias" % i] = rng.randn(4).astype(np.float32)
    return sd


@pytest.mark.parametrize("arch", ARCHS)
def test_torchvision_vgg16_bn_loads_as_jax_loads_it(variables, arch):
    sd = _torchvision_vgg16_bn(5)
    ref, n_ref, skipped_ref = apply_state_dict(variables[arch], sd, arch,
                                               "torchvision")
    model = _port(arch, variables[arch])
    n, skipped = load_torchvision_backbone(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        arch)
    assert n == n_ref == 13 * 2 + 13 * 4
    assert sorted(skipped) == sorted(skipped_ref)
    assert {k.split(".")[0] for k in skipped} == {"classifier"}
    want = from_jax_variables(ref, arch)
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(t.numpy(), want[k].numpy(), k)


def test_torchvision_key_map_rejects_shape_mismatch_and_unknown_arch():
    model = build_model("deeplabv2_vgg16_bn", C, device="cpu")
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_torchvision_backbone(
            model, {"features.0.weight": torch.zeros(64, 3, 5, 5)},
            "deeplabv2_vgg16_bn")
    with pytest.raises(ValueError, match="no torchvision key map"):
        load_torchvision_backbone(model, {}, "tiny")


def test_channel_dropout_masks():
    x = torch.ones(64, 512, 3, 5)
    rate = 0.1
    keep = layers.sample_channel_dropout_draws(
        torch.Generator().manual_seed(0), x, rate)
    assert keep.shape == (64, 512) and keep.dtype == torch.bool
    n, p = keep.numel(), 1.0 - rate
    assert abs(keep.float().mean().item() - p) < 3 * np.sqrt(p * rate / n)
    y = layers.apply_channel_dropout(x, keep, rate)
    # one value per (sample, channel), over all of H and W
    np.testing.assert_array_equal(
        y.numpy(), np.broadcast_to(
            (keep.numpy().astype(np.float32) / np.float32(p))[:, :, None,
                                                              None],
            x.shape))
    again = layers.sample_channel_dropout_draws(
        torch.Generator().manual_seed(0), x, rate)
    assert torch.equal(keep, again)


def test_fcn_dropout_only_in_train_mode():
    model = build_model("fcn_vgg16_bn", C, device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).randn(2, H, W, 3).astype(
        np.float32))
    with torch.no_grad():
        ref = model(x)[0]
        again = model(x, train=False, generator=torch.Generator())[0]
        a = model(x, train=True, generator=torch.Generator().manual_seed(1))[0]
        b = model(x, train=True, generator=torch.Generator().manual_seed(1))[0]
        c = model(x, train=True, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(ref, again)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)


# ---------------------------------------------------------------------------
# steps against dasac_tpu
# ---------------------------------------------------------------------------

class _MC:
    LR = 0.01
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


G, T, B_SRC = 2, 3, 2


def _scfg(mod, ce_impl):
    return mod.StepConfig(
        num_classes=C, crop_hw=(H, W), group_size=T, lr_target=0.1,
        net_momentum=0.99, net_momentum_iter=1, stat_momentum=0.99,
        threshold_beta=1e-3, run_conf_upper=0.75, run_conf_lower=0.01,
        ce_impl=ce_impl)


def _jstate(tx, params, stats):
    return JState(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        teacher_params=jax.tree.map(jnp.asarray, params),
        teacher_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(params), running_conf=jnp.zeros((C,), jnp.float32),
        slow_init=jnp.zeros((), jnp.float32), step=jnp.zeros((), jnp.int32))


def _port_state(arch, params, stats, mc=_MC):
    model = build_model(arch, C, device="cpu",
                        **({"drop_rate": 0.0} if arch == "fcn_vgg16_bn"
                           else {}))
    state = create_train_state(model, toptim.build_optimizer(mc, arch, model),
                               C, device="cpu")
    return train_state_from_jax(
        dict(params=params, batch_stats=stats, teacher_params=params,
             teacher_stats=stats, running_conf=np.zeros(C, np.float32),
             slow_init=0.0, step=0), arch, state)


def _sd(arch, params=None, stats=None):
    v = {}
    if params is not None:
        v["params"] = jax.tree.map(np.asarray, params)
    if stats is not None:
        v["batch_stats"] = jax.tree.map(np.asarray, stats)
    return {k: t for k, t in from_jax_variables(v, arch).items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("arch,iters", [("deeplabv2_vgg16_bn", 2),
                                        ("fcn_vgg16_bn", 1)])
def test_views_step_matches_jax(variables, arch, iters):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (G, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, C, (G, H, W)).astype(np.int32)
    labels[:, :6] = 255
    views = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jpipe.augment_target_groups, group_size=T, blur=True, jitter=0.4,
        greyscale=0.3))(jax.random.PRNGKey(42), imgs, labels))
    src_x = rng.randn(B_SRC, H, W, 3).astype(np.float32)
    src_y = rng.randint(0, C, (B_SRC, H, W)).astype(np.int32)
    src_y[:, -8:] = 255

    params = variables[arch]["params"]
    stats = variables[arch]["batch_stats"]
    tx, _ = joptim.build_optimizer(_MC, arch, params)
    jstate = _jstate(tx, params, stats)
    state = _port_state(arch, params, stats)
    jviews = jax.tree.map(jnp.asarray, views)
    tviews = tsteps.pipelines.TargetViews(
        *(torch.from_numpy(np.array(a)) for a in views))
    jstep = jax.jit(jsteps.make_sac_views_step(
        _jmodel(arch), tx, _scfg(jsteps, "pallas"), debug=True))
    tstep = tsteps.make_sac_views_step(_scfg(tsteps, "kernel"), debug=True)
    for it in range(iters):
        jstate, jm = jstep(jstate, jnp.asarray(src_x), jnp.asarray(src_y),
                           jviews, jax.random.PRNGKey(7))
        tm = tstep(state, torch.from_numpy(src_x), torch.from_numpy(src_y),
                   tviews, torch.Generator().manual_seed(7))
        msg = "%s iter %d " % (arch, it)
        np.testing.assert_allclose(float(tm["src_loss_ce"]),
                                   float(jm["src_loss_ce"]), rtol=2e-4,
                                   atol=1e-6, err_msg=msg + "src CE")
        np.testing.assert_allclose(float(tm["self_ce"]), float(jm["self_ce"]),
                                   rtol=5e-3, atol=1e-5,
                                   err_msg=msg + "self_ce")
        np.testing.assert_allclose(tm["running_conf"].numpy(),
                                   np.asarray(jm["running_conf"]), rtol=1e-4,
                                   atol=1e-6, err_msg=msg + "running_conf")
        pl_j = np.asarray(jm["pseudo"])
        assert np.mean(pl_j != 255) > 0.05, "test batch has no coverage"
        assert np.mean(tm["pseudo"].numpy() != pl_j) < 0.01, msg + "pseudo"
        jgrads = _sd(arch, params=jm["grads"])
        assert set(jgrads) == set(tm["grads"])
        for name, g_j in jgrads.items():
            g_t = tm["grads"][name].numpy()
            rel = np.linalg.norm(g_t - g_j.numpy()) / (
                np.linalg.norm(g_j.numpy()) + 1e-12)
            assert rel < 2e-2, msg + "grad %s rel err %.4f" % (name, rel)
    assert state.step == iters and state.slow_init == 1
    student = _sd(arch, params=jstate.params)
    teacher = _sd(arch, params=jstate.teacher_params)
    ours = dict(state.model.named_parameters())
    for name, ref in student.items():
        np.testing.assert_allclose(ours[name].detach().numpy(), ref.numpy(),
                                   rtol=1e-3, atol=1e-5,
                                   err_msg="student " + name)
        np.testing.assert_allclose(state.teacher_params[name].numpy(),
                                   teacher[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg="teacher " + name)


class _ABNMC(_MC):
    LR = 2.5e-4     # the ABN YAMLs' rate


def test_abn_frames_step_matches_jax(variables):
    arch = "deeplabv2_vgg16_bn"
    rng = np.random.RandomState(1)
    src_x = rng.randn(2, H, W, 3).astype(np.float32)
    src_y = rng.randint(0, C, (2, H, W)).astype(np.int32)
    src_y[:, -6:] = 255
    tgt_x = (rng.randn(2, H, W, 3) * 0.8 + 0.2).astype(np.float32)
    tgt_y = rng.randint(0, C, (2, H, W)).astype(np.int32)
    tgt_y[:, :4] = 255
    params = variables[arch]["params"]
    stats = variables[arch]["batch_stats"]
    tx, _ = joptim.build_optimizer(_ABNMC, arch, params)
    jstate = _jstate(tx, params, stats)
    state = _port_state(arch, params, stats, _ABNMC)
    before = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    jstate, jm = jax.jit(jsteps.make_abn_frames_step(
        _jmodel(arch), tx, jsteps.StepConfig(num_classes=C, crop_hw=(H, W),
                                             ce_impl="pallas")))(
        jstate, *map(jnp.asarray, (src_x, src_y, tgt_x, tgt_y)),
        jax.random.PRNGKey(0))
    tm = tsteps.make_abn_frames_step(tsteps.StepConfig(
        num_classes=C, crop_hw=(H, W), ce_impl="kernel"))(
        state, *map(torch.from_numpy, (src_x, src_y, tgt_x, tgt_y)))
    for k in ("src_loss_ce", "loss_ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    ours = {**{k: v.detach() for k, v in state.model.named_parameters()},
            **dict(state.model.named_buffers())}
    ref_params = _sd(arch, params=jstate.params)
    ref = {**ref_params, **_sd(arch, stats=jstate.batch_stats)}
    p0 = _sd(arch, params=params)
    convs = {n for n, m in state.model.named_modules()
             if isinstance(m, layers.Conv2d)}
    convs = {n + "." + part for n in convs for part in ("weight", "bias")}
    assert len(convs) == 2 * (13 + 2 + 4)
    for name, r in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
        if name in ref_params and name in convs:
            d_ref = r.numpy() - p0[name].numpy()
            d_ours = ours[name].numpy() - before[name].numpy()
            rel = np.linalg.norm(d_ours - d_ref) / (np.linalg.norm(d_ref)
                                                    + 1e-12)
            assert rel < 5e-2, "update of %s: %.4f" % (name, rel)
