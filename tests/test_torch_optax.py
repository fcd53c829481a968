"""optax's optimizers by name in the port (``MODEL.OPT``;
``dasac_tpu_torch/train/optax_rules.py``) against dasac_tpu's optax chains
on the CPU, f32.

  * each of the 26 names: 5 steps (``radam`` 7, so that its rectified
    branch, which starts at step 6, runs too) of the port's
    ``build_optimizer`` against ``dasac_tpu.train.optim.build_optimizer``
    on the ``tiny`` model, from the same parameters (``from_jax_variables``)
    (flax's initial ones plus seeded noise, see ``_start``) and the same
    per-step gradients, base LR 5e-4 (the 20x group steps at 1e-2; the
    names of ``LR`` at a larger one), weight decay 5e-4: parameters within
    atol 1e-6 (``radam``: 3e-6, see ``ATOL``), and every parameter tensor
    moved by at least 100 times that bound in optax's run.  ``noisy_sgd``
    is fed JAX's own draws: optax's ``add_noise`` with the same key at
    ``eta = 1``, ``gamma = 0`` (a scale of exactly 1) in a
    ``multi_transform`` over the same labels yields the draws of each step,
    leaf by leaf, which ``from_jax_variables`` maps onto the port's names;
  * ``adafactor`` and ``sm3`` on real kernel shapes (HWIO ``(3, 3, 1024,
    256)``, ``(3, 3, 256, 512)``, ``(1, 1, 2048, 512)``, ``(3, 3, 512,
    512)``, a tie that ``np.argsort`` of the flax shape breaks, as optax's
    does, and a bias), where adafactor factors: parameters within atol
    1e-6 and every state tensor (mapped onto the port's layout) within rtol
    1e-5 (sm3's ``nu`` also atol 1e-7: it averages signed terms);
  * the names dasac_tpu cannot train with raise ``ValueError`` at build
    time in the port, beside dasac_tpu's failure at its first update
    (``lbfgs``, ``polyak_sgd``) or its ascent (one step of ``scale`` raises
    the tiny model's loss);
  * each name's state survives a ``.pth`` round trip: every field equal
    and the next step bit-equal to an uninterrupted run's;
  * in a spawned 2-rank gloo world, rank 0 alone resumes an ``adamw``,
    ``adafactor`` (factored) and ``sm3`` snapshot, as the trainer does:
    ``broadcast_state`` gives rank 1 every field and step count, and after
    one step the replicas are bit-equal, optimizer state included.

The optax updates run eagerly: the tiny model's 4-group chains take less
time so than a compile each.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.train import optim as joptim
from dasac_tpu_torch.train import checkpoints as tckpt
from dasac_tpu_torch.train import optax_rules
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.utils.sys_tools import find_free_port
from tests import torch_optax_ranks as ranks
from tests.test_torch_optim import (ARCH, C, _jax_variables, _grads, _mcfg,
                                    _port_state, _set_grads, _to_port)

STEPS = {"radam": 7}
# base LRs other than 5e-4: every parameter tensor must move by at least
# MOVED times its atol in the run, or the comparison could not fail.  At
# 5e-4 adadelta moves a BN scale by 6e-6 (its first steps are
# sqrt(eps) / rms(g) times the LR), lars a bias by 4e-7 (its trust
# coefficient is 1e-3), adafactor and fromage a bias by ~1.2e-4
LR = {"adadelta": 5e-2, "adafactor": 2e-3, "fromage": 2e-3, "lars": 2e-1}
MOVED = 100
# radam's rectification at steps 6 and 7, ro = ro_inf - 2 t b2^t / (1 -
# b2^t), cancels 1999 against ~1993: one f32 ulp of b2^t moves ro by ~0.02
# and its update by ~0.5%.  XLA's pow(0.999, t) is not correctly rounded
# (eagerly it is an ulp off numpy's at t = 3, 6 and 7); the port's is
# numpy's
ATOL = {"radam": 3e-6}


def _start():
    """The tiny model's flax variables with seeded noise (std 0.05) added
    to every parameter: no tensor starts at 0, where the rules that scale
    by a tensor's norm (fromage, lars, lamb, adafactor) hardly move it."""
    variables = _jax_variables()
    rng = np.random.RandomState(11)
    variables["params"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), variables["params"])
    return variables


def _noise_draws(labels, params, steps):
    """JAX's ``noisy_sgd`` draws of each step as port tensors by name."""
    tx = optax.multi_transform(
        {g: optax.add_noise(1.0, 0.0, 0) for g in joptim.GROUPS}, labels)
    state = tx.init(params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    out = []
    for _ in range(steps):
        draws, state = tx.update(zeros, state)
        out.append(draws)
    return out


@pytest.mark.parametrize("name", optax_rules.NAMES)
def test_rule_matches_optax_over_the_four_groups(name):
    variables = _start()
    params, stats = variables["params"], variables["batch_stats"]
    mcfg = _mcfg(name, lr=LR.get(name, 5e-4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # noisy_sgd's key, optimistic_adam
        tx, labels = joptim.build_optimizer(mcfg, ARCH, params)
    opt_state = tx.init(params)
    steps = STEPS.get(name, 5)

    state = _port_state(mcfg)
    state.model.load_state_dict(_to_port(params, stats), strict=True)
    optimizer = state.optimizer
    assert isinstance(optimizer, optax_rules.OptaxRule)
    assert [g["name"] for g in optimizer.param_groups] == list(
        joptim.GROUPS)
    assert {g["opt"] for g in optimizer.param_groups} == {name}
    names = toptim.param_group_names(state.model, ARCH)
    draws = (_noise_draws(labels, params, steps) if name == "noisy_sgd"
             else None)

    for step in range(steps):
        g = _grads(params, step)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(state.model, _to_port(g, stats))
        if draws is None:
            optimizer.step()
        else:
            sd = _to_port(draws[step], stats)
            optimizer.step(noise=[[sd[n] for n in names[grp]]
                                  for grp in toptim.GROUPS])

    want = _to_port(params, stats)
    start = _to_port(variables["params"], stats)
    atol = ATOL.get(name, 1e-6)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)
        # optax moved every tensor by far more than the bound: the
        # comparison is not vacuous
        moved = float(np.abs(want[k].numpy() - start[k].numpy()).max())
        assert moved >= MOVED * atol, (k, moved)
    for st in optimizer.state.values():
        assert int(st["step"]) == steps


# -------------------------------------------------- the layout-bound rules

KERNELS = {"a": (3, 3, 1024, 256), "b": (3, 3, 256, 512),
           "c": (1, 1, 2048, 512), "d": (3, 3, 512, 512), "bias": (256,)}


def _port(a):
    a = np.array(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a))


def _reduced_to_port(arr, ndim, removed):
    """optax's state tensor with flax axis ``removed`` dropped -> the port's
    (its image of that axis dropped, the rest in the port's order)."""
    axes = optax_rules.flax_axes(ndim)
    flax_left = [j for j in range(ndim) if j != removed]
    order = sorted(flax_left, key=lambda j: axes[j])
    return torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(arr), [flax_left.index(j) for j in order])))


def _kernel_run(name, lr=5e-3, steps=3):
    rng = np.random.RandomState(7)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in KERNELS.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in KERNELS.items()} for _ in range(steps)]
    tx = getattr(optax, name)(lr)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    ports = {k: torch.nn.Parameter(_port(v)) for k, v in params.items()}
    opt = optax_rules.OptaxRule(
        [dict(params=list(ports.values()), lr=lr, weight_decay=0.0)], name)
    for g in grads:
        u, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in ports.items():
            p.grad = _port(g[k])
        opt.step()
    for k, p in ports.items():
        want = _port(jp[k]).numpy()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6, err_msg=k)
        moved = float(np.abs(want - _port(params[k]).numpy()).max())
        assert moved >= MOVED * 1e-6, (k, moved)
    return jstate, ports, opt


def test_adafactor_factors_the_flax_axes_on_kernel_shapes():
    jstate, ports, opt = _kernel_run("adafactor")
    fstate = jstate[0]
    assert int(fstate.count) == 3
    for k, p in ports.items():
        st = opt.state[p]
        shape = KERNELS[k]
        dims = optax_rules.factored_dims(tuple(p.shape))
        if len(shape) == 1:
            assert dims is None
            torch.testing.assert_close(st["v"], _port(fstate.v[k]),
                                       rtol=1e-5, atol=0)
            continue
        order = np.argsort(shape)
        d1, d0 = int(order[-2]), int(order[-1])
        axes = optax_rules.flax_axes(4)
        assert dims == (axes[d1], axes[d0]), k
        torch.testing.assert_close(
            st["v_row"], _reduced_to_port(fstate.v_row[k], 4, d0),
            rtol=1e-5, atol=0, msg=k)
        torch.testing.assert_close(
            st["v_col"], _reduced_to_port(fstate.v_col[k], 4, d1),
            rtol=1e-5, atol=0, msg=k)


def test_sm3_keeps_optax_accumulators_per_axis_on_kernel_shapes():
    jstate, ports, opt = _kernel_run("sm3")
    sm3_state = jstate[0]
    for k, p in ports.items():
        st = opt.state[p]
        axes = optax_rules.flax_axes(p.ndim)
        for j, acc in enumerate(sm3_state.mu[k]):
            torch.testing.assert_close(st["acc%d" % axes[j]],
                                       torch.from_numpy(np.asarray(acc)),
                                       rtol=1e-5, atol=0, msg=(k, j))
        # nu averages signed terms: near 0 it cancels, and a few f32 ulps
        # of its largest values (~0.2) are the bound there
        torch.testing.assert_close(st["nu"], _port(sm3_state.nu[k]),
                                   rtol=1e-5, atol=1e-7, msg=k)


# -------------------------------------- the names the port does not train

# optax 0.2.6's aliases whose update needs value= / grad= arguments
NEED_LOSS = ("lbfgs", "polyak_sgd")
# optax 0.2.6's gradient transformations that take (lr) and run in
# dasac_tpu's step as if they were optimizers
TRANSFORMATIONS = (
    "adaptive_grad_clip", "add_decayed_weights", "apply_every", "clip",
    "clip_by_block_rms", "clip_by_global_norm", "ema", "freeze",
    "normalize_by_update_norm", "scale", "scale_by_adadelta",
    "scale_by_adam", "scale_by_adamax", "scale_by_adan", "scale_by_amsgrad",
    "scale_by_belief", "scale_by_distance_over_gradients",
    "scale_by_factored_rms", "scale_by_learning_rate", "scale_by_lion",
    "scale_by_novograd", "scale_by_optimistic_gradient",
    "scale_by_param_block_norm", "scale_by_param_block_rms",
    "scale_by_radam", "scale_by_rms", "scale_by_rprop", "scale_by_rss",
    "scale_by_sm3", "scale_by_stddev", "scale_by_trust_ratio",
    "scale_by_yogi", "trace")


def _first_update(name):
    variables = _jax_variables()
    params = variables["params"]
    tx, _ = joptim.build_optimizer(_mcfg(name), ARCH, params)
    return tx.update(_grads(params, 0), tx.init(params), params)


@pytest.mark.parametrize("name", NEED_LOSS)
def test_names_that_need_the_loss_raise_beside_dasac_tpus_failure(name):
    with pytest.raises((TypeError, IndexError)):
        _first_update(name)
    assert hasattr(optax, name)
    with pytest.raises(ValueError, match="need the loss"):
        _port_state(_mcfg(name))


@pytest.mark.parametrize("name", TRANSFORMATIONS)
def test_transformation_names_raise(name):
    assert hasattr(optax, name)
    with pytest.raises(ValueError, match="gradient transformations"):
        _port_state(_mcfg(name))


def test_dasac_tpu_climbs_the_loss_with_a_transformation_name():
    """One step of ``MODEL.OPT scale`` in dasac_tpu raises the tiny model's
    loss, where ``sgd`` at the same LR lowers it."""
    model = jbuild(ARCH, C)
    variables = _jax_variables()
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 3)), jnp.float32)
    y = jnp.asarray(rng.randint(0, C, (2, 16, 16)))

    def loss(p):
        _, logits = model.apply({"params": p, "batch_stats": stats}, x,
                                train=False, update_stats=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    value, grads = jax.value_and_grad(loss)(params)
    after = {}
    for name in ("scale", "sgd"):
        tx, _ = joptim.build_optimizer(_mcfg(name, lr=1e-2, wd=0.0), ARCH,
                                       params)
        updates, _ = tx.update(grads, tx.init(params), params)
        after[name] = float(loss(optax.apply_updates(params, updates)))
    assert after["scale"] > float(value) > after["sgd"], (value, after)


def test_an_unknown_name_raises():
    with pytest.raises(ValueError, match="the port trains with sgd, adam"):
        _port_state(_mcfg("no_such_optimizer"))


# ----------------------------------------------------- the .pth round trip

@pytest.mark.parametrize("name", optax_rules.NAMES)
def test_pth_round_trip_continues_bit_equal(name, tmp_path):
    mcfg = _mcfg(name)
    ref = _port_state(mcfg)
    rng = torch.Generator().manual_seed(0)
    grads = [{k: torch.randn(p.shape, generator=rng)
              for k, p in ref.model.named_parameters()} for _ in range(4)]
    for g in grads[:3]:
        _set_grads(ref.model, g)
        ref.optimizer.step()
    path = tckpt.Checkpointer(str(tmp_path)).save_latest(ref, 0.5, 2)
    saved = torch.load(path, weights_only=True)
    assert {g["opt"] for g in saved["opt"]["param_groups"]} == {name}

    resumed = _port_state(mcfg, seed=1)
    tckpt.Checkpointer(str(tmp_path)).load(path, resumed)
    for p, q in zip(ref.model.parameters(), resumed.model.parameters()):
        a, b = ref.optimizer.state[p], resumed.optimizer.state[q]
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert torch.equal(a[key], b[key]), key
        assert int(b["step"]) == 3
    for s in (ref, resumed):
        _set_grads(s.model, grads[3])
        s.optimizer.step()
    for (k, a), b in zip(ref.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), k


def test_noisy_sgd_draws_follow_the_seed():
    """Without draws given, ``noisy_sgd`` draws from its seed and the step
    count: the same seed moves the parameters the same way."""
    runs = []
    for seed in (3, 3, 4):
        model = _port_state(_mcfg("noisy_sgd")).model
        opt = toptim.build_optimizer(_mcfg("noisy_sgd"), ARCH, model,
                                     seed=seed)
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        runs.append(torch.cat([p.detach().flatten()
                               for p in model.parameters()]))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# ------------------------------------------------ a resume over 2 ranks

RESUMED = ("adamw", "adafactor", "sm3")


@pytest.fixture(scope="module")
def resumed_world(tmp_path_factory):
    """Each of ``RESUMED``'s snapshots (3 steps of the tiny model at width
    128, whose ``conv_b`` adafactor factors), then one spawned 2-rank gloo
    world in which rank 0 alone reads them (``tests/torch_optax_ranks.py``);
    each rank's results."""
    base = tmp_path_factory.mktemp("optax_world")
    for name in RESUMED:
        state = ranks.make_state(name, seed=0)
        for s in range(3):
            ranks.step(state, seed=s)
        tckpt.Checkpointer(str(base / name)).save_latest(state, 0.5, 2)
    if "adafactor" in RESUMED:
        st = torch.load(base / "adafactor" / "last.pth", weights_only=True)
        assert any("v_row" in v for v in st["opt"]["state"].values())
    addr = "127.0.0.1:%d" % find_free_port()
    torch.multiprocessing.spawn(ranks.resume_main,
                                args=(addr, str(base), RESUMED),
                                nprocs=ranks.WORLD, join=True)
    return [torch.load(base / ("rank%d.pt" % r), weights_only=False)
            for r in range(ranks.WORLD)]


@pytest.mark.parametrize("name", RESUMED)
def test_a_resume_on_rank_0_reaches_every_rank(resumed_world, name):
    """Rank 1, which read no snapshot, holds rank 0's every field and step
    count after ``broadcast_state``, and after one more step the replicas,
    optimizer state and counts included, are bit-equal."""
    for rank, out in enumerate(resumed_world):
        row = out[name]
        assert row["restored"], (rank, row)
        assert isinstance(row["equal"], int) and row["equal"] > 0, (rank,
                                                                     row)
        assert row["steps"] == [4], (rank, row)
