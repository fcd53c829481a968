"""The port's optimizers (``dasac_tpu_torch/train/optim.py``, ``MODEL.OPT``)
and their checkpoint state against dasac_tpu on the CPU, f32.

  * Adam: five steps of the port's ``build_optimizer`` (torch Adam over the
    four LR groups, coupled weight decay) against dasac_tpu's (optax
    ``add_decayed_weights`` + ``adam`` per group) from the same parameters
    and the same per-step gradients (``tiny``: every group holds
    parameters): parameters within atol 1e-6, for two values of
    ``MODEL.BETA1``; SGD the same way, as the reference for the harness.
    The base LR is 5e-4, the largest in ``configs/`` (FCN8s; 10x and 20x
    in the new groups).  The gap grows with LR x steps: optax evaluates
    Adam's bias correction ``1 - b2**t`` in f32, where 0.999 rounds to
    0.99900001 (1.3e-5 relative in ``1 - b2``), torch in double; here it
    stays under 5e-7;
  * a ``.pth`` round trip (``Checkpointer``) resumes Adam's moments and step
    count, and the next step equals an uninterrupted run's, bit for bit; a
    snapshot of another optimizer kind raises, optax's rules (whose groups
    may carry SGD's ``momentum`` key or none) included, by the ``MODEL.OPT``
    name its groups carry; a snapshot whose groups carry no name (the
    reference's SGD, the port's Adam before the name) loads as before;
  * the train CLI takes ``MODEL.OPT adam`` with ``TPU.REMAT convs`` and
    ``--resume auto`` continues the moments.

optax's other optimizers by name: ``tests/test_torch_optax.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.train import optim as joptim
from dasac_tpu.utils.collections import AttrDict
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core.opts import get_arguments
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import checkpoints as tckpt
from dasac_tpu_torch.train import cli, loop
from dasac_tpu_torch.train import optim as toptim
from tests.test_torch_trainer import TINY, _argv
from tests.test_torch_trainer import root  # noqa: F401  (fixture)

ARCH = "tiny"
C = 5
STEPS = 5


def _mcfg(opt, beta1=0.5, lr=5e-4, wd=5e-4):
    m = AttrDict()
    for k, v in dict(LR=lr, WEIGHT_DECAY=wd, MOMENTUM=0.9, OPT=opt,
                     OPT_NESTEROV=False, BETA1=beta1).items():
        m[k] = v
    return m


def _jax_variables():
    model = jbuild(ARCH, C)
    return jax.tree.map(np.asarray, dict(model.init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 16, 16, 3)),
        train=False, update_stats=False)))


def _grads(params, step):
    """Gradients for ``step``, in JAX's layout, from numpy."""
    rng = np.random.RandomState(100 + step)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.5).astype(np.float32),
        params)


def _to_port(params, stats):
    return from_jax_variables({"params": jax.tree.map(np.asarray, params),
                               "batch_stats": stats}, ARCH)


def _port_state(mcfg, seed=0):
    model = build_model(ARCH, C, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, toptim.build_optimizer(mcfg, ARCH,
                                                            model),
                              C, device="cpu")


def _set_grads(model, grads_sd):
    for k, p in model.named_parameters():
        p.grad = grads_sd[k].clone()


@pytest.mark.parametrize("opt,beta1", [("adam", 0.5), ("adam", 0.9),
                                       ("sgd", 0.5)])
def test_optimizer_matches_optax_over_the_four_groups(opt, beta1):
    variables = _jax_variables()
    params, stats = variables["params"], variables["batch_stats"]
    mcfg = _mcfg(opt.upper() if opt == "sgd" else opt, beta1=beta1)
    tx, labels = joptim.build_optimizer(mcfg, ARCH, params)
    assert set(jax.tree.leaves(labels)) == set(joptim.GROUPS)
    opt_state = tx.init(params)

    state = _port_state(mcfg)
    state.model.load_state_dict(_to_port(params, stats), strict=True)
    optimizer = state.optimizer
    assert isinstance(optimizer, torch.optim.Adam if opt == "adam"
                      else torch.optim.SGD)
    assert [g["name"] for g in optimizer.param_groups] == list(
        joptim.GROUPS)

    for step in range(STEPS):
        g = _grads(params, step)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(state.model, _to_port(g, stats))
        optimizer.step()

    want = _to_port(params, stats)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        # the run moved every parameter: the comparison is not vacuous
        assert not np.allclose(p.detach().numpy(),
                               _to_port(variables["params"], stats)[k]
                               .numpy()), k


def test_adam_pth_round_trip_continues_the_moments(tmp_path):
    mcfg = _mcfg("adam")
    ref = _port_state(mcfg)
    ck = tckpt.Checkpointer(str(tmp_path))
    rng = torch.Generator().manual_seed(0)
    grads = [{k: torch.randn(p.shape, generator=rng)
              for k, p in ref.model.named_parameters()}
             for _ in range(4)]
    for g in grads[:3]:
        _set_grads(ref.model, g)
        ref.optimizer.step()
    path = ck.save_latest(ref, 0.5, 2)

    resumed = _port_state(mcfg, seed=1)
    _, epoch, _ = tckpt.Checkpointer(str(tmp_path)).load(path, resumed)
    assert epoch == 2
    for p, q in zip(ref.model.parameters(), resumed.model.parameters()):
        a, b = ref.optimizer.state[p], resumed.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[key], b[key]), key
        assert int(b["step"]) == 3
    for s in (ref, resumed):
        _set_grads(s.model, grads[3])
        s.optimizer.step()
    for (k, a), b in zip(ref.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("saved,loading", [
    ("adam", "SGD"), ("SGD", "adam"), ("lars", "SGD"), ("sm3", "rmsprop"),
    ("rmsprop", "SGD"), ("adamw", "adam"), ("SGD", "lion")])
def test_a_snapshot_of_the_other_optimizer_kind_raises(tmp_path, saved,
                                                       loading):
    state = _port_state(_mcfg(saved))
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    path = tckpt.Checkpointer(str(tmp_path)).save_latest(state, 0.0, 0)
    with pytest.raises(ValueError, match="MODEL.OPT"):
        tckpt.Checkpointer(str(tmp_path)).load(path,
                                               _port_state(_mcfg(loading)))


@pytest.mark.parametrize("opt,field", [("SGD", "momentum_buffer"),
                                       ("adam", "exp_avg")])
def test_a_snapshot_without_the_name_loads_by_its_group_keys(tmp_path, opt,
                                                             field):
    state = _port_state(_mcfg(opt))
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    path = tckpt.Checkpointer(str(tmp_path)).save_latest(state, 0.0, 0)
    snap = torch.load(path, weights_only=True)
    for g in snap["opt"]["param_groups"]:
        del g["opt"]
    torch.save(snap, path)
    fresh = _port_state(_mcfg(opt), seed=1)
    tckpt.Checkpointer(str(tmp_path)).load(path, fresh)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[p][field],
                           fresh.optimizer.state[q][field])


def test_cli_trains_adam_under_remat_and_resumes_its_moments(root,  # noqa
                                                             tmp_path):
    tconfig.reset_cfg()
    sets = ["MODEL.OPT", "adam", "TPU.REMAT", "convs"]
    try:
        trainer = cli.main(_argv(root, tmp_path, "adam", sets=sets),
                           device="cpu")
        assert isinstance(trainer.state.optimizer, torch.optim.Adam)
        saved = torch.load(str(tmp_path / "snap" / "default" / "e" / "adam"
                               / "last.pth"), weights_only=True)
        assert all("exp_avg" in s for s in saved["opt"]["state"].values())

        argv = _argv(root, tmp_path, "adam", extra=["--resume", "auto"],
                     sets=sets + ["TRAIN.NUM_EPOCHS", "3"])
        tconfig.reset_cfg()
        tconfig.cfg_from_file(TINY)
        tconfig.cfg_from_list(argv[argv.index("--set") + 1:])
        resumed = loop.Trainer(get_arguments(argv), tconfig.cfg,
                               device="cpu")
        opt = resumed.state.optimizer
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt.state[p][key],
                                   saved["opt"]["state"][i][key]), (i, key)
        resumed.close()
    finally:
        tconfig.reset_cfg()
