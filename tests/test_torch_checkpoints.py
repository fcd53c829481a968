"""The port's checkpoints (dasac_tpu_torch/train/checkpoints.py) against
dasac_tpu on the CPU, in both directions, at full depth (the momentum
layout is positional over the reference's 4 param groups of the full
``deeplabv2_resnet101``).

  * the port saves a ``.pth``; ``dasac_tpu``'s ``Checkpointer.load`` (arch
    set, an SGD template) reads back the student, teacher, ``running_conf``,
    ``slow_init`` and every momentum buffer;
  * ``dasac_tpu.tools.export_torch.export_snapshot`` (with the MODEL
    section) written with ``torch.save`` loads into the port equal to
    ``train_state_from_jax`` plus the exported momentum, while the port's
    own learning rates and weight decay stay.
Tensors compare exactly (both directions only transpose and copy f32).
Then, port only: best-3 pruning, ``last.pth``, ``BestTracker`` and an ABN
snapshot, which has no teacher.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasac_tpu.core.state import create_train_state as jcreate
from dasac_tpu.nn import convert as jconvert
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.tools import export_torch
from dasac_tpu.train import checkpoints as jckpt
from dasac_tpu.train import optim as joptim
from dasac_tpu.utils.collections import AttrDict
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import from_jax_variables, train_state_from_jax
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import checkpoints as tckpt
from dasac_tpu_torch.train import optim as toptim

ARCH = "deeplabv2_resnet101"
C = 19


def _mcfg(lr):
    m = AttrDict()
    for k, v in dict(LR=lr, WEIGHT_DECAY=5e-4, MOMENTUM=0.9, OPT="SGD",
                     OPT_NESTEROV=False, BETA1=0.9).items():
        m[k] = v
    return m


def _port_state(arch=ARCH, lr=2.5e-4, seed=0, c=C):
    model = build_model(arch, c, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    opt = toptim.build_optimizer(_mcfg(lr), arch, model)
    return create_train_state(model, opt, c, device="cpu")


def _train_a_little(state, seed):
    """Momentum in every buffer, moved BN statistics, a teacher distinct
    from the student, a non-trivial running_conf."""
    g = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=g) * 0.1
    state.optimizer.step()
    with torch.no_grad():
        for name, b in state.model.named_buffers():
            if b.is_floating_point():
                b.add_(torch.rand(b.shape, generator=g) * 0.2)
        for t in list(state.teacher_params.values()) + list(
                state.teacher_stats.values()):
            t.mul_(0.5).add_(0.1)
        state.running_conf.copy_(torch.linspace(0.0, 1.0, len(
            state.running_conf)))
    state.slow_init = 1


@pytest.fixture(scope="module")
def jax_template():
    jmodel = jbuild(ARCH, C)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((1, 32, 48, 3)), train=False,
                         update_stats=False)["params"]
    tx, _ = joptim.build_optimizer(_mcfg(2.5e-4), ARCH, params)
    return jmodel, tx, jcreate(jmodel, tx, C, (32, 48, 3),
                               rng=jax.random.PRNGKey(1))


def _np_sd(params, stats):
    return {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)}, ARCH).items()
        if not k.endswith("num_batches_tracked")}


def test_dasac_tpu_reads_what_the_port_saves(tmp_path, jax_template):
    _, _, template = jax_template
    state = _port_state()
    _train_a_little(state, 1)
    fn = tckpt.Checkpointer(str(tmp_path)).save(state, 0.625, 7)
    assert os.path.basename(fn) == "epoch007_score0.625.pth"
    snap = torch.load(fn, weights_only=True)
    assert set(snap) == {"model", "opt", "score", "epoch"}

    ck = jckpt.Checkpointer(str(tmp_path / "j"))
    ck.arch = ARCH
    loaded, epoch, score = ck.load(fn, template)
    assert (epoch, score) == (7, 0.625)

    ours = {k: v.numpy() for k, v in state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = _np_sd(loaded.params, loaded.batch_stats)
    assert set(got) == set(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    teacher = {**state.teacher_params, **state.teacher_stats}
    got_t = _np_sd(loaded.teacher_params, loaded.teacher_stats)
    assert set(got_t) == set(teacher)
    for k, v in teacher.items():
        np.testing.assert_array_equal(got_t[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(loaded.running_conf),
                                  state.running_conf.numpy())
    assert float(loaded.slow_init) == 1.0

    kmap = jconvert.key_map(ARCH, "reference")
    momentum = export_torch._extract_momentum(loaded.opt_state)
    n = 0
    for name, p in state.model.named_parameters():
        _, path, kind = kmap[name]
        buf = state.optimizer.state[p]["momentum_buffer"].numpy()
        if kind == "conv":
            buf = buf.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(np.asarray(momentum["/".join(path)]),
                                      buf, err_msg=name)
        n += 1
    assert n == len(momentum)


def test_port_reads_what_dasac_tpu_exports(tmp_path, jax_template):
    jmodel, tx, template = jax_template
    rng = np.random.RandomState(2)
    leaves, treedef = jax.tree_util.tree_flatten(template.params)
    params = treedef.unflatten([l + 0.01 * rng.randn(*l.shape).astype(
        np.float32) for l in leaves])
    stats = jax.tree.map(lambda l: l + rng.rand(*l.shape).astype(np.float32),
                         template.batch_stats)
    grads = treedef.unflatten([0.1 * rng.randn(*l.shape).astype(np.float32)
                               for l in leaves])
    _, opt_state = tx.update(grads, tx.init(params), params)
    jstate = template.replace(
        params=params, batch_stats=stats, opt_state=opt_state,
        teacher_params=jax.tree.map(lambda l: l * 0.5 + 0.1, params),
        teacher_stats=jax.tree.map(lambda l: l * 0.5, stats),
        running_conf=jnp.linspace(0.0, 1.0, C),
        slow_init=jnp.asarray(1.0))
    snap = export_torch.export_snapshot(jstate, ARCH, score=0.5, epoch=3,
                                        model_cfg=_mcfg(2.5e-4))
    pth = str(tmp_path / "exported.pth")
    torch.save(snap, pth)

    # the SAC stage's own learning rate, not the snapshot's
    state = _port_state(lr=1e-3, seed=5)
    lrs = [(g["lr"], g["weight_decay"]) for g in state.optimizer.param_groups]
    _, epoch, score = tckpt.Checkpointer(str(tmp_path)).load(pth, state)
    assert (epoch, score) == (3, 0.5)
    assert [(g["lr"], g["weight_decay"])
            for g in state.optimizer.param_groups] == lrs

    want = _port_state(seed=6)
    train_state_from_jax(jax.tree.map(np.array, dict(
        params=jstate.params, batch_stats=jstate.batch_stats,
        teacher_params=jstate.teacher_params,
        teacher_stats=jstate.teacher_stats,
        running_conf=jstate.running_conf, slow_init=jstate.slow_init,
        step=0)), ARCH, want)
    for (k, a), b in zip(state.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k
    for store in ("teacher_params", "teacher_stats"):
        for k, v in getattr(want, store).items():
            assert torch.equal(getattr(state, store)[k], v), k
    assert torch.equal(state.running_conf, want.running_conf)
    assert state.slow_init == 1

    exported = snap["opt"]["state"]
    params_in_order = [p for g in state.optimizer.param_groups
                       for p in g["params"]]
    assert len(exported) == len(params_in_order)
    for i, p in enumerate(params_in_order):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           exported[i]["momentum_buffer"]), i


def test_best_three_last_and_an_abn_snapshot(tmp_path):
    path = str(tmp_path / "ckpt")
    ck = tckpt.Checkpointer(path, max_n=3)
    assert ck.latest_path() is None
    state = _port_state("tiny", c=5)
    tracker = tckpt.BestTracker(ck)
    for epoch, score in enumerate((0.1, 0.3, 0.2, 0.4, 0.5)):
        tracker.update(state, score, epoch)
    assert tracker.best == 0.5
    assert sorted(os.listdir(path)) == [
        "epoch001_score0.300.pth", "epoch003_score0.400.pth",
        "epoch004_score0.500.pth"]
    last = ck.save_latest(state, 0.5, 4)
    assert last == ck.latest_path() == os.path.join(path, "last.pth")
    assert not any(f.endswith(".tmp") for f in os.listdir(path))

    # an ABN state: the teacher was never initialized, so none is written;
    # loading keeps the destination's teacher and leaves slow_init at 0
    abn = _port_state("tiny", c=5, seed=1)
    _train_a_little(abn, 3)
    abn.slow_init = 0
    snap_path = ck.save(abn, 0.9, 9)
    model_keys = torch.load(snap_path, weights_only=True)["model"]
    assert not any(k.startswith("module.slow_net.") for k in model_keys)
    assert model_keys["module.slow_init"].tolist() == [0.0]

    sac = _port_state("tiny", c=5, seed=2)
    sac.slow_init = 1
    teacher0 = {k: v.clone() for k, v in sac.teacher_params.items()}
    tckpt.Checkpointer(path).load(snap_path, sac)
    assert sac.slow_init == 0
    assert all(torch.equal(v, teacher0[k])
               for k, v in sac.teacher_params.items())
    for (k, a), b in zip(sac.model.state_dict().items(),
                         abn.model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(sac.model.parameters(), abn.model.parameters()):
        assert torch.equal(sac.optimizer.state[p]["momentum_buffer"],
                           abn.optimizer.state[q]["momentum_buffer"])

    # a bare state_dict (no container) loads as the student
    bare = str(tmp_path / "bare.pth")
    torch.save(abn.model.state_dict(), bare)
    fresh = _port_state("tiny", c=5, seed=3)
    _, epoch, score = tckpt.Checkpointer(path).load(bare, fresh)
    assert (epoch, score) == (0, -1e16) and fresh.slow_init == 0
    for (k, a), b in zip(fresh.model.state_dict().items(),
                         abn.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_rejects_a_snapshot_of_another_optimizer_layout(tmp_path):
    state = _port_state("tiny", c=5)
    _train_a_little(state, 4)
    fn = tckpt.Checkpointer(str(tmp_path)).save_latest(state, 0.0, 0)
    snap = torch.load(fn, weights_only=True)
    snap["opt"]["param_groups"] = snap["opt"]["param_groups"][:3]
    torch.save(snap, fn)
    with pytest.raises(ValueError, match="param groups"):
        tckpt.Checkpointer(str(tmp_path)).load(fn, _port_state("tiny", c=5))
