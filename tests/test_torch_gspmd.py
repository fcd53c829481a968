"""Height-sharded training of the port (``TPU.PARTITION`` gspmd,
``TPU.MESH_SP``: ``core/mesh.train_mesh``/``train_groups``, the
differentiable row exchange, ``nn/spatial.py``'s frames and replays, live
BN over a sharded frame, ``sac/core.Share`` and the ``make_gspmd_*``
steps) against dasac_tpu on the CPU.

Pure Python: ``train_mesh`` gives dasac_tpu's trainer's layouts
(``dasac_tpu/train/loop.py:39-77``) and raises naming the quantities its
assertions name.

One spawned 4-rank gloo world (``tests/torch_gspmd_ranks.py``) runs:
  (a) against JAX's global-batch steps jitted with
      ``spatial_batch_sharding`` inputs over a (2, 2) mesh of the 8 CPU
      devices ``tests/conftest.py`` forces (as ``gspmd_train_step`` and its
      siblings wrap them), on the same pre-augmented inputs and weights
      (``nn/convert``): the SAC views step (2 steps: lazy init, then EMA)
      of the tiny arch without its dropout as (2, 2) and (1, 4), and of a
      shallow f32 r101 (stem, ceil pool, one block a stage, ASPP) under
      ``REMAT block`` as (2, 2); the ABN frames step (2 steps) of both as
      (2, 2); the eval and target-eval steps of the tiny arch as (2, 2).
      tests/test_torch_dist.py's bounds: src CE rtol 2e-4, ``self_ce``
      5e-3, ``teacher_diff`` 1e-3, ``pseudo_cover`` within 0.01,
      ``running_conf`` 1e-4, parameters and BN statistics rtol 1e-3 /
      atol 1e-5; the eval confusion equal once argmax ties are ignored,
      the target-eval confusions within an L1 distance of 3% of the pixels;
  (b) against the port's own one-process global step (``make_sac_step``,
      ``make_abn_step``) at JAX's gspmd bound, rtol 2e-4 / atol 2e-5, from
      raw batches through the steps' own draws (global draws, each data
      slice applied; the tiny arch's dropout masks too) at 42 rows, which
      split 10/11/10/11 over 4 ranks: 2 SAC steps of the tiny arch as
      (1, 4) and of the shallow r101 under ``REMAT convs`` as (2, 2), one
      ABN step of the shallow r101 under convs as (1, 4);
  (c) plumbing: halo gradients go back through counted exchanges
      (``exchange_bwd``), live BN reduces once a layer and a forward, the
      ``block`` replay included (17 BN layers: 34 reductions a step, as
      under none), while the replay fetches its halos again; every rank
      ends every case with bit-equal states.
The train CLI with ``TPU.PARTITION gspmd TPU.MESH_SP 2 TPU.MESH_DEVICES
4`` spawns 4 CPU ranks that print ``(gspmd 2x2)`` and end with equal
states.
"""

import concurrent.futures
import functools
import inspect
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from dasac_tpu.aug import photometric as jP
from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.core.mesh import (make_mesh_2d, replicated,
                                 spatial_batch_sharding)
from dasac_tpu.core.state import TrainState as JState
from dasac_tpu.train import loop as jloop
from dasac_tpu.train import optim as joptim
from dasac_tpu.train import steps as jsteps
from dasac_tpu.train.loop import _auto_mesh_size
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core.mesh import TrainLayout, train_mesh
from dasac_tpu_torch.data import synth
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.train import cli, loop
from dasac_tpu_torch.train import steps as tsteps
from dasac_tpu_torch.utils.sys_tools import find_free_port
from tests import torch_gspmd_ranks as R
from tests.test_torch_aug import _target_draws
from tests.test_torch_dist import JTiny, _stdout_to
from tests.test_torch_nn import ShallowDeepLab, _randomize_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "tiny_cpu.yaml")
WORLD_DEADLINE_S = 300
N_BN = 17   # the shallow r101: the stem's, and 4 a block


# ---------------------------------------------------------------------------
# pure Python: the layout rules
# ---------------------------------------------------------------------------

class _Cfg:
    def __init__(self, partition, devices, sp, batch, groups):
        self.TPU = type("TPU", (), dict(PARTITION=partition,
                                        MESH_DEVICES=devices, MESH_SP=sp))
        self.TRAIN = type("TRAIN", (), dict(BATCH_SIZE=batch,
                                            NUM_GROUPS=groups))


def _jax_layout(cfg, available):
    """dasac_tpu's single-process rule (loop.py:46-75): ``(n_data,
    n_sp)``, or the message of the assertion it fails."""
    if cfg.TPU.PARTITION != "gspmd":
        n = cfg.TPU.MESH_DEVICES or _auto_mesh_size(
            available, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_GROUPS)
        return n, 1
    n_sp = max(1, int(cfg.TPU.MESH_SP))
    n_dev = cfg.TPU.MESH_DEVICES or n_sp * _auto_mesh_size(
        available // n_sp, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_GROUPS)
    if n_dev % n_sp:
        return ("TPU.MESH_DEVICES=%d must be divisible by TPU.MESH_SP=%d"
                % (n_dev, n_sp))
    return n_dev // n_sp, n_sp


@pytest.mark.parametrize("partition", ["shard_map", "gspmd"])
def test_train_mesh_matches_jax_rules(partition):
    src = inspect.getsource(jloop.Trainer.__init__)
    assert "must be divisible by TPU.MESH_SP=%d" in src
    for available in (1, 2, 4, 8):
        for devices in (0, 2, 4, 6):
            for sp in (1, 2, 4):
                for batch, groups in ((8, 4), (4, 2), (6, 2), (2, 2)):
                    cfg = _Cfg(partition, devices, sp, batch, groups)
                    want = _jax_layout(cfg, available)
                    if isinstance(want, str):
                        with pytest.raises(ValueError, match=want):
                            train_mesh(cfg, available)
                        continue
                    n_data = want[0]
                    if batch % n_data or groups % n_data:
                        # the port's loaders slice both batch dimensions
                        with pytest.raises(ValueError, match=(
                                "TRAIN.(BATCH_SIZE|NUM_GROUPS)=%d must be "
                                "divisible by the %d" % (
                                    batch if batch % n_data else groups,
                                    n_data))):
                            train_mesh(cfg, available)
                        continue
                    lay = train_mesh(cfg, available)
                    assert (lay.n_data, lay.n_sp) == want
                    assert lay.gspmd == (partition == "gspmd")
                    # rank r sits where make_mesh_2d puts device r
                    grid = np.arange(lay.ranks).reshape(lay.n_data,
                                                        lay.n_sp)
                    for r in range(lay.ranks):
                        assert tuple(np.argwhere(grid == r)[0]) == \
                            lay.coords(r)


def test_train_mesh_joined_world_keeps_sp_inside_a_host():
    src = inspect.getsource(jloop.Trainer.__init__)
    assert "must divide the %d local devices per" in src
    assert "-way data axis" in src
    cfg = _Cfg("gspmd", 0, 4, 8, 4)
    assert train_mesh(cfg, 1, world=8, n_local=8) == TrainLayout(2, 4, True)
    with pytest.raises(ValueError, match="TPU.MESH_SP=4 must divide the 2 "
                                         "local devices per"):
        train_mesh(cfg, 1, world=8, n_local=2)
    with pytest.raises(ValueError, match="TRAIN.NUM_GROUPS=4 must be "
                                         "divisible by the 8-way data axis"):
        train_mesh(_Cfg("gspmd", 0, 1, 8, 4), 1, world=8)


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------

MESH = make_mesh_2d(2, 2)
BATCH = spatial_batch_sharding(MESH)
REPL = replicated(MESH)
VIEWS = jpipe.TargetViews(BATCH, BATCH, BATCH, NamedSharding(MESH, PS("data")),
                          NamedSharding(MESH, PS("data")), BATCH)
JMODELS = {"tiny": JTiny, "r101": lambda: ShallowDeepLab(R.C)}
ARCH = {"tiny": "tiny", "r101": R.R101}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """Weights, frames, views and draws from seeds, shared by the ranks
    (whole global batches: each rank takes its slice) and JAX."""
    rng = np.random.RandomState(0)

    def init(name, seed):
        v = jax.jit(lambda k: JMODELS[name]().init({"params": k}, jnp.zeros(
            (1, R.H, R.W, 3))))(jax.random.PRNGKey(0))
        return _randomize_stats(v, seed)

    def frames(n, lo_rows):
        x = rng.randn(n, R.H, R.W, 3).astype(np.float32)
        y = rng.randint(0, R.C, (n, R.H, R.W)).astype(np.int32)
        y[:, :lo_rows] = 255
        return x, y

    variables = {k: {"student": _np(init(k, 1))} for k in JMODELS}
    teacher = _np(init("tiny", 2))
    src, tgt = frames(R.B_SRC, 6), frames(R.B_SRC, 4)
    imgs = rng.randint(0, 256, (R.G, R.H, R.W, 3)).astype(np.uint8)
    labels = rng.randint(0, R.C, (R.G, R.H, R.W)).astype(np.int32)
    labels[:, :6] = 255
    views = _np(jax.jit(functools.partial(
        jpipe.augment_target_groups, group_size=R.T, blur=True, jitter=0.4,
        greyscale=0.3))(jax.random.PRNGKey(42), imgs, labels))

    # eval: argmax ties (top-2 gap under 1e-4) ignored
    ev_imgs = rng.randint(0, 256, (4, R.H, R.W, 3)).astype(np.uint8)
    ev_labels = rng.randint(0, R.C, (4, R.H, R.W)).astype(np.int32)
    scfg = R.eval_scfg(jsteps)
    _, up = jax.jit(lambda v, im: JTiny().apply(v, jP.normalize(
        im.astype(jnp.float32) / 255.0, scfg.mean, scfg.std)))(
        variables["tiny"]["student"], ev_imgs)
    top2 = np.sort(np.asarray(up), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < 1e-4
    assert tie.mean() < 0.01
    ev_labels = np.where(tie, 255, ev_labels).astype(np.int32)

    te_imgs = rng.randint(0, 256, (R.G, R.H, R.W, 3)).astype(np.uint8)
    te_labels = rng.randint(0, R.C, (R.G, R.H, R.W)).astype(np.int32)
    te_labels[:, :4] = 255
    te_key = np.asarray(jax.random.PRNGKey(21))
    # the global batch's draws: the gspmd step does not fold the key
    te_draws = _np(jax.jit(lambda k: _target_draws(
        k, R.G, R.T, target_scale=scfg.target_scale, zoom=scfg.zoom,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale))(te_key))
    return dict(vars=variables, teacher=teacher,
                running_conf=rng.uniform(0.01, 0.2, R.C).astype(np.float32),
                src=src, tgt=tgt, views=tuple(views), ev=(ev_imgs, ev_labels),
                te=(te_imgs, te_labels), te_key=te_key, te_draws=te_draws)


def _jstate(variables, mc, teacher=None, running_conf=None):
    params = variables["student"]["params"]
    tx, _ = joptim.build_optimizer(mc, "tiny", params)
    t = teacher or variables["student"]
    state = JState(
        params=params, batch_stats=variables["student"]["batch_stats"],
        teacher_params=t["params"], teacher_stats=t["batch_stats"],
        opt_state=tx.init(params),
        running_conf=np.zeros(R.C, np.float32) if running_conf is None
        else running_conf,
        slow_init=np.float32(0.0 if teacher is None else 1.0),
        step=np.int32(0))
    return jax.tree.map(jnp.asarray, state), tx


def _ref_train(inp, kind, model):
    """JAX's global-batch SAC views or ABN frames step, jitted over the
    (2, 2) mesh with the batch sharded over data and height over sp."""
    mc = R.MC if kind == "sac" else R.MCAbn
    jstate, tx = _jstate(inp["vars"][model], mc)
    if kind == "sac":
        fn = jsteps.make_sac_views_step(JMODELS[model](), tx,
                                        R.sac_scfg(jsteps, "xla"), None)
        step = jax.jit(fn, in_shardings=(REPL, BATCH, BATCH, VIEWS, REPL),
                       out_shardings=(REPL, REPL))
        args = (*inp["src"], jpipe.TargetViews(*inp["views"]))
    else:
        fn = jsteps.make_abn_frames_step(JMODELS[model](), tx,
                                         R.abn_scfg(jsteps, "xla"), None)
        step = jax.jit(fn, in_shardings=(REPL,) + (BATCH,) * 4 + (REPL,),
                       out_shardings=(REPL, REPL))
        args = (*inp["src"], *inp["tgt"])
    metrics = []
    for _ in range(R.ITERS):
        jstate, jm = step(jstate, *args, jax.random.PRNGKey(7))
        metrics.append(_np(jm))
    return _np(jstate), metrics


def _ref_eval(inp):
    jstate, _ = _jstate(inp["vars"]["tiny"], R.MC, teacher=inp["teacher"],
                        running_conf=inp["running_conf"])
    scfg = R.eval_scfg(jsteps)
    conf = jsteps.gspmd_eval_step(jsteps.make_eval_step(JTiny(), scfg),
                                  MESH)(jstate, *inp["ev"])
    confs = jsteps.gspmd_target_eval_step(
        jsteps.make_target_eval_step(JTiny(), scfg), MESH)(
        jstate, *inp["te"], inp["te_key"])
    return _np(conf), _np(confs)


def _ref_own(case):
    """The port's one-process global step of a (b) case."""
    kind, model, _, _ = case
    state = R.own_state(model)
    make = tsteps.make_sac_step if kind == "sac" else tsteps.make_abn_step
    metrics = R.run_own(kind, state, R.own_batch(),
                        make(R.own_scfg(kind), "cpu"))
    return metrics, {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}, \
        state.running_conf.clone()


@pytest.fixture(scope="module", autouse=True)
def _lean_ranks():
    """One intra-op thread a process, for the ranks this module spawns
    (they inherit the environment)."""
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def refs(inputs):
    """JAX's references and the port's one-process ones, computed on a
    thread while the ranks work: a future."""

    def compute():
        out = {("jax", k, m): _ref_train(inputs, k, m)
               for k, m in (("sac", "tiny"), ("sac", "r101"), ("abn", "tiny"),
                            ("abn", "r101"))}
        out["eval"] = _ref_eval(inputs)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for case in R.OWN_CASES:
                out[("own",) + case] = _ref_own(case)
        finally:
            torch.set_num_threads(threads)
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(compute)
        yield future
        future.result()


@pytest.fixture(scope="module")
def world(inputs, refs, tmp_path_factory):
    """Each rank's results, and the references."""
    out = tmp_path_factory.mktemp("world")
    ctx = torch.multiprocessing.spawn(
        R.world_main, args=("127.0.0.1:%d" % find_free_port(), str(out),
                            inputs), nprocs=R.WORLD, join=False)
    deadline = time.monotonic() + WORLD_DEADLINE_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the %d-rank world did not finish in %d s"
                        % (R.WORLD, WORLD_DEADLINE_S))
    ranks = [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
             for r in range(R.WORLD)]
    return ranks, refs.result()


def _sd(tree, model):
    return {k: v.numpy() for k, v in
            from_jax_variables(tree, ARCH[model]).items()
            if not k.endswith("num_batches_tracked")}


def test_world_coordinates():
    lay = TrainLayout(2, 2, True)
    assert [lay.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]


@pytest.mark.parametrize("case", [c for c in R.JAX_CASES if c[0] == "sac"],
                         ids="-".join)
def test_sac_views_step_matches_jax_gspmd(world, case):
    ranks, refs = world
    _, model, _, _ = case
    jstate, jmetrics = refs[("jax", "sac", model)]
    for out in (r["jax"][case] for r in ranks):
        assert out["equal"] > 0
        for it, jm in enumerate(jmetrics):
            tm, msg = out["metrics"][it], "iter %d " % it
            np.testing.assert_allclose(float(tm["src_loss_ce"]),
                                       jm["src_loss_ce"], rtol=2e-4,
                                       atol=1e-6, err_msg=msg + "src CE")
            np.testing.assert_allclose(float(tm["self_ce"]), jm["self_ce"],
                                       rtol=5e-3, atol=1e-5,
                                       err_msg=msg + "self_ce")
            np.testing.assert_allclose(float(tm["teacher_diff"]),
                                       jm["teacher_diff"], rtol=1e-3,
                                       atol=1e-5, err_msg=msg + "diff")
            assert abs(float(tm["pseudo_cover"])
                       - jm["pseudo_cover"]) < 0.01, msg
        np.testing.assert_allclose(out["state"]["running_conf"].numpy(),
                                   jstate.running_conf, rtol=1e-4, atol=1e-6)
        for name, ref in _sd({"params": jstate.params}, model).items():
            np.testing.assert_allclose(out["state"]["model"][name].numpy(),
                                       ref, rtol=1e-3, atol=1e-5,
                                       err_msg="student " + name)
        for name, ref in _sd({"params": jstate.teacher_params},
                             model).items():
            np.testing.assert_allclose(out["state"]["teacher"][name].numpy(),
                                       ref, rtol=1e-3, atol=1e-5,
                                       err_msg="teacher " + name)
    assert jmetrics[-1]["pseudo_cover"] > 0.05, "no pseudo-labels to compare"


@pytest.mark.parametrize("case", [c for c in R.JAX_CASES if c[0] == "abn"],
                         ids="-".join)
def test_abn_frames_step_matches_jax_gspmd(world, case):
    ranks, refs = world
    _, model, _, _ = case
    jstate, jmetrics = refs[("jax", "abn", model)]
    ref = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats},
              model)
    for out in (r["jax"][case] for r in ranks):
        assert out["equal"] > 0
        for it, jm in enumerate(jmetrics):
            for k in ("src_loss_ce", "loss_ce"):
                np.testing.assert_allclose(float(out["metrics"][it][k]),
                                           jm[k], rtol=2e-4, atol=1e-6,
                                           err_msg=k)
        for name, r in ref.items():
            np.testing.assert_allclose(out["state"]["model"][name].numpy(),
                                       r, rtol=1e-3, atol=1e-5, err_msg=name)


def test_eval_confusion_matches_jax_gspmd(world, inputs):
    ranks, refs = world
    conf, _ = refs["eval"]
    case = ("eval", "tiny", "2x2", "none")
    for r in ranks:
        assert r["jax"][case].dtype == torch.int64
        np.testing.assert_array_equal(r["jax"][case].numpy(), conf)
    # every labelled pixel counted once over the 4 ranks' rows
    assert int(conf.sum()) == int((inputs["ev"][1] != 255).sum())


def test_target_eval_confusions_match_jax_gspmd(world):
    ranks, refs = world
    _, confs = refs["eval"]
    case = ("target_eval", "tiny", "2x2", "none")
    n_pix = R.G * R.T * R.H * R.W
    assert set(ranks[0]["jax"][case]) == set(confs)
    for layer, ref in confs.items():
        assert ref.sum() > 0.05 * n_pix, layer
        for r in ranks:
            ours = r["jax"][case][layer].numpy()
            assert np.abs(ours - ref).sum() <= 0.03 * n_pix, layer


@pytest.mark.parametrize("case", R.OWN_CASES[:3], ids="-".join)
def test_gspmd_step_equals_the_one_process_global_step(world, case):
    """Global draws, uneven strips, remat convs: JAX's gspmd bound."""
    ranks, refs = world
    metrics, sd, rc = refs[("own",) + case]
    for out in (r["own"][case] for r in ranks):
        assert out["equal"] > 0
        for it, ref in enumerate(metrics):
            for k, v in ref.items():
                torch.testing.assert_close(out["metrics"][it][k].float(),
                                           v.float(), rtol=2e-4, atol=2e-5,
                                           msg="iter %d %s" % (it, k))
        torch.testing.assert_close(out["state"]["running_conf"], rc,
                                   rtol=2e-4, atol=2e-5)
        for k, v in sd.items():
            torch.testing.assert_close(out["state"]["model"][k], v,
                                       rtol=2e-4, atol=2e-5, msg=k)
    if case[0] == "sac":
        assert float(metrics[-1]["pseudo_cover"]) > 0.05


def test_halo_gradients_flow_back_through_counted_exchanges(world):
    ranks, _ = world
    for r in ranks:
        for case, out in list(r["jax"].items()) + list(r["own"].items()):
            if case[0] in ("sac", "abn"):
                calls = out["calls"]
                assert calls["exchange_bwd"] > 0, case
                assert calls["exchange_bwd_conv"] > 0, case
                assert calls["exchange_bwd_bytes"] > 0, case
                # a step: one flat sum of the gradients, one of the
                # metrics; SAC's running confidence, and its batch-mean
                # confidence over the data axis when there is one
                steps = (R.ITERS if case in r["jax"] or case[0] == "sac"
                         else 1)
                want = 2 if case[0] == "abn" else 3 + (case[2] == "2x2")
                assert calls["sum"] == want * steps, (case, calls["sum"])


def test_live_bn_reduces_once_a_layer_replay_included(world):
    """17 BN layers: one reduction a layer a forward (the source pass and
    the target pass), one in the backward, under block as under none; the
    block replay fetches its halos again."""
    ranks, _ = world
    for r in ranks:
        block = r["jax"][("abn", "r101", "2x2", "block")]["calls"]
        none = r["own"][("abn", "r101", "2x2", "none")]["calls"]
        assert block["bn"] == 2 * N_BN * R.ITERS
        assert block["bn_grad"] == N_BN * R.ITERS
        assert none["bn"] == 2 * N_BN and none["bn_grad"] == N_BN
        assert block["exchange"] / R.ITERS > none["exchange"]


# ---------------------------------------------------------------------------
# the train CLI over a (2, 2) world
# ---------------------------------------------------------------------------

def test_cli_spawns_a_2x2_gspmd_world(tmp_path):
    root = synth.make_synthetic_root(str(tmp_path / "root"), hw=(48, 64),
                                     n_train_src=4, n_train_tgt=4, n_val=2,
                                     val_hw=(32, 48))
    argv = ["--cfg", TINY_CFG, "--snapshot-dir", str(tmp_path / "snap"),
            "--logdir", str(tmp_path / "logs"), "--exp", "e", "--run", "g",
            "--workers", "1", "--set", "DATASET.ROOT", root,
            "TRAIN.NUM_EPOCHS", "1", "TRAIN.NUM_GROUPS", "2",
            "LOG.ITER_TARGET", "1", "TPU.NATIVE_LOADER", "False",
            "TPU.PARTITION", "gspmd", "TPU.MESH_SP", "2",
            "TPU.MESH_DEVICES", "4"]
    tconfig.reset_cfg()
    tconfig.cfg_from_file(TINY_CFG)
    tconfig.cfg_from_list(argv[argv.index("--set") + 1:])
    try:
        assert loop.mesh_size(tconfig.cfg, 1) == TrainLayout(2, 2, True)
    finally:
        tconfig.reset_cfg()
    log = _stdout_to(str(tmp_path / "g.log"),
                     lambda: cli.main(argv, device="cpu"))
    assert log.count("Mesh: 4 device(s) / 4 process(es) (gspmd 2x2)") == 4
    assert log.count("Replicas equal: ") == 4, log[-2000:]
    snaps = tmp_path / "snap" / "default" / "e" / "g"
    assert torch.load(snaps / "last.pth", weights_only=True)["epoch"] == 2
