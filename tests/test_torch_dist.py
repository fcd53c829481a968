"""Data-parallel training of the port (``core/dist.py``, and the process
group threaded through ``nn``, ``sac``, ``train`` and ``data``) against
dasac_tpu's shard_map steps on the CPU.

Pure Python: ``resolve_dist_env`` gives root ``train.resolve_dist_env``'s
answers on the cases of ``tests/test_dist_env.py``; ``auto_mesh_size``
equals ``dasac_tpu.train.loop._auto_mesh_size``; ``val_loader(
distributed=True)`` splits 10 images over 4 ranks as 4/2/2/2 with
dasac_tpu's indices.

One spawned 2-rank gloo world runs the module checks, each held against
the same step of dasac_tpu built with ``axis_name="data"`` inside
``shard_map`` over a 2-device mesh (as ``shard_train_step`` wraps it), on
the same per-shard inputs and weights:
  * ``SyncBatchNorm`` (8 channels, 64x64): output and running statistics
    within 1e-5 (tests/test_torch_nn.py's BN bound), each rank's input and
    parameter gradients within a relative norm error of 2e-2
    (tests/test_torch_step.py's gradient bound);
  * ``make_abn_frames_step``, 2 steps: losses rtol 2e-4, parameters and BN
    statistics rtol 1e-3 / atol 1e-5 (tests/test_torch_abn.py);
  * ``make_sac_views_step``, 2 steps (teacher lazy init, then EMA): source
    CE rtol 2e-4, ``self_ce`` rtol 5e-3, ``teacher_diff`` rtol 1e-3,
    ``pseudo_cover`` within 0.01 (pseudo-labels differ on < 1% of pixels),
    ``running_conf`` rtol 1e-4, student and teacher rtol 1e-3 / atol 1e-5
    (tests/test_torch_step.py);
  * the eval confusion, summed over the ranks, equal to the psum'd one
    once argmax ties (top-2 gap under 1e-4) are ignored; the four
    target-eval confusions, each rank augmenting with the draws of its
    shard's folded key, within an L1 distance of 3% of the pixels (two
    counts per differing pixel: labels differ after the warp on < 0.5%,
    argmax ties or pseudo-labels on < 1%, tests/test_torch_eval.py);
  * both ranks hold bit-equal states after the steps.
The model is the tiny arch without its channel dropout on both sides (the
two packages draw dropout masks from different generators).

The train CLI with ``TPU.MESH_DEVICES 2`` spawns two CPU ranks: events and
snapshots come from rank 0 alone, with the single-process run's tag set,
and both ranks end with equal states.  The same world then resumes it with
``--resume auto --multiprocessing-distributed`` (the environment set as
torchrun sets it).

The ranks start lean: one intra-op thread each (tiny convolutions are
several times slower on more here), and TensorFlow hidden from them:
tensorboard, which the writers mirror to, imports it when it finds it
(~17 s a process on a CPU host that has it) and otherwise uses its own
stub, as on a machine without TensorFlow.
"""

import concurrent.futures
import functools
import glob
import json
import os
import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import shard_map
from jax.sharding import PartitionSpec as PS

import train as jtrain
from dasac_tpu.aug import photometric as jP
from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.core.mesh import make_mesh
from dasac_tpu.core.state import TrainState as JState
from dasac_tpu.data import host_loader as jhost
from dasac_tpu.nn import functional as jF
from dasac_tpu.nn.layers import SyncBatchNorm as JBN
from dasac_tpu.train import optim as joptim
from dasac_tpu.train import steps as jsteps
from dasac_tpu.train.loop import _auto_mesh_size
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.data import synth
from dasac_tpu_torch.data.factory import Loaders
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.train import cli
from dasac_tpu_torch.utils.sys_tools import find_free_port
from tests import torch_dist_ranks as ranks_lib
from tests.test_torch_aug import _target_draws
from tests.test_torch_nn import _randomize_stats
from tests.torch_dist_ranks import (B_SRC, B_TGT, C, G, H, ITERS, T, W,
                                    WIDTH, WORLD, MC, MCAbn, shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "tiny_cpu.yaml")
AXIS = "data"


class JTiny(fnn.Module):
    """dasac_tpu's ``TinySeg`` without its dropout."""

    num_classes: int = C
    width: int = WIDTH
    axis_name: Optional[str] = None

    @fnn.compact
    def __call__(self, x, train=False, update_stats=False):
        h, w = x.shape[-3], x.shape[-2]
        y = fnn.Conv(self.width, (3, 3), strides=2, name="conv_a")(x)
        y = fnn.relu(JBN(self.width, axis_name=self.axis_name,
                         name="bn_a")(y, not update_stats))
        y = fnn.Conv(self.width, (3, 3), strides=2, name="conv_b")(y)
        y = fnn.relu(JBN(self.width, axis_name=self.axis_name,
                         name="bn_b")(y, not update_stats))
        logits = fnn.Conv(self.num_classes, (1, 1), name="aspp")(y)
        logits = logits.astype(jnp.float32)
        return logits, jF.resize_bilinear_align_corners(logits, (h, w))


@pytest.fixture(scope="module", autouse=True)
def _lean_ranks(tmp_path_factory):
    """One thread a process, and an importable ``tensorflow`` that refuses
    to load, for the ranks this module spawns (they inherit the
    environment and ``sys.path``) and for its own CLI run."""
    fake = tmp_path_factory.mktemp("no_tf")
    (fake / "tensorflow").mkdir()
    (fake / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('hidden from the test ranks')\n")
    env = os.environ.get("OMP_NUM_THREADS")
    threads = torch.get_num_threads()
    sys.path.insert(0, str(fake))
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    sys.path.remove(str(fake))
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module", autouse=True)
def _keep_native_loader_flag():
    """The port's Loaders set its process-global native-decoder flag from
    TPU.NATIVE_LOADER (False here): put it back for the tests that follow
    in this process."""
    from dasac_tpu_torch.data import native

    enabled = native.enabled()
    yield
    native.set_enabled(enabled)


# ---------------------------------------------------------------------------
# pure Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "host0:1234", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2", "MASTER_ADDR": "other", "WORLD_SIZE": "8",
     "RANK": "7"},
    {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "2",
     "RANK": "1"},
    {"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "2", "RANK": "0"},
    {"MASTER_ADDR": "stale"},
    {"WORLD_SIZE": "4", "RANK": "0"},
    {},
], ids=["jax_vars_win", "torch_style", "default_port", "stale_addr",
        "stale_world", "empty"])
def test_resolve_dist_env_matches_train(env):
    assert dist.resolve_dist_env(env) == jtrain.resolve_dist_env(env)


def test_launch_from_env_needs_a_complete_launch():
    assert dist.launch_from_env({
        "MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "2", "RANK": "1",
        "LOCAL_RANK": "1"}) == dist.Launch("10.0.0.1:12355", 2, 1, 1)
    with pytest.raises(ValueError, match="MASTER_ADDR, WORLD_SIZE and RANK"):
        dist.launch_from_env({"MASTER_ADDR": "stale"})


@pytest.mark.parametrize("available", [1, 2, 3, 4, 8])
def test_auto_mesh_size_matches_jax(available):
    for batch in (1, 2, 3, 4, 6, 8, 12, 16):
        for groups in (1, 2, 3, 4, 8):
            assert dist.auto_mesh_size(available, batch, groups) == \
                _auto_mesh_size(available, batch, groups)


def test_val_loader_distributed_splits_10_images_4_2_2_2(tmp_path):
    """As tests/test_e2e_train.py pins for dasac_tpu: per-rank batch 2,
    global stride 8; the indices equal dasac_tpu's loader's."""
    root = synth.make_synthetic_root(str(tmp_path / "root"), n_train_src=2,
                                     n_train_tgt=2, n_val=10, hw=(8, 12))
    tconfig.reset_cfg()
    try:
        tconfig.cfg_from_file(TINY_CFG)
        tconfig.cfg_from_list(["DATASET.ROOT", root, "TPU.NATIVE_LOADER",
                               "False"])
        real, seen = [], []
        for rank in range(4):
            loaders = Loaders(tconfig.cfg, num_replicas=4, rank=rank)
            loader = loaders.val_loader("val_cityscapes", batch_size=2,
                                        distributed=True)
            ref = jhost.padded_plain_loader(loaders.val["val_cityscapes"],
                                            2, 1, 1, num_replicas=4,
                                            rank=rank)
            assert len(loader) == len(ref) == 2
            for bi in range(len(loader)):
                assert loader.index_fn(bi) == ref.index_fn(bi)
                seen += [i for i in loader.index_fn(bi) if i >= 0]
            real.append(loader.n_real)
    finally:
        tconfig.reset_cfg()
    assert real == [4, 2, 2, 2]
    assert sorted(seen) == list(range(10))


# ---------------------------------------------------------------------------
# the 2-rank world, against shard_map
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """Weights, frames, views and draws, made with numpy and jax.random
    from seeds; shared by the ranks (whole batches, each rank takes its
    shard) and the shard_map reference."""
    rng = np.random.RandomState(0)
    init = jax.jit(lambda k: JTiny().init({"params": k}, jnp.zeros(
        (1, H, W, 3))))(jax.random.PRNGKey(0))
    student = _randomize_stats(init, 1)
    teacher = _randomize_stats(init, 2)

    def frames(n, lo_rows):
        x = rng.randn(n, H, W, 3).astype(np.float32)
        y = rng.randint(0, C, (n, H, W)).astype(np.int32)
        y[:, :lo_rows] = 255
        return x, y

    src = frames(B_SRC, 6)
    tgt = frames(B_TGT, 4)
    imgs = rng.randint(0, 256, (G, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, C, (G, H, W)).astype(np.int32)
    labels[:, :6] = 255
    views = _np(jax.jit(functools.partial(
        jpipe.augment_target_groups, group_size=T, blur=True, jitter=0.4,
        greyscale=0.3))(jax.random.PRNGKey(42), imgs, labels))

    # eval: 4 frames, argmax ties ignored (top-2 gap of the scores < 1e-4)
    ev_imgs = rng.randint(0, 256, (4, H, W, 3)).astype(np.uint8)
    ev_labels = rng.randint(0, C, (4, H, W)).astype(np.int32)
    _, up = jax.jit(lambda v, im: JTiny().apply(v, jP.normalize(
        im.astype(jnp.float32) / 255.0, (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225))))(student, ev_imgs)
    top2 = np.sort(np.asarray(up), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < 1e-4
    assert tie.mean() < 0.01
    ev_labels = np.where(tie, 255, ev_labels).astype(np.int32)

    te_imgs = rng.randint(0, 256, (G, H, W, 3)).astype(np.uint8)
    te_labels = rng.randint(0, C, (G, H, W)).astype(np.int32)
    te_labels[:, :4] = 255
    te_key = np.asarray(jax.random.PRNGKey(21))
    scfg = ranks_lib.eval_scfg(jsteps)
    draws = jax.jit(lambda k: _target_draws(
        k, G // WORLD, T, target_scale=scfg.target_scale, zoom=scfg.zoom,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale))
    # shard_map folds the shard's index into the key (steps._fold_axis)
    te_draws = [_np(draws(jax.random.fold_in(te_key, r)))
                for r in range(WORLD)]

    bn_x = (rng.randn(4, H, W, WIDTH) * 1.5 + 0.3).astype(np.float32)
    bn_w = rng.randn(4, H, W, WIDTH).astype(np.float32)
    return dict(student=_np(student), teacher=_np(teacher),
                running_conf=rng.uniform(0.01, 0.2, C).astype(np.float32),
                src=src, tgt=tgt, views=tuple(views),
                ev=(ev_imgs, ev_labels), te=(te_imgs, te_labels),
                te_key=te_key, te_draws=te_draws, bn=(bn_x, bn_w))


def _sharded(fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=make_mesh(WORLD), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _jstate(inp, mc, teacher=None, running_conf=None):
    params = inp["student"]["params"]
    tx, _ = joptim.build_optimizer(mc, "tiny", params)
    t = teacher or inp["student"]
    state = JState(
        params=params, batch_stats=inp["student"]["batch_stats"],
        teacher_params=t["params"], teacher_stats=t["batch_stats"],
        opt_state=tx.init(params),
        running_conf=np.zeros(C, np.float32) if running_conf is None
        else running_conf,
        slow_init=np.float32(0.0 if teacher is None else 1.0),
        step=np.int32(0))
    return jax.tree.map(jnp.asarray, state), tx


def _ref_bn(inp):
    bn_x, bn_w = inp["bn"]
    p = inp["student"]
    params = {k: p["params"]["bn_a"][k] for k in ("scale", "bias")}
    stats = {k: p["batch_stats"]["bn_a"][k] for k in ("mean", "var")}
    bn = JBN(WIDTH, axis_name=AXIS)

    def body(params, stats, x, wgt):
        def loss(params, x):
            y, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                              use_running_average=False,
                              mutable=["batch_stats"])
            return jnp.sum(y * wgt), (y, mut["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, new, jax.tree.map(lambda g: g[None], gp), gx

    return _np(_sharded(body, (PS(), PS(), PS(AXIS), PS(AXIS)),
                        (PS(AXIS), PS(), PS(AXIS), PS(AXIS)))(
        params, stats, bn_x, bn_w))


def _ref_abn(inp):
    jstate, tx = _jstate(inp, MCAbn)
    step = _sharded(jsteps.make_abn_frames_step(
        JTiny(axis_name=AXIS), tx, ranks_lib.abn_scfg(jsteps, "xla"), AXIS),
        (PS(),) + (PS(AXIS),) * 4 + (PS(),), (PS(), PS()))
    frames = [jnp.asarray(a) for a in (*inp["src"], *inp["tgt"])]
    metrics = []
    for it in range(ITERS):
        jstate, jm = step(jstate, *frames, jax.random.PRNGKey(it))
        metrics.append(_np(jm))
    return _np(jstate), metrics


def _ref_sac(inp):
    jstate, tx = _jstate(inp, MC)
    step = _sharded(jsteps.make_sac_views_step(
        JTiny(axis_name=AXIS), tx, ranks_lib.sac_scfg(jsteps, "xla"), AXIS),
        (PS(), PS(AXIS), PS(AXIS), PS(AXIS), PS()), (PS(), PS()))
    views = jpipe.TargetViews(*(jnp.asarray(a) for a in inp["views"]))
    src = [jnp.asarray(a) for a in inp["src"]]
    metrics = []
    for _ in range(ITERS):
        jstate, jm = step(jstate, *src, views, jax.random.PRNGKey(7))
        metrics.append(_np(jm))
    return _np(jstate), metrics


def _ref_eval(inp):
    jstate, _ = _jstate(inp, MC, teacher=inp["teacher"],
                        running_conf=inp["running_conf"])
    scfg = ranks_lib.eval_scfg(jsteps)
    mesh = make_mesh(WORLD)
    conf = jsteps.shard_eval_step(
        jsteps.make_eval_step(JTiny(axis_name=AXIS), scfg, AXIS), mesh)(
        jstate, *map(jnp.asarray, inp["ev"]))
    confs = jsteps.shard_target_eval_step(
        jsteps.make_target_eval_step(JTiny(axis_name=AXIS), scfg, AXIS),
        mesh)(jstate, *map(jnp.asarray, inp["te"]), inp["te_key"])
    return _np(conf), _np(confs)


def _stdout_to(path, fn):
    """Run ``fn`` with file descriptor 1, which spawned ranks inherit,
    going to ``path``; returns what was written there."""
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            fn()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
    with open(path) as f:
        return f.read()


def _argv(root, out, run, extra=(), sets=()):
    return ["--cfg", TINY_CFG, "--snapshot-dir", str(out / "snap"),
            "--logdir", str(out / "logs"), "--exp", "e", "--run", run,
            "--workers", "2", *extra, "--set", "DATASET.ROOT", root,
            "TRAIN.NUM_EPOCHS", "1", "TRAIN.NUM_GROUPS", "2",
            "LOG.ITER_TARGET", "1", "TPU.NATIVE_LOADER", "False", *sets]


def _events(logdir):
    """{(writer, tag): [step, ...]} over the run's events.jsonl files."""
    out = {}
    for p in glob.glob(os.path.join(logdir, "**", "events.jsonl"),
                       recursive=True):
        writer = os.path.basename(os.path.dirname(p))
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                out.setdefault((writer, rec["tag"]), []).append(rec["step"])
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The inputs and the shard_map references, computed on a thread while
    the CLI runs and the ranks work: a future of ``(inputs, refs)``."""

    def compute():
        inp = _inputs()
        return inp, dict(bn=_ref_bn(inp), abn=_ref_abn(inp),
                         sac=_ref_sac(inp), eval=_ref_eval(inp))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(compute)
        yield future
        future.result()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The tiny train CLI in this process, and with TPU.MESH_DEVICES 2 as
    two spawned CPU ranks: the second's output, events and snapshots as
    they were at its end."""
    out = tmp_path_factory.mktemp("cli")
    root = synth.make_synthetic_root(str(out / "root"), hw=(48, 64),
                                     n_train_src=4, n_train_tgt=4, n_val=2,
                                     val_hw=(32, 48))
    cli.main(_argv(root, out, "one"), device="cpu")
    argv = _argv(root, out, "two", sets=["TPU.MESH_DEVICES", "2"])
    log = _stdout_to(str(out / "two.log"),
                     lambda: cli.main(argv, device="cpu"))
    logs = out / "logs" / "default" / "e"
    snaps = out / "snap" / "default" / "e" / "two"
    return dict(out=out, root=root, log=log,
                events={run: _events(str(logs / run))
                        for run in ("one", "two")},
                snaps=sorted(os.listdir(snaps)),
                last=torch.load(snaps / "last.pth", weights_only=True))


@pytest.fixture(scope="module")
def world(jax_side, cli_runs):
    """The 2-rank gloo world: each rank's check results and the log of its
    ``--resume auto`` of the CLI's 2-rank run; with the inputs and the
    shard_map references."""
    out_dir = str(cli_runs["out"] / "world")
    os.makedirs(out_dir)
    resume = _argv(cli_runs["root"], cli_runs["out"], "two",
                   extra=["--resume", "auto"],
                   sets=["TRAIN.NUM_EPOCHS", "2"])
    addr = "127.0.0.1:%d" % find_free_port()
    inputs = jax_side.result()[0]
    log = _stdout_to(os.path.join(out_dir, "world.log"), lambda: (
        torch.multiprocessing.spawn(
            ranks_lib.world_main, args=(addr, out_dir, inputs, resume,
                                        find_free_port()),
            nprocs=WORLD, join=True)))
    ranks = [torch.load(os.path.join(out_dir, "rank%d.pt" % r),
                        weights_only=False) for r in range(WORLD)]
    return ranks, log, jax_side.result()[1], inputs


def _sd(tree):
    return {k: v.numpy() for k, v in from_jax_variables(tree, "tiny").items()
            if not k.endswith("num_batches_tracked")}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def test_sync_bn_matches_pmean_statistics(world):
    ranks, _, refs, _ = world
    y, new, gp, gx = refs["bn"]
    for r, out in enumerate(ranks):
        o = out["bn"]
        np.testing.assert_allclose(o["y"].numpy(), shard(y, r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["mean"].numpy(), new["mean"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["var"].numpy(), new["var"], rtol=1e-5,
                                   atol=1e-5)
        assert o["count"] == 1
        assert _rel(o["gx"].numpy(), shard(gx, r)) < 2e-2, r
        assert _rel(o["gscale"].numpy(), gp["scale"][r]) < 2e-2, r
        assert _rel(o["gbias"].numpy(), gp["bias"][r]) < 2e-2, r
    # each rank's gradients are its own: the shards' x differ
    assert not np.allclose(ranks[0]["bn"]["gscale"], ranks[1]["bn"]["gscale"])


def test_abn_frames_step_matches_shard_map(world):
    ranks, _, refs, _ = world
    jstate, jmetrics = refs["abn"]
    for out in ranks:
        for it, jm in enumerate(jmetrics):
            for k in ("src_loss_ce", "loss_ce"):
                np.testing.assert_allclose(out["abn_metrics"][it][k], jm[k],
                                           rtol=2e-4, atol=1e-6, err_msg=k)
    ref = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for out in ranks:
        assert out["abn_equal"] > 0
        for name, r in ref.items():
            np.testing.assert_allclose(out["abn"]["model"][name].numpy(), r,
                                       rtol=1e-3, atol=1e-5, err_msg=name)
        # one batch-statistics update a pass, two passes a step
        assert int(out["abn"]["model"]["bn_a.num_batches_tracked"]) == \
            2 * ITERS


def test_sac_views_step_matches_shard_map(world):
    ranks, _, refs, _ = world
    jstate, jmetrics = refs["sac"]
    for out in ranks:
        for it, jm in enumerate(jmetrics):
            tm = out["sac_metrics"][it]
            msg = "iter %d " % it
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
    assert jmetrics[-1]["pseudo_cover"] > 0.05, "no pseudo-labels to compare"
    student = _sd({"params": jstate.params})
    teacher = _sd({"params": jstate.teacher_params})
    for out in ranks:
        assert out["sac_equal"] > 0
        np.testing.assert_allclose(out["sac"]["running_conf"].numpy(),
                                   jstate.running_conf, rtol=1e-4, atol=1e-6)
        for name, ref in student.items():
            np.testing.assert_allclose(out["sac"]["model"][name].numpy(), ref,
                                       rtol=1e-3, atol=1e-5,
                                       err_msg="student " + name)
            np.testing.assert_allclose(out["sac"]["teacher"][name].numpy(),
                                       teacher[name], rtol=1e-3, atol=1e-5,
                                       err_msg="teacher " + name)


def test_eval_confusions_are_summed_over_the_ranks(world):
    ranks, _, refs, inputs = world
    conf, confs = refs["eval"]
    for out in ranks:
        assert out["eval"].dtype == torch.int64
        np.testing.assert_array_equal(out["eval"].numpy(), conf)
    assert int(ranks[0]["eval"].sum()) == int((inputs["ev"][1] != 255).sum())

    assert set(ranks[0]["target_eval"]) == set(confs)
    n_pix = G * T * H * W
    for layer, ref in confs.items():
        assert ref.sum() > 0.05 * n_pix, layer
        for out in ranks:
            ours = out["target_eval"][layer].numpy()
            assert np.abs(ours - ref).sum() <= 0.03 * n_pix, layer


# ---------------------------------------------------------------------------
# the train CLI over two ranks
# ---------------------------------------------------------------------------

def test_cli_two_ranks_write_from_rank_0_only(cli_runs):
    one, two = cli_runs["events"]["one"], cli_runs["events"]["two"]
    assert set(two) == set(one)
    # one record per tag and epoch: rank 1 wrote none
    for key, steps in two.items():
        assert sorted(steps) == sorted(one[key]), key
    best = [f for f in cli_runs["snaps"] if f.startswith("epoch")]
    assert cli_runs["snaps"] == best + ["last.pth"] and best
    log = cli_runs["log"]
    assert log.count("New best snapshot") == len(best)
    assert log.count("Mesh: 2 device(s) / 2 process(es) (data-parallel)") \
        == 2
    # each val split's 2 frames, one a rank
    for rank in range(WORLD):
        assert "[val:val_cityscapes] rank %d decoded 1 real images" % rank \
            in log


def test_cli_two_ranks_end_with_equal_states(cli_runs):
    log = cli_runs["log"]
    assert log.count("Replicas equal: ") == 2, log[-2000:]
    assert cli_runs["last"]["epoch"] == 2


def test_cli_resume_auto_continues_the_two_rank_run(cli_runs, world):
    _, log, _, _ = world
    assert log.count("Resumed from ") == 1    # rank 0 read the snapshot
    assert log.count("Epoch >>> 02 <<<") == 2
    assert "Epoch >>> 01 <<<" not in log
    assert log.count("Replicas equal: ") == 2
    snaps = cli_runs["out"] / "snap" / "default" / "e" / "two"
    assert torch.load(snaps / "last.pth", weights_only=True)["epoch"] == 3
    steps = _events(str(cli_runs["out"] / "logs" / "default" / "e" / "two"))[
        ("train", "train_epoch/src_loss_ce")]
    assert sorted(steps) == [0, 1, 2]
