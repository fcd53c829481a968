"""Multi-rank inference of the port (``core/mesh.py``, ``core/dist``'s
row-slab exchange, ``nn/spatial.py``, ``infer/engine.run_inference`` and
the infer CLI over a world) against dasac_tpu on the CPU.

Pure Python: ``mesh.infer_mesh`` gives ``dasac_tpu.infer.engine.
infer_mesh``'s layouts on the 8-device CPU mesh, case by case (the port of
``tests/test_infer_tools.py::test_infer_mesh_layout_contract``), ranks map
onto the ``(data, sp)`` grid as dasac_tpu's devices do, and a spatial N
that does not divide the world raises, naming both.

One spawned 4-rank gloo world (``tests/torch_infer_mesh_ranks.py``):
  * every sharded op against its unsharded self, over the pairs [0, 1] and
    [2, 3] and over the 4 ranks, in f32, within 1e-6 relative: convs 3x3
    at dilations 1/2/4/24, 7x7/2, 1x1/2, 3x3/2 "same"; ``max_pool_ceil``
    and ``max_pool``; the align-corners resize, at heights 40, 42 and 131;
  * FCN8s at full width on a 96x128 frame over the pair [0, 1] against
    its unsharded forward (probabilities within 1e-5 relative);
  * ``run_inference`` of the tiny arch and a shallow r101 (stem, ceil
    pool, one block a stage, ASPP) in the three layouts (batch over 4
    ranks, spatial with 4 ranks a frame, combined 2 x 2), each against
    dasac_tpu's ``run_inference`` in the layout with the same ``n_sp``
    (``spatial=4``: a (2, 4) mesh; ``spatial=2``: (4, 2)), at a divisible
    height (40 rows), at 42 rows (edge-padded to 44 with 4 ranks a frame,
    as dasac_tpu pads), with one scale and with 0.75/1.0 + flip fused at
    stride 8: the trainId exports equal outside dasac_tpu's argmax ties
    (top-2 probabilities closer than 1e-5, as
    ``tests/test_torch_infer_program.py`` draws them; under 2% of the
    pixels, 1.3% with r101 and flip), each package's
    confusion the one of its own exports, and the two confusions equal on
    the other pixels; spatial runs exchange rows, batch runs none;
  * ``spatial=3`` on 4 ranks raises ``ValueError`` naming both;
  * the infer CLI as 4 ranks of a world given by ``--world-size/--rank/
    --dist-url`` with ``--spatial 2`` writes the PNGs the one-process CLI
    writes, and only rank 0 prints the IoUs, the one-process lines.
"""

import concurrent.futures
import contextlib
import io
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dasac_tpu.infer import engine as jengine
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu_torch.core import mesh
from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.synth import make_synthetic_root
from dasac_tpu_torch.infer import cli as tcli
from dasac_tpu_torch.infer import engine as tengine
from dasac_tpu_torch.utils.sys_tools import find_free_port
from tests import torch_infer_mesh_ranks as ranks_lib
from tests.test_torch_dist import _stdout_to
from tests.test_torch_infer_program import (  # noqa: F401 (a fixture)
    _conf, _iou_lines, snapshot)
from tests.test_torch_nn import ShallowDeepLab, _randomize_stats
from tests.torch_infer_mesh_ranks import C, MEAN, SETTINGS, STD, WORLD

ROOTS = {"h40": ((40, 56), 3), "h42": ((42, 56), 2)}
# the port's layout in a world of 4 -> dasac_tpu's run_inference arguments
# with the same n_sp on its 8-device mesh
JAX_LAYOUTS = {"batch": dict(spatial=0, batch_size=4),
               "spatial": dict(spatial=4), "combined": dict(spatial=2)}
N_SP = {"batch": 0, "spatial": 4, "combined": 2}
CASES = [
    ("tiny", "h40", "single", "batch"),
    ("tiny", "h40", "single", "spatial"),
    ("tiny", "h40", "single", "combined"),
    ("tiny", "h40", "multi", "spatial"),
    ("tiny", "h40", "multi", "combined"),
    ("tiny", "h42", "single", "spatial"),
    ("tiny", "h42", "single", "combined"),
    ("tiny", "h42", "multi", "spatial"),
    ("r101", "h40", "single", "spatial"),
    ("r101", "h40", "single", "combined"),
    ("r101", "h40", "multi", "combined"),
    ("r101", "h42", "single", "spatial"),
    ("r101", "h42", "multi", "spatial"),
]
TIE = 1e-5
WORLD_DEADLINE_S = 300   # the world takes ~25 s here


# ---------------------------------------------------------------------------
# pure Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,spatial", [
    (None, 0), (4, 0), (12, 0), (1, 0), (None, True), (None, -1), (None, 4),
    (1, 4), (3, 2), (None, 1), (None, 8)])
def test_infer_mesh_matches_jax(batch, spatial):
    assert len(jax.local_devices()) == 8
    jmesh, _, jb, jn_sp = jengine.infer_mesh(batch, spatial)
    lay = mesh.infer_mesh(8, batch, spatial)
    assert lay.b == jb and lay.n_sp == jn_sp
    want = [lay.n_data, lay.n_sp] if spatial else [lay.n_data]
    assert list(jmesh.devices.shape) == want
    # rank r sits where dasac_tpu puts device r
    grid = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(
        lay.n_data, max(lay.n_sp, 1))
    for r in range(8):
        where = np.argwhere(grid == r)
        assert lay.coords(r) == (tuple(where[0]) if len(where) else None)


@pytest.mark.parametrize("world,spatial", [(8, 3), (4, 3), (2, 4), (1, 2)])
def test_infer_mesh_refuses_a_layout_the_world_cannot_make(world, spatial):
    with pytest.raises(ValueError,
                       match="spatial=%d must divide the %d-rank world"
                       % (spatial, world)):
        mesh.infer_mesh(world, None, spatial)
    if world == 8:
        with pytest.raises(AssertionError, match="must divide"):
            jengine.infer_mesh(None, spatial)


# ---------------------------------------------------------------------------
# the 4-rank world, against dasac_tpu
# ---------------------------------------------------------------------------

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
def inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    roots = {name: make_synthetic_root(str(base / name), hw=hw, n_val=n)
             for name, (hw, n) in ROOTS.items()}
    init = lambda m: _randomize_stats(jax.jit(lambda k: m.init(  # noqa: E731
        {"params": k}, jnp.zeros((1, 40, 56, 3))))(jax.random.PRNGKey(0)), 1)
    jmodels = {"tiny": jbuild("tiny", C), "r101": ShallowDeepLab(C)}
    variables = {k: init(m) for k, m in jmodels.items()}
    models = {"tiny": ("tiny", variables["tiny"], {}),
              "r101": ("deeplabv2_resnet101", variables["r101"],
                       {"layers": (1, 1, 1, 1)})}
    return dict(roots=roots, jmodels=jmodels, variables=variables,
                ranks=dict(cases=CASES, models=models, roots=roots))


def _jax_case(case, inp, out_dir):
    """dasac_tpu's run_inference of ``case`` in the layout with the same
    ``n_sp``, and its probabilities on each frame's canvas (edge-padded to
    a multiple of ``n_sp``, as run_inference pads it) cut back to the
    frame, for the ties."""
    model, root, setting, layout = case
    jmodel, variables = inp["jmodels"][model], inp["variables"][model]
    ds = jengine.InferDataset(inp["roots"][root], "val_cityscapes")
    conf = jengine.run_inference(jmodel, variables, ds, out_dir, mean=MEAN,
                                 std=STD, verbose=False,
                                 **JAX_LAYOUTS[layout], **SETTINGS[setting])
    fn = jax.jit(jengine.make_infer_fn(jmodel, MEAN, STD,
                                       **SETTINGS[setting]))
    n_sp, probs = N_SP[layout], []
    for i in range(len(ds)):
        img = ds.load(i)[0][None]
        h = img.shape[1]
        pad = -h % n_sp if n_sp else 0
        canvas = np.pad(img, ((0, 0), (0, pad), (0, 0), (0, 0)), mode="edge")
        probs.append(np.asarray(fn(variables, jnp.asarray(canvas)))[0, :h])
    return conf, probs


@pytest.fixture(scope="module")
def jax_side(inputs, tmp_path_factory):
    """dasac_tpu's side of every case, computed on a thread while the
    ranks work: a future of ``{case: (conf, probs, out_dir)}``."""
    base = tmp_path_factory.mktemp("jax")

    def compute():
        out = {}
        for case in CASES:
            d = str(base / "_".join(case))
            out[case] = (*_jax_case(case, inputs, d), d)
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(compute)
        yield future
        future.result()


def _spawn(fn, args, deadline_s=WORLD_DEADLINE_S):
    """The 4 ranks, ended (and the test failed) when they have not all
    finished after ``deadline_s``: ranks whose exchange plans disagreed
    would otherwise wait on each other for ``dist.TIMEOUT``."""
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=WORLD,
                                      join=False)
    deadline = time.monotonic() + deadline_s
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the %d-rank world did not finish in %d s"
                        % (WORLD, deadline_s))


def _cli_argv(snap, root, out):
    return ["--cfg", "configs/tiny_cpu.yaml", "--resume", snap,
            "--infer-list", "val_cityscapes", "--mask-output-dir", out,
            "--workers", "1", "--set", "DATASET.ROOT", root]


@pytest.fixture(scope="module")
def world(inputs, jax_side, snapshot, tmp_path_factory):  # noqa: F811
    """The 4-rank world's results and the log of its CLI run, and the
    one-process CLI's exports and IoU lines."""
    out = tmp_path_factory.mktemp("world")
    root = inputs["roots"]["h40"]
    one = str(out / "cli_one")
    with contextlib.redirect_stdout(io.StringIO()) as one_log:
        tcli.main(_cli_argv(snapshot, root, one), device="cpu")
    cli_argv = _cli_argv(snapshot, root, str(out / "cli_world")) + [
        "--spatial", "2"]
    log = _stdout_to(str(out / "world.log"), lambda: _spawn(
        ranks_lib.world_main, ("127.0.0.1:%d" % find_free_port(), str(out),
                               inputs["ranks"], cli_argv, find_free_port())))
    ranks = [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, out=out, log=log, one=one,
                one_log=one_log.getvalue())


@pytest.mark.parametrize("over", ["ops_pair", "ops_world"])
def test_sharded_ops_match_unsharded(world, over):
    for r, res in enumerate(world["ranks"]):
        errs, calls = res[over]
        assert len(errs) == len(ranks_lib.OP_HEIGHTS) * (
            len(ranks_lib.CONVS) + 4)
        bad = {k: e for k, e in errs.items() if not e <= 1e-6}
        assert not bad, (r, bad)
        for kind in ("conv", "pool", "resize"):
            assert calls["exchange_" + kind] > 0, (r, kind, calls)
            assert calls["exchange_bytes_" + kind] > 0, (r, kind, calls)


def test_fcn8s_sharded_forward_matches_unsharded(world):
    for r in (0, 1):
        err, calls = world["ranks"][r]["fcn"]
        assert err <= 1e-5, (r, err)
        assert calls["exchange_conv"] > 0 and calls["exchange_pool"] > 0
        assert calls["exchange_resize"] > 0


def _png(path):
    return png.read(path).pixels


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_run_inference_layout_matches_jax(world, jax_side, inputs, case):
    jconf, jprobs, jdir = jax_side.result()[case]
    run = world["ranks"][0]["runs"][case]
    tdir = str(world["out"] / "_".join(case))
    ds = tengine.InferDataset(inputs["roots"][case[1]], "val_cityscapes")
    ours, theirs, gts, ties = [], [], [], []
    for i in range(len(ds)):
        name = ds.name(i)
        pred = _png(os.path.join(tdir, name + ".png"))
        ref = np.asarray(Image.open(os.path.join(jdir, name + ".png")))
        top2 = np.sort(jprobs[i], axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < TIE
        assert tie.mean() < 0.02   # r101 + flip: 1.3% of pixels
        np.testing.assert_array_equal(np.where(tie, 0, pred),
                                      np.where(tie, 0, ref), err_msg=name)
        ours.append(pred)
        theirs.append(ref)
        gts.append(ds.load(i)[1])
        ties.append(tie)
    # the confusion every rank returns is the world's sum
    for res in world["ranks"]:
        np.testing.assert_array_equal(res["runs"][case]["conf"], run["conf"])
    np.testing.assert_array_equal(run["conf"], _conf(ours, gts))
    np.testing.assert_array_equal(jconf, _conf(theirs, gts))
    away = [np.where(t, 255, g) for t, g in zip(ties, gts)]
    np.testing.assert_array_equal(_conf(ours, away), _conf(theirs, away))
    # only a frame's first sp rank writes: one file a frame
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".png")) == \
        sorted(ds.name(i) + ".png" for i in range(len(ds)))


def test_spatial_layouts_exchange_rows_and_batch_none(world):
    for r, res in enumerate(world["ranks"]):
        for case, run in res["runs"].items():
            ex = run["exchanges"]
            if case[3] == "batch":
                assert ex["exchange"] == 0, (r, case, ex)
            else:
                assert ex["exchange_conv"] > 0, (r, case, ex)
                assert ex["exchange_gather"] > 0, (r, case, ex)


def test_run_inference_refuses_spatial_3_on_4_ranks(world):
    for res in world["ranks"]:
        assert res["refusal"] == "spatial=3 must divide the 4-rank world"


def test_cli_over_four_ranks_writes_what_one_process_writes(world):
    one, many = world["one"], str(world["out"] / "cli_world")
    names = sorted(f for f in os.listdir(one) if f.endswith(".png"))
    assert names and names == sorted(
        f for f in os.listdir(many) if f.endswith(".png"))
    for sub in ("", "cs"):
        for f in names:
            np.testing.assert_array_equal(
                _png(os.path.join(many, sub, f)),
                _png(os.path.join(one, sub, f)), err_msg=f)
    lines = _iou_lines(world["one_log"])
    assert len(lines) == C + 1
    assert _iou_lines(world["log"]) == lines   # rank 0 alone printed
