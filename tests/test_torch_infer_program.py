"""The port's inference program (``dasac_tpu_torch/infer``: ``InferDataset``,
``ResultWriter``, ``run_inference`` and the infer CLI) against dasac_tpu on
the CPU.

  * ``run_inference`` of both packages on the synthetic root each package
    writes (``make_synthetic_root``, the same pixels), the tiny arch with
    the same weights, single scale and 0.75/1.0 + flip fused at stride 8:
    the trainId and ``cs/`` exports decode to equal masks outside the
    pixels whose top-2 JAX probabilities are closer than 1e-5 (argmax ties,
    under 1% of pixels), each package's confusion is the one of its own
    exports, and the two confusions agree on the other pixels;
  * PIL reads the port's trainId export as a "P" image with the train
    palette, and the port reads PIL's as a palette image;
  * the infer CLI on ``configs/tiny_cpu.yaml`` loads a ``.pth`` written by
    the port's ``Checkpointer``, with and without ``--teacher``, and prints
    what ``infer_val.main`` prints for the same file (``dasac_tpu``'s
    ``Checkpointer`` reads the port's files; its ``.pth`` key maps cover
    the reference archs only, so the test gives it the tiny arch's map,
    which names the flax scopes as the port names its modules);
  * ``--spatial 2`` and ``spatial=2`` raise, naming ROADMAP item 10.

Wall time of this file on the CPU host the tier-1 tests run on: ~21 s run
alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import infer_val
from dasac_tpu.core.config import reset_cfg as jreset_cfg
from dasac_tpu.data.synth import make_synthetic_root as jmake_root
from dasac_tpu.infer import engine as jengine
from dasac_tpu.nn import convert as jconvert
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.category import train_palette, trainid_to_cs_table
from dasac_tpu_torch.data.synth import make_synthetic_root as tmake_root
from dasac_tpu_torch.infer import cli as tcli
from dasac_tpu_torch.infer import engine as tengine
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train.checkpoints import Checkpointer
from tests.test_torch_nn import _port_model, _randomize_stats

C = 19
HW = (40, 56)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SETTINGS = [dict(scales=(1.0,)),
            dict(scales=(0.75, 1.0), flip=True, fuse="stride8")]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    return (jmake_root(str(base / "jax"), hw=HW, n_val=3),
            tmake_root(str(base / "port"), hw=HW, n_val=3))


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild("tiny", C)
    variables = _randomize_stats(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *HW, 3)),
        train=False, update_stats=False), 1)
    return jmodel, variables, _port_model("tiny", variables)


def _conf(preds, gts):
    """Confusion of uint8 trainId masks against ground truth (255 ignored),
    in numpy."""
    out = np.zeros((C, C), np.int64)
    for p, g in zip(preds, gts):
        valid = g != 255
        out += np.bincount(g[valid].astype(np.int64) * C + p[valid],
                           minlength=C * C).reshape(C, C)
    return out


@pytest.mark.parametrize("kw", SETTINGS, ids=["single", "multi_flip_stride8"])
def test_run_inference_matches_jax(roots, models, tmp_path, kw):
    jroot, troot = roots
    jmodel, variables, model = models
    jds = jengine.InferDataset(jroot, "val_cityscapes")
    tds = tengine.InferDataset(troot, "val_cityscapes")
    assert len(tds) == len(jds) == 3 and tds.out_hw == jds.out_hw == HW
    jconf = jengine.run_inference(jmodel, variables, jds, str(tmp_path / "j"),
                                  mean=MEAN, std=STD, batch_size=1,
                                  verbose=False, **kw)
    # batch 2 over 3 frames: the tail batch is padded with an ignored frame
    tconf = tengine.run_inference(model, tds, str(tmp_path / "t"), mean=MEAN,
                                  std=STD, batch_size=2, verbose=False,
                                  device="cpu", **kw)
    assert tconf.dtype == np.int64 and tconf.shape == (C, C)
    t2c = trainid_to_cs_table()
    probs_fn = jengine.make_infer_fn(jmodel, MEAN, STD, **kw)
    ours, theirs, gts, ties = [], [], [], []
    for i in range(len(tds)):
        name = tds.name(i)
        assert name == jds.name(i)
        img, gt = tds.load(i)
        jimg, jgt = jds.load(i)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(gt, jgt)
        pred = png.read(str(tmp_path / "t" / (name + ".png")))
        assert pred.color_type == 3
        ref = np.asarray(Image.open(str(tmp_path / "j" / (name + ".png"))))
        probs = np.asarray(probs_fn(variables, jnp.asarray(img[None])))[0]
        top2 = np.sort(probs, axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < 1e-5
        assert tie.mean() < 0.01
        np.testing.assert_array_equal(np.where(tie, 0, pred.pixels),
                                      np.where(tie, 0, ref))
        cs = png.read(str(tmp_path / "t" / "cs" / (name + ".png")))
        assert cs.color_type == 0
        np.testing.assert_array_equal(cs.pixels, t2c[pred.pixels])
        jcs = np.asarray(Image.open(str(tmp_path / "j" / "cs" /
                                        (name + ".png"))))
        np.testing.assert_array_equal(np.where(tie, 0, cs.pixels),
                                      np.where(tie, 0, jcs))
        ours.append(pred.pixels)
        theirs.append(ref)
        gts.append(gt)
        ties.append(tie)
    np.testing.assert_array_equal(tconf, _conf(ours, gts))
    np.testing.assert_array_equal(jconf, _conf(theirs, gts))
    away = [np.where(t, 255, g) for t, g in zip(ties, gts)]
    np.testing.assert_array_equal(_conf(ours, away), _conf(theirs, away))


def test_exports_are_palette_pngs_both_ways(roots, models, tmp_path):
    jroot, troot = roots
    jmodel, variables, model = models
    tds = tengine.InferDataset(troot, "val_cityscapes")
    out = str(tmp_path / "t")
    tengine.run_inference(model, tds, out, mean=MEAN, std=STD, save_raw=True,
                          vis=True, verbose=False, device="cpu")
    name = tds.name(0)
    pal = train_palette()
    with Image.open(os.path.join(out, name + ".png")) as im:
        assert im.mode == "P"
        assert list(im.getpalette()[:len(pal)]) == pal.tolist()
        np.testing.assert_array_equal(
            np.asarray(im), png.read(os.path.join(out, name + ".png")).pixels)
    raw = np.load(os.path.join(out, "raw", name + ".npz"))["raw"]
    assert raw.dtype == np.float16 and raw.shape == (*HW, C)
    with Image.open(os.path.join(out, "vis", name + ".png")) as im:
        assert im.mode == "RGB" and im.size == HW[::-1]
    # a P-mode file PIL writes (dasac_tpu's export) reads as palette indices
    jds = jengine.InferDataset(jroot, "val_cityscapes")
    jout = str(tmp_path / "j")
    jengine.run_inference(jmodel, variables, jds, jout, mean=MEAN, std=STD,
                          batch_size=1, verbose=False)
    img = png.read(os.path.join(jout, name + ".png"))
    assert img.color_type == 3
    np.testing.assert_array_equal(img.palette.reshape(-1)[:len(pal)], pal)
    with Image.open(os.path.join(jout, name + ".png")) as im:
        np.testing.assert_array_equal(img.pixels, np.asarray(im))


def test_result_writer_close_reraises_a_worker_error(tmp_path):
    w = tengine.ResultWriter(str(tmp_path), save_raw=True, workers=2)
    w.submit(np.zeros((4, 6), np.uint8), np.zeros((4, 6, 3), np.uint8), "a")
    with pytest.raises(ValueError, match="save_raw needs"):
        w.close()


# ---------------------------------------------------------------------------
# the CLI against infer_val.py
# ---------------------------------------------------------------------------

def _tiny_key_map(arch, torch_style, _orig=jconvert.key_map):
    if arch != "tiny":
        return _orig(arch, torch_style)
    m = {}
    for name in ("conv_a", "conv_b", "aspp"):
        m.update(jconvert._emit_conv(name, (name,)))
    for name in ("bn_a", "bn_b"):
        m.update(jconvert._emit_bn(name, (name,)))
    return m


class _MC:
    LR = 0.001
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A SAC-like snapshot of the tiny arch written by the port: random BN
    statistics, a teacher that differs from the student, a class prior."""
    model = build_model("tiny", C, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, toptim.build_optimizer(_MC, "tiny",
                                                             model),
                               C, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.named_buffers():
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=g)
            elif name.endswith("running_mean"):
                t.normal_(0.0, 0.1, generator=g)
        for t in state.teacher_params.values():
            t.add_(torch.randn(t.shape, generator=g) * 0.3)
    state.slow_init = 1
    state.running_conf = torch.rand(C, generator=g)
    path = Checkpointer(str(tmp_path_factory.mktemp("snap"))).save_latest(
        state, 0.5, 3)
    return path


def _iou_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("IoU_", "mIoU ("))]


@pytest.mark.parametrize("teacher", [False, True], ids=["student", "teacher"])
def test_cli_prints_what_infer_val_prints(roots, snapshot, tmp_path, capsys,
                                          monkeypatch, teacher):
    jroot, troot = roots
    flags = ["--teacher"] if teacher else []
    common = ["--cfg", "configs/tiny_cpu.yaml", "--resume", snapshot,
              "--infer-list", "val_cityscapes", *flags]
    conf = tcli.main(common + ["--mask-output-dir", str(tmp_path / "t"),
                               "--set", "DATASET.ROOT", troot],
                     device="cpu")
    ours = _iou_lines(capsys.readouterr().out)
    assert conf.shape == (C, C) and conf.sum() > 0
    assert len(ours) == C + 1 and ours[-1].startswith("mIoU (19 classes)")

    monkeypatch.setattr(jconvert, "key_map", _tiny_key_map)
    jreset_cfg()
    try:
        infer_val.main(common + ["--mask-output-dir", str(tmp_path / "j"),
                                 "--set", "DATASET.ROOT", jroot])
    finally:
        jreset_cfg()
    assert ours == _iou_lines(capsys.readouterr().out)


def test_student_and_teacher_differ(roots, snapshot, tmp_path):
    _, troot = roots
    argv = ["--cfg", "configs/tiny_cpu.yaml", "--resume", snapshot,
            "--infer-list", "val_cityscapes", "--set", "DATASET.ROOT", troot]
    a = tcli.main(argv + ["--mask-output-dir", str(tmp_path / "a")],
                  device="cpu")
    b = tcli.main(argv + ["--mask-output-dir", str(tmp_path / "b"),
                          "--teacher"], device="cpu")
    assert a.sum() == b.sum() and not np.array_equal(a, b)


def test_spatial_raises_naming_item_10(roots, models, snapshot, tmp_path):
    _, troot = roots
    with pytest.raises(NotImplementedError, match="item 10"):
        tcli.main(["--cfg", "configs/tiny_cpu.yaml", "--resume", snapshot,
                   "--mask-output-dir", str(tmp_path), "--spatial", "2"],
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tengine.run_inference(models[2],
                              tengine.InferDataset(troot, "val_cityscapes"),
                              str(tmp_path), mean=MEAN, std=STD, spatial=2,
                              device="cpu")
    assert not os.listdir(tmp_path)
