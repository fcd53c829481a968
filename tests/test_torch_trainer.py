"""The port's training program (dasac_tpu_torch/train/{loop,cli}.py) against
dasac_tpu's ``train.py`` / ``Trainer`` on the CPU, at the tiny size
(``configs/tiny_cpu.yaml``, 48x64 frames written by dasac_tpu's
``make_synthetic_root``, the ``tiny`` arch).

  * ``cli.main(argv, device="cpu")`` trains SAC and ABN for 2 epochs; the
    set of (writer, tag) pairs in the ``events.jsonl`` files equals the set
    dasac_tpu's ``train.main`` writes for the same argv and root; the best
    snapshots (at most 3) and ``last.pth`` exist;
  * ``--resume auto`` restarts at the saved epoch with the saved
    parameters, statistics and momentum, and trains from there;
  * with the weights of a dasac_tpu ``Trainer`` carried over
    (``train_state_from_jax``), ``Trainer.validation(epoch, split)``
    returns the same mIoU on every val split, rtol 1e-6 (the val frames are
    at the crop size, so both sides see the same pixels; at these weights
    no argmax tie decides a pixel);
  * backbone init: a torchvision-keyed ``resnet101`` state_dict made from
    numpy with a seed goes through dasac_tpu's ``apply_state_dict(...,
    "torchvision")`` and the port's ``load_torchvision_backbone`` with the
    same ``n_loaded`` and skipped keys, and equal tensors, exactly
    (compared through ``from_jax_variables``); the trainer loads it from
    ``MODEL.INIT_MODEL`` into student and teacher, or says it is missing;
  * the settings that need more than one device raise; ``--profile``
    writes a trace;
  * the visual panels equal dasac_tpu's (class colours exactly, image and
    heatmap rows within 1 uint8 level).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasac_tpu.core import config as jconfig
from dasac_tpu.data.synth import make_synthetic_root
from dasac_tpu.nn import convert as jconvert
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core.opts import get_arguments
from dasac_tpu_torch.nn.convert import (from_jax_variables,
                                        load_torchvision_backbone,
                                        train_state_from_jax)
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import cli, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_cpu.yaml")
R101 = "deeplabv2_resnet101"
MODES = {"sac": [], "abn": ["MODEL.BASELINE", "True"]}


@pytest.fixture(scope="module", autouse=True)
def _keep_native_loader_flag():
    """dasac_tpu's Loaders set its process-global native-decoder flag from
    TPU.NATIVE_LOADER (False here): put it back for the tests that follow
    in this process."""
    from dasac_tpu.data import native

    enabled = native._enabled
    yield
    native.set_enabled(enabled)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("root")),
                               hw=(48, 64), n_train_src=4, n_train_tgt=4,
                               n_val=2, val_hw=(32, 48))


def _argv(root, out, run, extra=(), sets=()):
    return ["--cfg", TINY, "--snapshot-dir", str(out / "snap"),
            "--logdir", str(out / "logs"), "--exp", "e", "--run", run,
            "--workers", "2", *extra,
            "--set", "DATASET.ROOT", root, "TRAIN.NUM_EPOCHS", "2",
            "TPU.NATIVE_LOADER", "False", "TPU.COMPILE_CACHE", "", *sets]


def _tags(logdir):
    out = set()
    for p in glob.glob(os.path.join(logdir, "**", "events.jsonl"),
                       recursive=True):
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                out.add((os.path.basename(os.path.dirname(p)), rec["tag"],
                         rec["step"]))
    return out


@pytest.fixture(scope="module")
def jax_runs(root, tmp_path_factory):
    """dasac_tpu's train.py on the same argv: (writer, tag, step) sets."""
    import train as jtrain

    out = {}
    for mode, sets in MODES.items():
        d = tmp_path_factory.mktemp("jax_" + mode)
        jconfig.reset_cfg()
        jtrain.main(_argv(root, d, mode, sets=sets))
        out[mode] = _tags(str(d / "logs"))
    jconfig.reset_cfg()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_writes_the_tags_jax_writes(root, jax_runs, tmp_path, mode):
    trainer = cli.main(_argv(root, tmp_path, mode, sets=MODES[mode]),
                       device="cpu")
    assert trainer.device == torch.device("cpu")
    assert trainer.start_epoch == 0 and trainer.state.step == 6
    ours = _tags(str(tmp_path / "logs"))
    assert ours == jax_runs[mode], (sorted(ours ^ jax_runs[mode])[:10])
    assert any(t[1] == "logits_up_all/mIoU" and t[0] == "train_target"
               for t in ours)
    snap = tmp_path / "snap" / "default" / "e" / mode
    best = glob.glob(str(snap / "epoch*_score*.pth"))
    assert 1 <= len(best) <= 3 and (snap / "last.pth").is_file()
    panels = glob.glob(str(tmp_path / "logs" / "**" / "*.png"),
                       recursive=True)
    assert any("train_target_panel" in p for p in panels), panels
    for p in panels:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_resume_auto_restarts_at_the_saved_epoch(root, tmp_path):
    cli.main(_argv(root, tmp_path, "r"), device="cpu")
    snap = tmp_path / "snap" / "default" / "e" / "r"
    saved = torch.load(str(snap / "last.pth"), weights_only=True)
    assert saved["epoch"] == 3

    argv = _argv(root, tmp_path, "r", extra=["--resume", "auto"],
                 sets=["TRAIN.NUM_EPOCHS", "3"])
    tconfig.cfg_from_file(TINY)
    tconfig.cfg_from_list(argv[argv.index("--set") + 1:])
    trainer = loop.Trainer(get_arguments(argv), tconfig.cfg, device="cpu")
    assert trainer.start_epoch == 3
    sd = trainer.state.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, saved["model"]["module.backbone." + k]), k
    opt = trainer.state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           saved["opt"]["state"][i]["momentum_buffer"])
    assert torch.equal(trainer.state.running_conf,
                       saved["model"]["module.running_conf"])
    assert trainer.state.slow_init == 1
    trainer.fit()
    trainer.close()
    assert torch.load(str(snap / "last.pth"), weights_only=True)[
        "epoch"] == 4
    steps = {t[2] for t in _tags(str(tmp_path / "logs"))
             if t[1].startswith("train_epoch/")}
    assert steps == {0, 1, 2, 3}


def test_validation_miou_equals_jax(root, tmp_path):
    from dasac_tpu.train.loop import Trainer as JTrainer

    argv = _argv(root, tmp_path, "v")
    sets = argv[argv.index("--set") + 1:]
    for mod in (jconfig, tconfig):
        mod.cfg_from_file(TINY)
        mod.cfg_from_list(sets)
    from dasac_tpu.core.opts import get_arguments as jget_arguments

    jt = JTrainer(jget_arguments(argv), jconfig.cfg, seed=0)
    tt = loop.Trainer(get_arguments(argv), tconfig.cfg, device="cpu")
    js = jax.device_get(jt.state)
    train_state_from_jax(
        dict(params=js.params, batch_stats=js.batch_stats,
             teacher_params=js.teacher_params,
             teacher_stats=js.teacher_stats, running_conf=js.running_conf,
             slow_init=js.slow_init, step=js.step), "tiny", tt.state)
    scores = []
    for split in tt.loaders.val:
        ours, ref = tt.validation(1, split), jt.validation(1, split)
        scores.append(ours)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, err_msg=split)
    tt.close()
    assert max(scores) > 0


# ---------------------------------------------------------------------------
# backbone initialization
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def torchvision_sd():
    """A resnet101 state_dict with torchvision's keys (the trunk's, fc.*,
    num_batches_tracked), values from numpy with a seed."""
    model = build_model(R101, 19, device="cpu")
    rng = np.random.RandomState(5)
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith("model.") or k.startswith("model.layer5."):
            continue
        key = k[len("model."):]
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        else:
            arr = rng.randn(*v.shape).astype(np.float32)
            if key.endswith("running_var"):
                arr = np.abs(arr) + 0.5
            sd[key] = torch.from_numpy(arr)
    sd["fc.weight"] = torch.from_numpy(
        rng.randn(1000, 2048).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_load_torchvision_backbone_equals_jax(torchvision_sd):
    jmodel = jbuild(R101, 19)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3)), train=False,
                            update_stats=False))
    rng = np.random.RandomState(6)
    variables = jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32),
        {c: shapes[c] for c in ("params", "batch_stats")})
    sd_np = {k: v.numpy() for k, v in torchvision_sd.items()}
    jvars, jn, jskipped = jconvert.apply_state_dict(variables, sd_np, R101,
                                                    "torchvision")
    model = build_model(R101, 19, device="cpu")
    model.load_state_dict(from_jax_variables(variables, R101))
    n, skipped = load_torchvision_backbone(model, torchvision_sd, R101)
    assert n == jn == 520 and sorted(skipped) == sorted(jskipped) == [
        "fc.bias", "fc.weight"]
    ref = from_jax_variables(jvars, R101)
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert torch.equal(v, ref[k]), k
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_torchvision_backbone(model, {"conv1.weight": torch.zeros(3)},
                                  R101)
    with pytest.raises(ValueError, match="tiny"):
        load_torchvision_backbone(model, torchvision_sd, "tiny")


@pytest.mark.parametrize("present", [True, False])
def test_trainer_loads_init_model(root, tmp_path, torchvision_sd, capsys,
                                  present):
    path = str(tmp_path / "resnet101-5d3b4d8f.pth")
    if present:
        torch.save(torchvision_sd, path)
    argv = _argv(root, tmp_path, "i", sets=["MODEL.ARCH", R101,
                                            "MODEL.INIT_MODEL", path])
    tconfig.cfg_from_file(TINY)
    tconfig.cfg_from_list(argv[argv.index("--set") + 1:])
    trainer = loop.Trainer(get_arguments(argv), tconfig.cfg, device="cpu")
    trainer.close()
    out = capsys.readouterr().out
    state = trainer.state
    w = state.model.state_dict()["model.layer3.5.conv2.weight"]
    if present:
        assert "Loaded 520 backbone tensors from " + path in out
        assert torch.equal(w, torchvision_sd["layer3.5.conv2.weight"])
    else:
        assert "Backbone model not found: " + path in out
        assert not torch.equal(w, torchvision_sd["layer3.5.conv2.weight"])
    for k, v in state.student_params().items():
        assert torch.equal(state.teacher_params[k], v), k
    for k, v in state.student_stats().items():
        assert torch.equal(state.teacher_stats[k], v), k


@pytest.mark.parametrize("key,value", [
    ("TPU.MESH_DEVICES", "2"), ("TPU.PARTITION", "gspmd"),
    ("TPU.MESH_SP", "2"), ("TPU.REMAT", "everything")])
def test_multi_device_settings_raise(key, value):
    """A remat mode other than none/block/convs raises ``remat_mode``'s
    error; a multi-device setting is the layout of the ranks the train CLI
    spawns (tests/test_torch_dist.py and tests/test_torch_gspmd.py run
    them), which one process alone cannot be."""
    tconfig.cfg_from_list([key, value, "TRAIN.NUM_GROUPS", "2"])
    if key == "TPU.REMAT":
        with pytest.raises(ValueError, match="remat must be none/block/convs"):
            loop.mesh_size(tconfig.cfg, available=1)
        return
    if key == "TPU.MESH_DEVICES":
        assert loop.mesh_size(tconfig.cfg, available=1) == (2, 1, False)
        # one process alone cannot be a mesh of 2
        with pytest.raises(ValueError, match="one process per device"):
            loop.Trainer(None, tconfig.cfg, device="cpu")
        return
    if key == "TPU.PARTITION":
        # gspmd over a data mesh: as many data slices as devices divide
        # both batch dimensions, whole frames
        assert loop.mesh_size(tconfig.cfg, available=1) == (1, 1, True)
        assert loop.mesh_size(tconfig.cfg, available=4) == (2, 1, True)
        return
    # TPU.MESH_SP counts under gspmd only, as in dasac_tpu
    assert loop.mesh_size(tconfig.cfg, available=4) == (2, 1, False)
    tconfig.cfg_from_list(["TPU.PARTITION", "gspmd"])
    assert loop.mesh_size(tconfig.cfg, available=4) == (2, 2, True)
    assert loop.mesh_size(tconfig.cfg, available=1) == (1, 2, True)


def test_profile_writes_a_trace(root, tmp_path):
    cli.main(_argv(root, tmp_path, "p", extra=["--profile"],
                   sets=["TRAIN.NUM_EPOCHS", "0"]), device="cpu")
    trace = tmp_path / "logs" / "default" / "e" / "p" / "trace.json"
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_panels_equal_jax():
    """The port's visual panels (computed in torch) against dasac_tpu's
    (numpy): equal class colours exactly, the image and heatmap rows within
    1 uint8 level (float32 rounding at a level's edge)."""
    from collections import namedtuple

    from dasac_tpu.utils import visualise as jvis
    from dasac_tpu_torch.utils import visualise as tvis

    rng = np.random.RandomState(9)
    b, h, w, c = 3, 12, 20, 19
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    frames = rng.randn(b, h, w, 3).astype(np.float32)
    labels = rng.randint(0, c, (b, h, w)).astype(np.uint8)
    labels[:, :2] = 255
    logits = (rng.randn(b, h, w, c) * 3).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    Views = namedtuple("Views", "frames_aug frames_clean labels")
    views = Views(frames, frames[::-1].copy(), labels)
    diags = {"teacher_aligned": probs[::-1].copy(),
             "frames_aligned": frames * 0.5}
    pairs = [
        (tvis.source_panel(frames, labels, torch.from_numpy(logits), mean,
                           std),
         jvis.source_panel(frames, labels, logits, mean, std)),
        (tvis.target_panel(views, torch.from_numpy(probs), labels, logits,
                           mean, std, diags=diags),
         jvis.target_panel(views, probs, labels, logits, mean, std,
                           diags=diags))]
    for ours, ref in pairs:
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        d = np.abs(ours.astype(np.int16) - ref)
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(),
                                                         (d > 0).mean())
