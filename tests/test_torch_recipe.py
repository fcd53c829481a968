"""The three-stage recipe program of the port (``dasac_tpu_torch/tools/
recipe.py``) on the CPU: the counterpart of
``tests/test_recipe_e2e.py::test_three_stage_recipe``.

  * the chain end to end on ``configs/tiny_cpu.yaml`` and a tiny
    domain-gap root: ABN -> gate -> mask export -> IS weights -> SAC with
    the weights, target-only -> control -> every eval, each record, the
    snapshots, one mask per target frame, the sampler's class densities
    moved from uniform (more than 1e-3, as the JAX test asks), the
    target-only flag reaching the SAC step (its logged source CE is 0);
    a resumed ``--stages eval`` without the ABN snapshot writes no
    ``gain_vs_abn``; a failed gate stops the recipe;
  * its protocol defaults are the settings
    ``results/recipe_r5.jsonl`` records (read from the file);
  * its gate quantity and source-eval normalization equal
    ``tools/recipe_chip.py``'s on the same log text and configs (exactly:
    the same floats and strings).
"""

import importlib.util
import json
import math
import os
import re
from pathlib import Path

import numpy as np
import pytest

from dasac_tpu_torch.core.config import cfg
from dasac_tpu_torch.data import png, sampler
from dasac_tpu_torch.tools import recipe

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs" / "tiny_cpu.yaml")
N_TGT = 4


def _tiny_argv(work, *extra):
    return ["--work", str(work), "--out", str(work / "records.jsonl"),
            "--cfg", TINY, "--n-src", "4", "--n-tgt", str(N_TGT),
            "--n-val", "2", "--src-hw", "48", "64", "--tgt-hw", "48", "64",
            "--epochs1", "1", "--epochs2", "1", "--gate-ce", "inf",
            *extra]


def _snapshot(work, run):
    return work / ("snap_" + run) / "default" / "recipe" / run / "last.pth"


def _r5():
    with open(REPO / "results" / "recipe_r5.jsonl") as f:
        return [json.loads(line) for line in f]


def test_recipe_chain_on_the_cpu(tmp_path):
    work = tmp_path / "work"
    records = recipe.main(_tiny_argv(work), device="cpu")

    assert [r["stage"] for r in records] == (
        ["abn", "gate", "export", "weights", "sac", "control"]
        + ["eval"] * 7 + ["summary"])
    with open(work / "records.jsonl") as f:
        assert [json.loads(line) for line in f] == json.loads(
            json.dumps(records))
    by = {(r["stage"], r.get("model"), r.get("domain")): r for r in records}

    # train stages: steps, epochs, finite losses, the CE path, the flags
    abn, sac, ctrl = (by[(s, None, None)] for s in ("abn", "sac", "control"))
    assert abn["steps"] == 2 * 2 and abn["start_epoch"] == 0
    assert sac["steps"] == ctrl["steps"] == 2
    assert sac["start_epoch"] == ctrl["start_epoch"] == 2
    for r in (abn, sac, ctrl):
        assert r["step_ms"] > 0 and r["card"] == "cpu"
        # the CPU runs the kernels' plain versions: no launch
        assert all(n == 0 for by_path in r["ce_launches_by_path"].values()
                   for n in by_path.values())
    assert sac["target_only"] is True and sac["lr"] == 5e-5
    assert abn["target_only"] is False and ctrl["target_only"] is False
    assert sac["sample_weights"] == str(work / "cs_weights.data")
    assert abn["sample_weights"] is None and ctrl["sample_weights"] is None
    sac_log = (work / "stage4_sac.log").read_text()
    src_ce = [float(v) for v in
              re.findall(r"src_loss_ce ([0-9.]+)", sac_log)]
    assert src_ce and all(v == 0.0 for v in src_ce), src_ce
    assert "self_ce" in sac_log
    for run in ("abn", "sac", "ctrl"):
        assert _snapshot(work, run).is_file(), run

    # the gate: the trailing CE of the ABN log, reported against inf
    gate = by[("gate", "abn", "source")]
    assert gate["src_ce_tail"] == recipe.trailing_src_ce(
        str(work / "stage1_abn.log"))
    assert gate["passed"] and math.isinf(gate["gate_ce"])
    assert gate["jax_src_ce_tail"] == 0.2151

    # one exported mask per target frame, turned into IS weights
    masks = work / "masks_tgt"
    exported = sorted(p.name for p in masks.glob("*.png"))
    assert exported == ["tgt_%03d.png" % i for i in range(N_TGT)]
    assert by[("export", None, None)]["masks"] == N_TGT
    weights = sampler.load_sample_weights(str(work / "cs_weights.data"))
    assert set(weights) == set(exported)

    # the sampler the SAC stage built reads them with class densities
    # shifted from uniform, for classes present in the masks
    imp = sampler.ImportanceSampler(
        N_TGT, 19, mask_names=exported, weights=weights,
        prior_weight=cfg.DATASET.SAMPLE_UNIFORM_PRIOR)
    totals = np.add.reduce([np.bincount(
        png.read(str(masks / e)).pixels.reshape(-1).astype(np.int64),
        minlength=256)[:19] for e in exported])
    shifted = recipe.shifted_classes(imp)
    assert shifted and set(shifted) <= set(np.nonzero(totals)[0].tolist())
    assert sac["is_shifted_classes"] == shifted

    # evals: every mIoU finite in [0, 1], JAX's figure beside the target's
    jax = {(r["stage"], r.get("model"), r.get("domain")): r["miou"]
           for r in _r5() if "miou" in r}
    for tag in ("abn", "control", "sac", "sac_teacher"):
        for dom in (("target",) if tag == "sac_teacher"
                    else ("target", "source")):
            r = by[("eval", tag, dom)]
            assert 0.0 <= r["miou"] <= 1.0, r
            assert r["jax_miou"] == jax.get(("eval", tag, dom)), r
    assert by[("eval", "abn", "target")]["jax_miou"] == 0.229
    summary = records[-1]
    assert summary["gain_vs_control"] == pytest.approx(
        summary["sac_target"] - summary["control_target"])
    assert summary["gain_vs_abn"] == pytest.approx(
        summary["sac_target"] - summary["abn_target"])

    # resume at the evals without the ABN snapshot: no gain against it
    os.remove(_snapshot(work, "abn"))
    again = recipe.main(_tiny_argv(work, "--stages", "eval"), device="cpu")
    assert [(r["stage"], r.get("model")) for r in again] == [
        ("eval", "control"), ("eval", "control"), ("eval", "sac"),
        ("eval", "sac"), ("eval", "sac_teacher"), ("summary", None)]
    assert "gain_vs_abn" not in again[-1] and "abn_target" not in again[-1]
    assert again[-1]["sac_target"] == summary["sac_target"]


def test_recipe_stops_at_a_failed_gate(tmp_path):
    work = tmp_path / "work"
    argv = _tiny_argv(work, "--stages", "1")
    argv[argv.index("--gate-ce") + 1] = "0"
    with pytest.raises(RuntimeError, match="convergence gate"):
        recipe.main(argv, device="cpu")
    with open(work / "records.jsonl") as f:
        stages = [json.loads(line) for line in f]
    assert [r["stage"] for r in stages] == ["abn", "gate"]
    assert stages[-1]["passed"] is False
    assert not (work / "masks_tgt").exists()


def test_protocol_defaults_are_the_r5_record():
    rec = {r["stage"]: r for r in _r5() if r["stage"] in
           ("abn", "sac", "control")}
    args = recipe.parse_args([])
    assert args.epochs1 == rec["abn"]["epochs"]
    assert args.lr_abn == rec["abn"]["lr"]
    assert args.epochs2 == rec["sac"]["epochs"] == rec["control"]["epochs"]
    assert args.ema_iter == rec["sac"]["ema_iter"]
    assert args.target_only is rec["sac"]["target_only"]
    assert args.lr_sac == rec["sac"]["lr"]
    # the corpus and the gate are the JAX script's defaults
    assert (args.n_src, args.n_tgt, args.n_val) == (48, 24, 6)
    assert (args.src_hw, args.tgt_hw) == ([1052, 1914], [1024, 2048])
    assert args.gate_ce == 0.5 and args.stages == "1,2,3,4,c,eval"
    assert recipe.parse_args(["--no-target-only"]).target_only is False


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "recipe_chip", REPO / "tools" / "recipe_chip.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_LOG = """Epoch >>> 00 <<<
Loss [0000]: loss_ce 3.2344 | src_loss_ce 3.1572 | Im/Sec: 44.7
Loss [0000]: loss_ce 2.1000 | src_loss_ce 1.5e+00 | Im/Sec: 40.0
Backbone model not found: models/pretrained/resnet101-5d3b4d8f.pth
""" + "".join("Loss [0000]: loss_ce {:.4f} | src_loss_ce {:.4f} | "
              "Im/Sec: 30.1\n".format(1.0 / (k + 1), 0.9 / (k + 2))
              for k in range(11))


@pytest.mark.parametrize("n_lines", [3, 13])
def test_gate_quantity_equals_jax(tmp_path, n_lines):
    log = tmp_path / "stage1_abn.log"
    log.write_text("".join(_LOG.splitlines(True)[:n_lines + 1]))
    jax_mod = _jax_recipe()
    for n in (1, 10):
        assert recipe.trailing_src_ce(str(log), n) == \
            jax_mod._trailing_src_ce(str(log), n)
    # the finite-loss checks agree too
    recipe.assert_finite_losses(str(log))
    jax_mod._assert_finite_losses(str(log))
    bad = tmp_path / "bad.log"
    bad.write_text(_LOG + "Loss [0000]: loss_ce nan | src_loss_ce 1.0\n")
    for check, error in ((recipe.assert_finite_losses, RuntimeError),
                         (jax_mod._assert_finite_losses, AssertionError)):
        with pytest.raises(error, match="non-finite"):
            check(str(bad))


@pytest.mark.parametrize("name", ["deeplabv2_resnet101_train.yaml",
                                  "deeplabv2_resnet101.yaml",
                                  "tiny_cpu.yaml"])
def test_source_norm_override_equals_jax(name):
    path = str(REPO / "configs" / name)
    jax_mod = _jax_recipe()
    jax_mod._set_cfg(path)
    ours = recipe.source_norm_override(path)
    assert ours == jax_mod._source_norm_override()
    assert ours[0] == "DATASET.MEAN" and ours[2] == "DATASET.STD"
