"""The port's offline tools (``dasac_tpu_torch/tools``: ``evaluate_miou``,
``compute_is_weights``) against dasac_tpu's on the same files, and its
step tools (``profile_step``, ``compare_refine_res``, ``conv_roofline``,
``op_traffic``) on the CPU at the tiny size.

  * ``evaluate_miou``: prediction trees in every format the scorer detects
    (palette trainIds as the infer CLI exports them, gray trainIds, gray
    labelIds under ``cs/`` and elsewhere), with void predictions, against
    labelId and plain trainId ground truth, plain and with the SYNTHIA
    ``--ignore-class 9 14 16``: equal ``[C+1, C+1]`` confusions, equal
    reports and equal JSON;
  * 16-bit ground truth or labelId predictions with values above 255 raise
    in both;
  * ``compute_is_weights``: equal weight dicts, and each package's
    ``load_sample_weights`` reads the other's file, in both formats.

Step tools (each ``main(argv, device="cpu")``, ``tiny`` at 32x64, 2
source frames, one group of 2 views):

  * ``profile_step`` times the stages dasac_tpu's does (the names of its
    docstring's table), each > 0, under remat none and convs, and a subset;
  * ``compare_refine_res`` runs both arms from the same state and keeps
    ``src_loss_ce`` equal at their first step; ``--json`` writes what it
    returns;
  * ``conv_roofline``'s shape table equals dasac_tpu's
    ``flagship_convs()``; on two small shapes its rows are the FLOPs over
    the measured ms and its floor their sum; the peak comes by card name;
  * ``op_traffic`` counts the bytes of a small function as worked out by
    hand, and ranks a tiny step's ops;
  * every step tool raises without a card when no device is given.

Files are written with PIL.  Wall time of this file on the CPU host the
tier-1 tests run on: ~10 s run alone.
"""

import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from dasac_tpu.data import sampler as jsampler
from dasac_tpu.data.category import train_palette
from dasac_tpu.tools import compute_is_weights as jis
from dasac_tpu.tools import conv_roofline as jroofline
from dasac_tpu.tools import evaluate_miou as jeval
from dasac_tpu.tools import profile_step as jprofile
from dasac_tpu_torch.data import sampler as tsampler
from dasac_tpu_torch.data.category import (cs_to_trainid_table,
                                           trainid_to_cs_table)
import torch
from dasac_tpu_torch.tools import compare_refine_res
from dasac_tpu_torch.tools import compute_is_weights as tis
from dasac_tpu_torch.tools import conv_roofline
from dasac_tpu_torch.tools import evaluate_miou as teval
from dasac_tpu_torch.tools import op_traffic, profile_step

C = 19
HW = (24, 40)
KEYS = ["city_%06d_000019" % i for i in range(4)]


def _save(path, arr, palette=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = Image.fromarray(arr)
    if palette:
        im = Image.fromarray(arr, mode="P")
        im.putpalette(train_palette().tolist())
    im.save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Ground truth as labelIds (gtFine) and as plain trainIds, and
    predictions of the same masks in four formats."""
    base = str(tmp_path_factory.mktemp("trees"))
    rng = np.random.RandomState(0)
    t2c = trainid_to_cs_table()
    for i, key in enumerate(KEYS):
        gt = rng.randint(0, C, HW).astype(np.uint8)
        gt[rng.rand(*HW) < 0.1] = 255
        # labelIds: void trainIds as labelId 0 (unlabeled) and 4 (static)
        lid = t2c[gt]
        lid[(gt == 255) & (rng.rand(*HW) < 0.5)] = 4
        _save(os.path.join(base, "gtFine", "val", "city",
                           key + "_gtFine_labelIds.png"), lid)
        _save(os.path.join(base, "gt_train", key + ".png"), gt)
        pred = np.where(rng.rand(*HW) < 0.6, gt,
                        rng.randint(0, C, HW)).astype(np.uint8)
        pred[gt == 255] = rng.randint(0, C, int((gt == 255).sum()))
        if i == 1:   # a void prediction: labelId 0 / trainId 255
            pred[:3] = 255
        name = key + "_gtFine_labelIds.png"
        _save(os.path.join(base, "p_palette", name), pred, palette=True)
        _save(os.path.join(base, "p_gray", key + "_leftImg8bit.png"), pred)
        _save(os.path.join(base, "p_palette", "cs", name), t2c[pred])
        _save(os.path.join(base, "p_labelid", name), t2c[pred])
    return base


CASES = [("p_palette", "gtFine", []), ("p_palette/cs", "gtFine", []),
         ("p_labelid", "gtFine", []), ("p_gray", "gtFine", []),
         ("p_palette", "gt_train", []), ("p_labelid", "gtFine", [9, 14, 16]),
         ("p_palette/cs", "gtFine", [9, 14, 16])]


@pytest.mark.parametrize("pred,gt,ignore", CASES,
                         ids=["-".join([p, g, str(len(i))])
                              for p, g, i in CASES])
def test_evaluate_miou_matches_jax(trees, tmp_path, capsys, pred, gt,
                                   ignore):
    pred_dir, gt_dir = os.path.join(trees, pred), os.path.join(trees, gt)
    ours, n = teval.evaluate_dirs(pred_dir, gt_dir)
    ref, n_ref = jeval.evaluate_dirs(pred_dir, gt_dir)
    assert n == n_ref == len(KEYS)
    assert ours.shape == (C + 1, C + 1)
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() > 0
    if pred == "p_gray":   # the value range decides: trainIds with voids
        assert ours[:, C].sum() > 0
    ign = ["--ignore-class", *map(str, ignore)] if ignore else []
    jt, jj = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert teval.main(["--pred", pred_dir, "--gt", gt_dir, "--json", jt,
                       *ign]) == 0
    out_t = capsys.readouterr().out
    assert jeval.main(["--pred", pred_dir, "--gt", gt_dir, "--json", jj,
                       *ign]) == 0
    assert out_t == capsys.readouterr().out
    with open(jt) as ft, open(jj) as fj:
        assert json.load(ft) == json.load(fj)


def test_evaluate_miou_forced_formats_match_jax(trees):
    for pf, gf, pred, gt in (("labelid", "labelid", "p_labelid", "gtFine"),
                             ("trainid", "trainid", "p_gray", "gt_train")):
        args = (os.path.join(trees, pred), os.path.join(trees, gt), pf, gf)
        np.testing.assert_array_equal(teval.evaluate_dirs(*args)[0],
                                      jeval.evaluate_dirs(*args)[0])


@pytest.mark.parametrize("where", ["gt", "pred"])
def test_evaluate_miou_16bit_out_of_range_raises(tmp_path, where):
    big = np.full(HW, 7, np.uint16)
    big[0, 0] = 300
    small = np.full(HW, 7, np.uint8)
    gt, pred = (big, small) if where == "gt" else (small, big)
    name = KEYS[0] + "_gtFine_labelIds.png"
    _save(str(tmp_path / "gt" / name), gt)
    _save(str(tmp_path / "cs" / name), pred)
    for mod in (teval, jeval):
        with pytest.raises(ValueError, match="above 255"):
            mod.evaluate_dirs(str(tmp_path / "cs"), str(tmp_path / "gt"))


def test_evaluate_miou_rejects_trainid_gt_out_of_range(tmp_path):
    name = KEYS[0] + ".png"
    _save(str(tmp_path / "gt" / name), np.full(HW, 40, np.uint8))
    _save(str(tmp_path / "pred" / name), np.zeros(HW, np.uint8))
    for mod in (teval, jeval):
        with pytest.raises(ValueError, match="outside the trainId range"):
            mod.evaluate_dirs(str(tmp_path / "pred"), str(tmp_path / "gt"))


def test_labelid_tables_are_inverse():
    t2c, c2t = trainid_to_cs_table(), cs_to_trainid_table()
    np.testing.assert_array_equal(c2t[t2c[np.arange(C)]], np.arange(C))


# ---------------------------------------------------------------------------
# importance-sampling weights
# ---------------------------------------------------------------------------

def test_compute_is_weights_matches_jax_both_formats(trees, tmp_path):
    labels = os.path.join(trees, "p_palette")
    ours = tis.count(labels, verbose=False)
    ref = jis.count(labels, verbose=False)
    assert ours == ref and len(ours) == len(KEYS)
    assert all(type(v) is float for s in ours.values() for v in s.values())
    gray = tis.count(os.path.join(trees, "p_gray"), verbose=False)
    assert gray == jis.count(os.path.join(trees, "p_gray"), verbose=False)
    for fmt in ("torch", "pickle"):
        t_out, j_out = str(tmp_path / ("t_" + fmt)), str(tmp_path / ("j_" + fmt))
        tis.main(["--labels", labels, "--out", t_out, "--format", fmt])
        jis.main(["--labels", labels, "--out", j_out, "--format", fmt])
        assert jsampler.load_sample_weights(t_out) == ref
        assert tsampler.load_sample_weights(j_out) == ref
        assert tsampler.load_sample_weights(t_out) == ref


# ---------------------------------------------------------------------------
# step tools
# ---------------------------------------------------------------------------

TINY_STEP = ["--arch", "tiny", "--hw", "32", "64", "--batch", "2",
             "--groups", "1", "--group-size", "2"]


def _jax_stages():
    """The stages dasac_tpu's profile_step times: its docstring's table."""
    return {m.group(1) for m in re.finditer(r"^  (\w+)\s{2,}\S",
                                            jprofile.__doc__, re.M)}


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("remat", ["none", "convs"])
def test_profile_step_times_the_stages_jax_times(capsys, remat):
    results = profile_step.main(TINY_STEP + ["--iters", "1", "--remat",
                                             remat], device="cpu")
    assert set(results) == _jax_stages() == set(profile_step.STAGES)
    assert all(v > 0 for v in results.values())
    lines = _json_lines(capsys.readouterr().out)
    assert {r["stage"]: r["ms"] for r in lines} == results
    assert all(r["card"] == "cpu" and r["remat"] == remat for r in lines)


def test_profile_step_stage_subset():
    results = profile_step.main(
        TINY_STEP + ["--iters", "1", "--stages", "aug", "refine",
                     "--refine-res", "full", "--refine-dtype", "float32",
                     "--resize-method", "gather"], device="cpu")
    assert set(results) == {"aug", "refine"}


def test_compare_refine_res_keeps_the_source_branch_equal(tmp_path, capsys):
    path = str(tmp_path / "crr.json")
    out = compare_refine_res.main(TINY_STEP + [
        "--warmup", "2", "--steps", "3", "--every", "2", "--batches", "2",
        "--json", path], device="cpu")
    rows = out["trajectories"]
    assert [r["step"] for r in rows["full"]] == [1, 2] == [
        r["step"] for r in rows["stride8"]]
    assert rows["full"][0]["src_loss_ce"] == rows["stride8"][0]["src_loss_ce"]
    assert set(out["worst_abs_delta"]) == {"src_loss_ce", "self_ce",
                                           "teacher_diff", "pseudo_cover"}
    assert all(np.isfinite(v) for r in rows["full"] + rows["stride8"]
               for v in r.values())
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert "worst |Δ|" in capsys.readouterr().out


def test_conv_roofline_shape_table_equals_jax():
    assert conv_roofline.flagship_convs() == jroofline.flagship_convs()


def test_conv_roofline_rows_and_floor_on_small_shapes(monkeypatch):
    shapes = [("a3x3d2", (8, 8), 4, 8, 3, 2, 3),
              ("b1x1", (4, 6), 8, 4, 1, 1, 1)]
    monkeypatch.setattr(conv_roofline, "flagship_convs", lambda: shapes)
    out = conv_roofline.main(["--batch", "2", "--iters", "1", "--peak-tf",
                              "0.5"], device="cpu")
    assert [r["conv"] for r in out["rows"]] == ["a3x3d2", "b1x1"]
    for row, (_, hw, cin, cout, k, _, mult) in zip(out["rows"], shapes):
        flops = 3 * 2 * 2 * hw[0] * hw[1] * k * k * cin * cout
        assert np.isclose(row["tf_s"] * row["ms"] * 1e9, flops)
        assert np.isclose(row["share_of_peak"], row["tf_s"] / 0.5)
        assert np.isclose(row["ms_per_step"], row["ms"] * mult * 9 / 8)
    floor = out["floor"]
    assert np.isclose(floor["conv_bound_floor_ms"],
                      sum(r["ms_per_step"] for r in out["rows"]))
    assert floor["peak_tf"] == 0.5 and floor["card"] == "cpu"


@pytest.mark.parametrize("card,peak", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 989.4),
    ("NVIDIA H100 PCIe, 350.00 W", 756.5),
    ("NVIDIA H100 NVL, 400.00 W", 835.5), ("cpu", None)])
def test_conv_roofline_peak_by_card_name(card, peak):
    assert conv_roofline.peak_tf(card) == peak
    assert conv_roofline.peak_tf(card, override=123.0) == 123.0


def test_op_traffic_counts_the_bytes_worked_out_by_hand():
    x = torch.ones(4, 8)                          # 128 B f32
    w = torch.ones(8, 16, dtype=torch.bfloat16)   # 256 B bf16

    def fn():
        y = x * 2          # reads x, writes 128 B
        v = y.view(32)     # a view: nothing
        y.add_(1)          # reads y, writes y in place: 128 B
        v.sum()            # reads 128 B, writes 4 B
        torch.empty(4, 8)  # an allocation writes nothing
        return x.to(torch.bfloat16) @ w   # 128 -> 64 B; mm 64 + 256 -> 128

    t = op_traffic.record(fn)
    assert t.ops == {
        "aten.mul": {"calls": 1, "read": 128, "written": 128},
        "aten.add_": {"calls": 1, "read": 128, "written": 128},
        "aten.sum": {"calls": 1, "read": 128, "written": 4},
        "aten.empty": {"calls": 1, "read": 0, "written": 0},
        "aten._to_copy": {"calls": 1, "read": 128, "written": 64},
        "aten.mm": {"calls": 1, "read": 320, "written": 128}}
    assert t.totals() == (832, 452)
    assert t.written_by_dtype == {"float32": 260, "bfloat16": 192}
    top = op_traffic.report(t, 2)["top"]
    assert [r["op"] for r in top] == ["aten.mul", "aten.add_"]


def test_op_traffic_ranks_the_ops_of_a_step(capsys):
    out = op_traffic.main(TINY_STEP + ["--top", "5"], device="cpu")
    written = [r["written_gb"] for r in out["top"]]
    assert len(written) == 5 and written == sorted(written, reverse=True)
    assert out["total_written_gb"] > sum(written) > 0
    assert out["total_read_gb"] > 0 and out["card"] == "cpu"
    assert _json_lines(capsys.readouterr().out)[-1]["ops"] == out["ops"]


@pytest.mark.parametrize("tool", [profile_step, compare_refine_res,
                                  conv_roofline, op_traffic])
def test_step_tools_raise_without_a_device(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
