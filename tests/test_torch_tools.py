"""The port's offline tools (``dasac_tpu_torch/tools``: ``evaluate_miou``,
``compute_is_weights``) against dasac_tpu's on the same files.

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

Files are written with PIL.  Wall time of this file on the CPU host the
tier-1 tests run on: ~5 s run alone.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from dasac_tpu.data import sampler as jsampler
from dasac_tpu.data.category import train_palette
from dasac_tpu.tools import compute_is_weights as jis
from dasac_tpu.tools import evaluate_miou as jeval
from dasac_tpu_torch.data import sampler as tsampler
from dasac_tpu_torch.data.category import (cs_to_trainid_table,
                                           trainid_to_cs_table)
from dasac_tpu_torch.tools import compute_is_weights as tis
from dasac_tpu_torch.tools import evaluate_miou as teval

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
