"""Offline mIoU of exported prediction PNGs (counterpart of
``dasac_tpu/tools/evaluate_miou.py``; the reference delegates the final
score to cityscapesScripts' ``evalPixelLevelSemanticLabeling``, reference
README.md:160-161).

It matches exported prediction masks (the trainId palette PNGs or the
Cityscapes-labelId PNGs under ``cs/`` that the infer CLI writes) against
ground-truth ``*_gtFine_labelIds.png`` files and reports per-class
IoU/precision/recall and the mean, with the training metrics' formulas
(``train/metrics.summarise``).  Files and numpy only: no device.

Protocol:
  * pixels whose ground truth maps to ignore (255) are dropped;
  * a prediction that maps to void/ignore goes to one extra column: a
    false negative of its ground-truth class, no class's false positive;
  * ``--ignore-class`` removes classes from the MEAN (the SYNTHIA 16-class
    protocol: 9 14 16, reference launch/train.sh:41) and keeps their rows;
  * ``--pred-format auto``: palette ("P") files are trainIds, a directory
    named ``cs`` holds labelIds, otherwise the value range decides (labelIds
    use 0..33 with values above 18 and no 255); decided once, from the
    first matched file;
  * values above 255 (16-bit PNGs) where labelIds are expected, and
    ground truth outside the trainIds, raise.

Usage:
  python -m dasac_tpu_torch.tools.evaluate_miou \\
      --pred <out>/cs --gt /data/cityscapes/gtFine/val \\
      [--pred-format auto|trainid|labelid] [--ignore-class 9 14 16] \\
      [--json out.json]
"""

import argparse
import glob
import json
import os

import numpy as np

from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.category import (IGNORE_LABEL, cs_to_trainid_table,
                                           get_class_names)
from dasac_tpu_torch.train.metrics import summarise

NUM_CLASSES = 19

_RECORD_SUFFIXES = ("_gtFine_labelIds", "_gtFine_labelTrainIds",
                    "_gtFine_instanceIds", "_gtFine_color", "_leftImg8bit")
# what PIL's Image.mode says for each kind of file
_MODES = {(0, 8): "L", (0, 16): "I;16", (2, 8): "RGB", (3, 8): "P",
          (6, 8): "RGBA"}


def _stem_key(path):
    """Frame key: the basename without its extension and any Cityscapes
    record suffix, so a prediction matches its ground truth whichever
    record name the exporter used."""
    base = os.path.splitext(os.path.basename(path))[0]
    for suf in _RECORD_SUFFIXES:
        if base.endswith(suf):
            return base[:-len(suf)]
    return base


def _index_gt(gt_dir):
    """(key -> path, format): ``*labelIds.png`` files hold Cityscapes
    labelIds; the plain-PNG fallback (synthetic layouts, converted masks)
    holds trainIds."""
    files = glob.glob(os.path.join(gt_dir, "**", "*labelIds.png"),
                      recursive=True)
    gt_format = "labelid"
    if not files:
        files = glob.glob(os.path.join(gt_dir, "**", "*.png"), recursive=True)
        gt_format = "trainid"
    return {_stem_key(f): f for f in files}, gt_format


def _read_mask(path):
    """(values, PIL mode) in the file's own width: 16-bit values survive to
    the range checks instead of wrapping into class ids; colour files go
    through PIL's ``convert("L")``."""
    img = png.read(path)
    mode = _MODES[img.color_type, img.bit_depth]
    if mode in ("RGB", "RGBA"):
        return png.to_mask(img), mode
    return img.pixels, mode


def _detect_format(arr, png_mode, pred_dir):
    if png_mode == "P":
        return "trainid"
    if os.path.basename(os.path.normpath(pred_dir)) == "cs":
        return "labelid"
    vals = np.unique(arr)
    if vals.max(initial=0) <= 33 and (vals > 18).any() and not (
            vals == IGNORE_LABEL).any():
        return "labelid"
    return "trainid"


def _to_trainid(values, path, lut):
    if values.max(initial=0) > 255:
        raise ValueError("%s holds values above 255 (e.g. %d) — not "
                         "Cityscapes labelIds" % (path, int(values.max())))
    return lut[values].astype(np.int64)


def evaluate_dirs(pred_dir, gt_dir, pred_format="auto", gt_format="auto",
                  num_classes=NUM_CLASSES, verbose=False):
    """The ``[C+1, C+1]`` int64 confusion over every matched (prediction,
    ground truth) pair, and the number of pairs."""
    gt_index, detected_gt = _index_gt(gt_dir)
    if gt_format == "auto":
        gt_format = detected_gt
    preds = sorted(glob.glob(os.path.join(pred_dir, "*.png")))
    if not preds:
        raise FileNotFoundError("no prediction PNGs in %s" % pred_dir)
    lut = cs_to_trainid_table()
    width = num_classes + 1
    conf = np.zeros((width, width), np.int64)
    matched = 0
    for i, p in enumerate(preds):
        gt_path = gt_index.get(_stem_key(p))
        if gt_path is None:
            continue
        matched += 1
        pred, png_mode = _read_mask(p)
        gt = _read_mask(gt_path)[0].astype(np.int64)
        if gt_format == "labelid":
            gt = _to_trainid(gt, gt_path, lut)
        if pred_format == "auto":
            pred_format = _detect_format(pred, png_mode, pred_dir)
        pred = pred.astype(np.int64)
        if pred_format == "labelid":
            pred = _to_trainid(pred, p, lut)
        if pred.shape != gt.shape:
            raise ValueError("%s is %s, its ground truth %s is %s"
                             % (p, pred.shape, gt_path, gt.shape))
        valid = gt != IGNORE_LABEL
        bad = valid & (gt >= num_classes)
        if bad.any():
            raise ValueError(
                "%s holds values outside the trainId range (e.g. %d) — if "
                "the ground truth is Cityscapes labelIds, pass --gt-format "
                "labelid" % (gt_path, int(gt[bad][0])))
        idx = gt[valid] * width + np.minimum(pred, num_classes)[valid]
        conf += np.bincount(idx, minlength=width * width).reshape(width,
                                                                  width)
        if verbose and (i + 1) % 100 == 0:
            print("  scored %d/%d" % (i + 1, len(preds)))
    if matched == 0:
        raise FileNotFoundError(
            "no prediction in %s matched a ground-truth mask in %s"
            % (pred_dir, gt_dir))
    return conf, matched


def format_report(conf, ignore_class=(), num_classes=NUM_CLASSES):
    """(report text, JSON payload) of a confusion that may carry the void
    column: only the real classes are reported, their rows still counting
    void predictions as false negatives."""
    iou, prec, rec = (m[:num_classes] for m in summarise(conf))
    names = get_class_names()[:num_classes]
    keep = [c for c in range(num_classes) if c not in set(ignore_class)]
    lines = ["{:<16} {:>7} {:>7} {:>7}".format("class", "IoU", "Pr", "Re")]
    for c in range(num_classes):
        tag = "" if c in keep else "  (excluded from mean)"
        lines.append("{:<16} {:7.4f} {:7.4f} {:7.4f}{}".format(
            names[c], iou[c], prec[c], rec[c], tag))
    miou = float(np.mean(iou[keep]))
    lines.append("{:<16} {:7.4f}  ({} classes)".format(
        "mean IoU", miou, len(keep)))
    return "\n".join(lines), {
        "mean_iou": miou,
        "classes": {names[c]: {"iou": float(iou[c]), "precision":
                               float(prec[c]), "recall": float(rec[c])}
                    for c in range(num_classes)},
        "ignored_classes": sorted(set(ignore_class)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pred", required=True,
                    help="directory of prediction PNGs")
    ap.add_argument("--gt", required=True,
                    help="ground-truth root (searched recursively for "
                         "*labelIds.png)")
    ap.add_argument("--pred-format", default="auto",
                    choices=["auto", "trainid", "labelid"])
    ap.add_argument("--gt-format", default="auto",
                    choices=["auto", "trainid", "labelid"],
                    help="auto: *labelIds.png files are labelIds, the "
                         "plain-PNG fallback is trainIds")
    ap.add_argument("--ignore-class", type=int, nargs="*", default=[],
                    help="class ids excluded from the mean "
                         "(SYNTHIA protocol: 9 14 16)")
    ap.add_argument("--json", default=None, help="also write a JSON report")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    conf, matched = evaluate_dirs(args.pred, args.gt, args.pred_format,
                                  gt_format=args.gt_format,
                                  verbose=args.verbose)
    report, payload = format_report(conf, args.ignore_class)
    payload["images"] = matched
    print("scored %d images" % matched)
    print(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
