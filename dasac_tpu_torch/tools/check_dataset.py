"""Dataset-layout validator: is a DATASET.ROOT ready for the recipe?
(Counterpart of ``dasac_tpu/tools/check_dataset.py``: the same checks,
report, hints and exit codes; files are read by the port's PNG codec,
``data/png.py``, and packs by its ``data/packed.py``.)

Real-data parity runs (PARITY_RUNBOOK.md) fail slowly and confusingly when
the data layout is wrong; this tool fails fast instead.  It checks, against
the 8 shipped split lists (reference ``data/*.txt``):

  * every image/mask path in the task's splits exists under --root, and the
    list lengths match the reference counts (train_game_9K=9000 etc.);
  * mask spot checks: N random masks per split decode to trainIds
    ({0..18, 255}) — raw Cityscapes labelIds / GTA ids / SYNTHIA 16-bit GT
    are detected and reported with the exact convert_train_ids command to
    run (reference README.md:104-110);
  * SYNTHIA 16-bit decode: 16-bit masks are decoded with the real
    16-bit reader (data/png16.py) and round-tripped through the id mapper;
  * packed-dir staleness: packs under <root>/packed whose sample count or
    mask basenames no longer match the current split list are flagged.

Usage:
  python -m dasac_tpu_torch.tools.check_dataset --root /data/dasac \
      --task gta [--spot 20] [--json report.json]

Exit code 0 = ready, 1 = hard failures found.
"""

import argparse
import json
import os

import numpy as np

from dasac_tpu_torch.data import lists, packed, png
from dasac_tpu_torch.data.category import IGNORE_LABEL
from dasac_tpu_torch.data.id_mappers import SynthiaMapper, get_mapper

# reference split sizes (SURVEY.md §2.1 "Split lists")
EXPECTED = {
    "train_game_9K": 9000, "train_synthia_9K": 9400,
    "train_cityscapes": 2975, "val_cityscapes": 500,
    "val2_cityscapes": 500, "val_game_1K": 1000,
    "val_synthia": 400, "test_cityscapes": 1525,
}

TASK_SPLITS = {
    "gta": ["train_game_9K", "val_game_1K", "train_cityscapes",
            "val_cityscapes", "val2_cityscapes"],
    "synthia": ["train_synthia_9K", "val_synthia", "train_cityscapes",
                "val_cityscapes", "val2_cityscapes"],
}


def _png_bit_depth(path):
    """(bit depth, color type) from the IHDR without a full decode
    ((None, None) if not a PNG).  Color type: 0 gray, 2 RGB, 3 palette,
    4 gray+alpha, 6 RGBA."""
    try:
        return png.ihdr(path)[2:]
    except (OSError, png.PngError):
        return None, None


def _check_mask(path, split):
    """-> (ok, kind, message).  kind in {trainid, labelid, raw, 16bit}."""
    depth, color = _png_bit_depth(path)
    if depth == 16:
        raw = SynthiaMapper.read(path)
        vals16 = np.unique(raw)
        if color == 0 and (((vals16 <= 18) | (vals16 == IGNORE_LABEL)).all()):
            # single-channel 16-bit holding trainId-range values: an
            # already-converted mask merely saved at 16-bit depth.  Accept
            # it only if the training loader reads the same values (its
            # Python path: png.to_mask, PIL's convert("L"))
            loaded = png.to_mask(png.read(path))
            if (loaded == raw).all():
                return True, "trainid", ""
            return False, "16bit", (
                "%s holds trainId-range values at 16-bit depth, but the "
                "8-bit load path reads different values — re-save it as "
                "8-bit grayscale" % path)
        # SYNTHIA raw GT: class id is the 16-bit VALUE of channel 0;
        # exercise the real decoder + the id-mapper round trip
        if raw.max(initial=0) > 22:
            return False, "16bit", (
                "16-bit mask %s decodes to ids up to %d (> SYNTHIA range); "
                "corrupt file?" % (path, int(raw.max())))
        train = get_mapper("synthia").remap(raw)
        valid = (train != IGNORE_LABEL).mean()
        return False, "16bit", (
            "%s is RAW 16-bit SYNTHIA GT (decodes fine: %.0f%% labeled "
            "after mapping) — convert it first:\n      python -m "
            "dasac_tpu_torch.tools.convert_train_ids --dataset synthia "
            "--ann-data <GT dir> --ann-out <labels_cs dir>"
            % (path, 100 * valid))
    arr = png.read(path).pixels
    if arr.ndim == 3:
        arr = arr[..., 0]
    vals = np.unique(arr)
    in_train = (vals <= 18) | (vals == IGNORE_LABEL)
    if in_train.all():
        return True, "trainid", ""
    # the convert_train_ids table must match the SPLIT the mask belongs
    # to, not the task: cityscapes target masks need --dataset cs even in
    # a synthia-task layout
    name = ("gta" if "game" in split
            else "synthia" if "synthia" in split else "cs")
    return False, "raw", (
        "%s holds values outside the trainId range (e.g. %s) — looks like "
        "unconverted ids; run:\n      python -m dasac_tpu_torch.tools."
        "convert_train_ids --dataset %s --ann-data <dir> --ann-out <dir>"
        % (path, [int(v) for v in vals[~in_train][:4]], name))


def check_root(root, task, spot=10, seed=0, verbose=True):
    """Returns (report dict, hard_failures list)."""
    rng = np.random.RandomState(seed)
    report, failures = {"root": root, "task": task, "splits": {}}, []

    for split in TASK_SPLITS[task]:
        entry = {"list": lists.find_split_file(root, split)}
        images, masks = lists.read_split(root, split, must_exist=False)
        entry["count"] = len(images)
        if EXPECTED.get(split) and len(images) != EXPECTED[split]:
            entry["count_warning"] = (
                "list has %d lines; the reference split has %d"
                % (len(images), EXPECTED[split]))
        missing = [p for p in images + [m for m in masks if m]
                   if not os.path.isfile(p)]
        entry["missing"] = len(missing)
        if missing:
            failures.append("%s: %d files missing under %s (e.g. %s)"
                            % (split, len(missing), root, missing[:3]))
            report["splits"][split] = entry
            continue

        with_masks = [m for m in masks if m]
        if with_masks and split != "test_cityscapes":
            picks = rng.choice(len(with_masks),
                               min(spot, len(with_masks)), replace=False)
            kinds, bad = {}, []
            for i in picks:
                ok, kind, msg = _check_mask(with_masks[int(i)], split)
                kinds[kind] = kinds.get(kind, 0) + 1
                if not ok:
                    bad.append(msg)
            entry["mask_kinds"] = kinds
            if bad:
                failures.append("%s: %d/%d spot-checked masks not trainIds"
                                "\n    %s" % (split, len(bad), len(picks),
                                              bad[0]))
        # image sanity: first image opens and has a plausible size
        entry["image_size"] = list(png.png_size(images[0])[::-1])

        # packed-dir staleness (factory auto-detect prefers the pack)
        pdir = packed.default_dir(root)
        stale = []
        if os.path.isdir(pdir):
            for fn in os.listdir(pdir):
                if fn.startswith(split + "_") and fn.endswith(".json"):
                    with open(os.path.join(pdir, fn)) as f:
                        meta = json.load(f)
                    names = [os.path.basename(m) if m else None
                             for m in masks]
                    if (meta.get("n") != len(images)
                            or meta.get("mask_basenames") != names):
                        stale.append(fn)
            if stale:
                failures.append(
                    "%s: stale pack(s) %s under %s — repack with "
                    "python -m dasac_tpu_torch.tools.pack_dataset or delete "
                    "them"
                    % (split, stale, pdir))
        entry["stale_packs"] = stale
        report["splits"][split] = entry
        if verbose:
            print("[%s] %d files ok%s" % (
                split, len(images),
                " | masks: %s" % entry.get("mask_kinds", {})
                if "mask_kinds" in entry else ""))

    return report, failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="DATASET.ROOT to validate")
    ap.add_argument("--task", required=True, choices=["gta", "synthia"])
    ap.add_argument("--spot", type=int, default=10,
                    help="masks to spot-check per split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    report, failures = check_root(args.root, args.task, spot=args.spot,
                                  seed=args.seed)
    if args.json:
        report["failures"] = failures
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if failures:
        print("\nNOT READY — %d problem(s):" % len(failures))
        for msg in failures:
            print("  * %s" % msg)
        return 1
    print("\nREADY: %s validates for the %s recipe" % (args.root, args.task))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
