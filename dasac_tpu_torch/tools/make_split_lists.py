"""Generate split lists (``image_path [mask_path]`` per line) from standard
dataset layouts (a copy of ``dasac_tpu/tools/make_split_lists.py``: the
same lists, byte for byte, for the same root, limit and seed).

The reference ships fixed lists (data/*.txt: train_game_9K, train_cityscapes,
val_cityscapes, ...).  For full reproduction of the published experiments use
the reference's lists verbatim (they are dataset index files, sampled by the
authors); this tool regenerates equivalent lists from a local dataset tree:

  cityscapes:  leftImg8bit/<split>/<city>/*_leftImg8bit.png
               + labels_cs/<split>/<city>/*_gtFine_labelIds.png (trainIds,
               produced by dasac_tpu_torch.tools.convert_train_ids)
  gta:         images/*.png + labels_cs/*.png
  synthia:     RGB/*.png + labels_cs/*.png

Usage:
  python -m dasac_tpu_torch.tools.make_split_lists --dataset cityscapes \
      --root data --image-dir leftImg8bit/train --label-dir labels_cs/train \
      --out data/train_cityscapes.txt [--limit 9000] [--seed 0]
"""

import argparse
import fnmatch
import os
import sys

import numpy as np


def collect(root, image_dir, label_dir=None, pattern="*.png",
            label_suffix=None):
    """Walk image_dir; pair each image with its label when label_dir is set.

    ``label_suffix``: (img_suffix, lbl_suffix) replacement applied to the
    basename (cityscapes: ("_leftImg8bit", "_gtFine_labelIds")).
    """
    pairs = []
    img_root = os.path.join(root, image_dir)
    for dirpath, _, files in os.walk(img_root):
        rel_dir = os.path.relpath(dirpath, img_root)
        for fn in sorted(fnmatch.filter(files, pattern)):
            img_rel = os.path.normpath(os.path.join(image_dir, rel_dir, fn))
            if label_dir is None:
                pairs.append((img_rel, None))
                continue
            lbl_name = fn
            if label_suffix:
                lbl_name = fn.replace(label_suffix[0], label_suffix[1])
            lbl_rel = os.path.normpath(os.path.join(label_dir, rel_dir,
                                                    lbl_name))
            if os.path.isfile(os.path.join(root, lbl_rel)):
                pairs.append((img_rel, lbl_rel))
    return pairs


def write_list(pairs, out_path, limit=0, seed=0):
    if limit and limit < len(pairs):
        rng = np.random.RandomState(seed)
        idx = sorted(rng.choice(len(pairs), size=limit, replace=False))
        pairs = [pairs[i] for i in idx]
    with open(out_path, "w") as f:
        for img, lbl in pairs:
            f.write(img if lbl is None else "{} {}".format(img, lbl))
            f.write("\n")
    return len(pairs)


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate split lists")
    p.add_argument("--dataset", choices=["cityscapes", "gta", "synthia"],
                   required=True)
    p.add_argument("--root", default="data")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--label-dir", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=0,
                   help="random subset size (e.g. 9000 for train_game_9K)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    suffix = (("_leftImg8bit", "_gtFine_labelIds")
              if args.dataset == "cityscapes" else None)
    pairs = collect(args.root, args.image_dir, args.label_dir,
                    label_suffix=suffix)
    n = write_list(pairs, args.out, args.limit, args.seed)
    print("Wrote {} entries to {}".format(n, args.out))


if __name__ == "__main__":
    main()
