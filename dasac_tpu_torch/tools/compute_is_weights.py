"""Importance-sampling weights from predicted trainId masks (counterpart
of ``dasac_tpu/tools/compute_is_weights.py``; reference
tools/compute_IS_weights.py:42-98).

Given a directory of trainId masks (the ABN baseline's export on
``train_cityscapes``), writes each image's per-class pixel counts divided
by the class's total over the directory:
``{mask_basename: {class_id: class_pixels_in_image / total_class_pixels}}``.
Files and numpy only: no device.

``--format torch`` (or ``auto``, the default) writes with ``torch.save``, the format the
reference's ``DataTarget.init_sampling`` (dataloader_target.py:83-92)
loads; ``pickle`` is the other.  ``data/sampler.load_sample_weights`` of
either package reads both.

    python -m dasac_tpu_torch.tools.compute_is_weights --labels <out> \\
        --out <weights.data>
"""

import argparse
import fnmatch
import os
import pickle
import sys

import numpy as np
import torch

from dasac_tpu_torch.data import png


def _save(mask_stats, out, fmt):
    if fmt in ("auto", "torch"):
        torch.save(mask_stats, out)
    else:
        with open(out, "wb") as f:
            pickle.dump(mask_stats, f)


def count(labels_dir, ext="*.png", out=None, num_classes=19, verbose=True,
          fmt="auto"):
    """The weights dict of the masks in ``labels_dir``; written to ``out``
    (which must not exist yet) when given."""
    matches = sorted(os.path.join(labels_dir, f)
                     for f in fnmatch.filter(os.listdir(labels_dir), ext))
    if verbose:
        print("Found {} masks".format(len(matches)))

    mask_stats = {}
    pixel_count = np.zeros(num_classes, np.float64)
    num_images = np.zeros(num_classes, np.int64)
    for fp in matches:
        mask = png.read(fp).pixels
        counts = np.bincount(mask.reshape(-1), minlength=256)[:num_classes]
        present = np.nonzero(counts)[0]
        mask_stats[os.path.basename(fp)] = {
            int(c): float(counts[c]) for c in present}
        pixel_count[present] += counts[present]
        num_images[present] += 1

    if verbose:
        print("Pixel count / # of Images:")
        for c in range(num_classes):
            if pixel_count[c]:
                print("Class {:02d}: {:2.1f} {}".format(
                    c, pixel_count[c], num_images[c]))

    for stats in mask_stats.values():
        for c in stats:
            # plain Python floats: numpy scalars would trip torch.load's
            # weights_only unpickler on the reference side
            stats[c] = float(stats[c] / pixel_count[c])

    if out:
        if os.path.isfile(out):
            print("Output file already exists: {}".format(out))
            sys.exit(1)
        _save(mask_stats, out, fmt)
    return mask_stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="Count pixels")
    parser.add_argument("--labels", type=str, default="./data/labels")
    parser.add_argument("--ext", type=str, default="*.png")
    parser.add_argument("--out", type=str, default="./data/weights.data")
    parser.add_argument("--num-classes", type=int, default=19)
    parser.add_argument("--format", choices=["auto", "torch", "pickle"],
                        default="auto", dest="fmt",
                        help="'torch' (and 'auto'): torch.save, which the "
                             "reference loads (dataloader_target.py:83-92); "
                             "'pickle'")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    count(args.labels, args.ext, args.out, args.num_classes, fmt=args.fmt)


if __name__ == "__main__":
    main()
