"""Offline trainId conversion (counterpart of
``dasac_tpu/tools/convert_train_ids.py``; reference
tools/convert_train_ids.py:35-100): walk a label directory, remap every
mask to Cityscapes trainIds via the dataset's LUT (one gather per image),
mirror the directory structure.  Masks are read and written by the port's
PNG codec (``data/png.py``), as 8-bit gray.

    python -m dasac_tpu_torch.tools.convert_train_ids --dataset gta \\
        --ann-data <GTA labels> --ann-out <labels_cs>
"""

import argparse
import fnmatch
import os
import sys

from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.id_mappers import get_mapper


def convert_one(filepath, out_dir, mapper):
    if not os.path.isfile(filepath):
        print("No such file found:", filepath)
        return False
    raw = mapper.read(filepath)
    new_mask = mapper.remap(raw)
    if (new_mask == 255).all():
        return False  # nothing mapped
    if new_mask.ndim == 3:   # a colour label file: PIL's convert("L")
        new_mask = png.luma(new_mask)
    png.write(os.path.join(out_dir, os.path.basename(filepath)), new_mask)
    return True


def preprocess(dataset, ann_data, ann_out, verbose=True):
    mapper = get_mapper(dataset)
    os.makedirs(ann_out, exist_ok=True)

    files = []
    for root, _, filenames in os.walk(ann_data):
        for fn in fnmatch.filter(filenames, mapper.ext()):
            subdir = root.replace(ann_data, "").lstrip("/")
            files.append((os.path.join(root, fn), subdir))
    if verbose:
        print("Found {:d} files".format(len(files)))

    n = 0
    for fp, subdir in files:
        out_dir = os.path.join(ann_out, subdir)
        os.makedirs(out_dir, exist_ok=True)
        if convert_one(fp, out_dir, mapper):
            n += 1
    if verbose:
        print("Processed {} files".format(n))
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="Label ID pre-processing")
    parser.add_argument("--dataset", choices=["cs", "gta", "synthia"])
    parser.add_argument("--ann-data", type=str, default="./data/labels")
    parser.add_argument("--ann-out", type=str, default="./data/annotation_out")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    preprocess(args.dataset, args.ann_data, args.ann_out)


if __name__ == "__main__":
    main()
