"""Offline dataset packing: decode a split's PNGs once into memmap files
(counterpart of ``dasac_tpu/tools/pack_dataset.py``: the same packs, byte
for byte, with ``TPU.NATIVE_LOADER`` on in both).

No reference counterpart — the reference re-decodes every PNG each epoch
through PIL worker processes (datasets/dataloader_seg.py:28-161).  Packing
moves the decode offline: the port's ``SegDataset`` decodes each sample
once (through the C++ decoder, ``data/native.py``, unless
``native.set_enabled(False)``), and after packing the data factory
(data/factory.py) detects the pack and serves page-cached memmap slices.

Usage (sizes default to the split's training-time decode size):

  # source split at its canonical size (GTA: 1052x1914)
  python -m dasac_tpu_torch.tools.pack_dataset --root /data/gta5 \
      --split train_game_9K

  # SAC target groups decode at CROP_SIZE -> pack at that size
  python -m dasac_tpu_torch.tools.pack_dataset --root /data/cityscapes \
      --split train_cityscapes --size 512 1024

Packs land in ``<root>/packed`` (override with --out).
"""

import argparse

from dasac_tpu_torch.data import lists, packed
from dasac_tpu_torch.data.factory import _split_size
from dasac_tpu_torch.data.host_loader import SegDataset


def pack_split(root, split, size=None, out_dir=None, list_dir=None,
               verbose=True):
    images, masks = lists.read_split(root, split, list_dir=list_dir)
    if size is None:
        size = _split_size(split, images)
    dataset = SegDataset(images, masks, size, mode="resize")
    out_dir = out_dir or packed.default_dir(root)
    hdr = packed.write_pack(dataset, split, out_dir, verbose=verbose)
    if verbose:
        print("packed %d samples @ %dx%d -> %s"
              % (len(images), size[0], size[1], hdr))
    return hdr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="DATASET.ROOT of the split")
    ap.add_argument("--split", required=True, action="append",
                    help="split name (repeatable)")
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="decode size (default: the split's canonical "
                         "training-time size)")
    ap.add_argument("--out", default=None,
                    help="pack directory (default <root>/packed)")
    ap.add_argument("--list-dir", default=None)
    args = ap.parse_args(argv)
    for split in args.split:
        pack_split(args.root, split, size=args.size, out_dir=args.out,
                   list_dir=args.list_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
