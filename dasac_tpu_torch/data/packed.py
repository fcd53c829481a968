"""Packed dataset format: decoded uint8 samples in flat memmap files (a
copy of ``dasac_tpu/data/packed.py``, same v2 format).

The reference decodes PNGs on every epoch through PIL worker processes
(reference datasets/dataloader_seg.py:28-161); on hosts with few cores the
decode becomes the training bottleneck, and the port's own PNG decoder
(``data/png.py``) is slow on Average/Paeth-filtered rows.  Packing decodes
each split ONCE offline (``python -m dasac_tpu.tools.pack_dataset`` on a
host with PIL, or :func:`write_pack` here from the port's ``SegDataset``)
into

    <packed_dir>/<split>_<H>x<W>.imgs.u8   [n, H, W, 3] uint8, C order
    <packed_dir>/<split>_<H>x<W>.msks.u8   [n, H, W]    uint8
    <packed_dir>/<split>_<H>x<W>.json      header (n, hw, mode, basenames)

after which training reads samples as page-cached memmap slices — no decode,
no Python-side image work.  The data factory auto-detects a pack matching
the split and requested size and transparently prefers it.
"""

import json
import os

import numpy as np

from dasac_tpu_torch.data.category import IGNORE_LABEL

_VERSION = 2  # v2: header carries image basenames (pack-identity check)


def default_dir(root):
    return os.path.join(root, "packed")


def pack_paths(packed_dir, split, out_hw):
    stem = "%s_%dx%d" % (split, out_hw[0], out_hw[1])
    base = os.path.join(packed_dir, stem)
    return base + ".json", base + ".imgs.u8", base + ".msks.u8"


def find_pack(packed_dir, split, out_hw, mode):
    """Header path if a pack matching (split, size, decode mode) exists."""
    if not packed_dir or out_hw is None:
        return None
    hdr, imgs, msks = pack_paths(packed_dir, split, out_hw)
    if not (os.path.isfile(hdr) and os.path.isfile(imgs)
            and os.path.isfile(msks)):
        return None
    try:
        with open(hdr) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if meta.get("version") != _VERSION or meta.get("mode") != mode:
        return None
    if tuple(meta.get("hw", ())) != tuple(out_hw):
        return None
    # data files must hold exactly n samples: a truncated pack (interrupted
    # copy, disk-full) must fall back to decode, not crash memmap later
    n, (h, w) = meta.get("n", 0), out_hw
    if (os.path.getsize(imgs) != n * h * w * 3
            or os.path.getsize(msks) != n * h * w):
        return None
    return hdr


class PackedDataset:
    """Same interface as host_loader.SegDataset, backed by memmap slices."""

    def __init__(self, header_path):
        with open(header_path) as f:
            meta = json.load(f)
        assert meta["version"] == _VERSION, meta
        self.out_hw = tuple(meta["hw"])
        self.mode = meta["mode"]
        self._mask_basenames = meta["mask_basenames"]
        self._image_basenames = meta["image_basenames"]
        self._n = int(meta["n"])
        base = header_path[:-len(".json")]
        h, w = self.out_hw
        self._imgs = np.memmap(base + ".imgs.u8", np.uint8, "r",
                               shape=(self._n, h, w, 3))
        self._msks = np.memmap(base + ".msks.u8", np.uint8, "r",
                               shape=(self._n, h, w))
        self.num_samples = self._n  # may be overridden (epoch alignment)

    def set_num_samples(self, n):
        self.num_samples = n

    def __len__(self):
        return self.num_samples

    def load(self, i):
        if i < 0:  # padding sample, same contract as SegDataset.load
            return (np.zeros((*self.out_hw, 3), np.uint8),
                    np.full(self.out_hw, IGNORE_LABEL, np.uint8))
        i = i % self._n
        # np.array copies the slice out of the memmap so downstream stacking
        # and H2D never touch mmap pages under concurrent file replacement
        return np.array(self._imgs[i]), np.array(self._msks[i])

    def load_batch(self, idxs, pool=None, threads=None):
        return [self.load(i) for i in idxs]

    def mask_basenames(self):
        return list(self._mask_basenames)

    def image_basenames(self):
        return list(self._image_basenames)


def write_pack(dataset, split, packed_dir, verbose=True):
    """Decode every sample of ``dataset`` (a SegDataset) into a pack.

    Streams sample-by-sample so packing 9K full-resolution frames never
    holds more than one decoded image in memory.
    """
    assert dataset.out_hw is not None, "packing requires a fixed sample size"
    os.makedirs(packed_dir, exist_ok=True)
    hdr, imgs_path, msks_path = pack_paths(packed_dir, split, dataset.out_hw)
    n = len(dataset.images)
    h, w = dataset.out_hw
    imgs = np.memmap(imgs_path + ".tmp", np.uint8, "w+", shape=(n, h, w, 3))
    msks = np.memmap(msks_path + ".tmp", np.uint8, "w+", shape=(n, h, w))
    for i in range(n):
        img, msk = dataset.load(i)
        assert img.shape == (h, w, 3) and msk.shape == (h, w), (
            dataset.images[i], img.shape, msk.shape)
        imgs[i] = img
        msks[i] = msk
        if verbose and (i + 1) % 200 == 0:
            print("  packed %d/%d" % (i + 1, n))
    imgs.flush()
    msks.flush()
    del imgs, msks
    meta = {
        "version": _VERSION,
        "n": n,
        "hw": [h, w],
        "mode": dataset.mode,
        "mask_basenames": dataset.mask_basenames(),
        "image_basenames": [os.path.basename(p) for p in dataset.images],
    }
    with open(hdr + ".tmp", "w") as f:
        json.dump(meta, f)
    # rename the header LAST: find_pack only trusts a pack whose header
    # exists, so a crash mid-pack never leaves a valid-looking partial pack
    os.replace(imgs_path + ".tmp", imgs_path)
    os.replace(msks_path + ".tmp", msks_path)
    os.replace(hdr + ".tmp", hdr)
    return hdr
