"""Synthetic datasets on disk: PNGs + split lists in the reference layout
(counterpart of ``dasac_tpu/data/synth.py``'s ``make_synthetic_root``), so
the trainer CLI runs end to end without GTA5/Cityscapes.  The PNGs are
written by the port's own encoder (``data/png.py``, filter 0), and the
pixels are ``dasac_tpu``'s for the same arguments: the scenes are drawn
in order from the same ``numpy.random.RandomState`` stream, and only their
encoding runs on a thread pool (zlib releases the GIL).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.category import IGNORE_LABEL


def _toy_scene(rng, h, w, num_classes):
    """A blocky 'scene': horizontal bands + random rectangles, image =
    class-colored noise so segmentation is learnable."""
    mask = np.zeros((h, w), np.uint8)
    mask[h // 3:, :] = 1 % num_classes
    mask[2 * h // 3:, :] = 2 % num_classes
    for _ in range(3):
        c = rng.randint(0, num_classes)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        mask[y0:y0 + h // 4, x0:x0 + w // 4] = c
    base = np.linspace(0, 255, num_classes + 1)[mask]
    img = np.stack([
        base + rng.randn(h, w) * 10,
        255 - base + rng.randn(h, w) * 10,
        np.full((h, w), 128) + rng.randn(h, w) * 10,
    ], -1).clip(0, 255).astype(np.uint8)
    return img, mask


def make_synthetic_root(root, *, n_train_src=8, n_train_tgt=8, n_val=4,
                        hw=(64, 96), num_classes=19, seed=0,
                        source_split="train_game_9K",
                        target_split="train_cityscapes",
                        val_splits=("val_cityscapes", "val2_cityscapes",
                                    "train_cityscapes", "val_game_1K"),
                        src_hw=None, tgt_hw=None, val_hw=None,
                        ignore_frac=0.0):
    """Create a data root with images/, labels/, and split .txt files
    (``<image> <label>`` per line).  Returns the root path.

    Splits reuse the same pools where the reference does (train_cityscapes
    doubles as a val set).  ``src_hw``/``tgt_hw``/``val_hw`` override ``hw``
    per pool (e.g. native GTA/Cityscapes sizes).  ``ignore_frac`` sets that
    share of each mask's pixels to 255, drawn from a second stream
    (``seed + 1``) so the scenes stay ``dasac_tpu``'s; 0 leaves the masks
    as ``dasac_tpu`` writes them.
    """
    rng = np.random.RandomState(seed)
    ignore_rng = np.random.RandomState(seed + 1)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)

    def write_pool(prefix, n, pool_hw):
        pool_hw = pool_hw or hw
        lines = []
        for i in range(n):
            img, mask = _toy_scene(rng, pool_hw[0], pool_hw[1], num_classes)
            if ignore_frac:
                mask[ignore_rng.rand(*mask.shape) < ignore_frac] = \
                    IGNORE_LABEL
            ip = "images/{}_{:03d}.png".format(prefix, i)
            lp = "labels/{}_{:03d}.png".format(prefix, i)
            writes.append(pool.submit(png.write, os.path.join(root, ip), img))
            writes.append(pool.submit(png.write, os.path.join(root, lp),
                                      mask))
            lines.append("{} {}".format(ip, lp))
        return lines

    writes = []
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        src_lines = write_pool("src", n_train_src, src_hw)
        tgt_lines = write_pool("tgt", n_train_tgt, tgt_hw)
        val_lines = write_pool("val", n_val, val_hw)
    for w in writes:
        w.result()  # raise the first write error, if any

    def write_split(name, lines):
        with open(os.path.join(root, name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    write_split(source_split, src_lines)
    write_split(target_split, tgt_lines)
    for vs in val_splits:
        if vs == target_split:
            continue
        write_split(vs, val_lines)
    return root
