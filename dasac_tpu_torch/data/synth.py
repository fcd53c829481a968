"""Synthetic datasets on disk: PNGs + split lists in the reference layout
(counterpart of ``dasac_tpu/data/synth.py``'s ``make_synthetic_root`` and
``make_domain_gap_root``), so the trainer CLI runs end to end without
GTA5/Cityscapes.  The PNGs are
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


def _blob_scene(rng, h, w, colors, class_ids, noise=8.0):
    """Blob scene whose colors map 1:1 to class ids (learnable task):
    a base class plus random rectangles at scene-proportional sizes."""
    n_cls = len(class_ids)
    m = np.zeros((h, w), np.uint8)
    m[:] = rng.randint(0, n_cls)
    bh, bw = max(h // 8, 8), max(w // 8, 8)
    for _ in range(12):
        k = rng.randint(0, n_cls)
        y = rng.randint(0, max(h - bh, 1))
        x = rng.randint(0, max(w - bw, 1))
        m[y:y + rng.randint(bh, 3 * bh), x:x + rng.randint(bw, 3 * bw)] = k
    img = colors[m] + rng.randn(h, w, 3) * noise
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, np.asarray(class_ids, np.uint8)[m]


# fixed channel-mixing domain shift: beyond what the source chain's
# photometric jitter (brightness/contrast/saturation + hue<=0.1) can mimic,
# so a source-trained model genuinely underperforms on the target domain
_GAP_MIX = np.array([[0.70, 0.30, 0.00],
                     [0.00, 0.70, 0.30],
                     [0.30, 0.00, 0.70]])
_GAP_GAIN = 0.55
_GAP_SHIFT = np.array([70.0, 25.0, -15.0])


def _write_split(root, name, lines):
    with open(os.path.join(root, name + ".txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def make_domain_gap_root(root, *, n_train_src=48, n_train_tgt=24, n_val=6,
                         src_hw=(1052, 1914), tgt_hw=(1024, 2048),
                         num_classes=19, seed=0,
                         source_split="train_game_9K",
                         target_split="train_cityscapes"):
    """Domain-gapped corpus at (near-)native GTA/Cityscapes sizes for the
    three-stage recipe run (reference README.md:145-166): blob scenes whose
    colors map 1:1 to 12 of the 19 classes; the target domain applies a
    fixed channel-mixing + compression + offset to every class color.
    val/val2_cityscapes draw from the TARGET domain (val2 is the
    checkpoint-selection split), val_game_1K from the SOURCE domain; all
    val pools share ``tgt_hw``.  The pixels and split files are
    ``dasac_tpu``'s for the same arguments.
    """
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)

    class_ids = [0, 1, 2, 5, 7, 8, 10, 11, 13, 15, 16, 18][:num_classes]
    src_colors = np.stack([
        np.array([210, 60, 60]), np.array([60, 200, 70]),
        np.array([60, 70, 210]), np.array([220, 200, 60]),
        np.array([150, 60, 200]), np.array([60, 200, 200]),
        np.array([230, 140, 60]), np.array([120, 120, 120]),
        np.array([200, 60, 140]), np.array([90, 160, 60]),
        np.array([50, 110, 170]), np.array([240, 230, 210]),
    ]).astype(float)[:len(class_ids)]
    tgt_colors = np.clip(
        _GAP_GAIN * (src_colors @ _GAP_MIX.T) + _GAP_SHIFT, 0, 255)

    def write_pool(prefix, n, pool_hw, colors):
        lines = []
        for i in range(n):
            img, mask = _blob_scene(rng, pool_hw[0], pool_hw[1], colors,
                                    class_ids)
            ip = "images/{}_{:03d}.png".format(prefix, i)
            lp = "labels/{}_{:03d}.png".format(prefix, i)
            writes.append(pool.submit(png.write, os.path.join(root, ip), img))
            writes.append(pool.submit(png.write, os.path.join(root, lp),
                                      mask))
            lines.append("{} {}".format(ip, lp))
        return lines

    writes = []
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        src_lines = write_pool("src", n_train_src, src_hw, src_colors)
        tgt_lines = write_pool("tgt", n_train_tgt, tgt_hw, tgt_colors)
        val_t = write_pool("valt", n_val, tgt_hw, tgt_colors)
        val2_t = write_pool("val2t", n_val, tgt_hw, tgt_colors)
        val_s = write_pool("vals", n_val, tgt_hw, src_colors)
    for w in writes:
        w.result()  # raise the first write error, if any

    _write_split(root, source_split, src_lines)
    _write_split(root, target_split, tgt_lines)
    _write_split(root, "val_cityscapes", val_t)
    _write_split(root, "val2_cityscapes", val2_t)
    _write_split(root, "val_game_1K", val_s)
    return root


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

    _write_split(root, source_split, src_lines)
    _write_split(root, target_split, tgt_lines)
    for vs in val_splits:
        if vs == target_split:
            continue
        _write_split(root, vs, val_lines)
    return root
