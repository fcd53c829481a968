"""Split-list reading, a copy of ``dasac_tpu/data/lists.py`` (the
reference's ``data/<split>.txt`` format: ``image_path [mask_path]`` per
line, paths relative to DATASET.ROOT — dataloader_seg.py:46-66).

The author-curated lists ship verbatim in ``<repo>/data/*.txt`` (notably
``val2_cityscapes`` — the 500-image checkpoint-selection subset sampled from
the Cityscapes train split, datasets/__init__.py:21-27, which cannot be
regenerated).  ``read_split`` looks for ``<root>/<split>.txt`` first (the
reference layout: copy the lists into DATASET.ROOT) and falls back to the
bundled copies, with image/mask paths always resolved against ``root``.
"""

import os

# <repo>/data — the bundled verbatim reference lists
BUNDLED_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "data"))


def find_split_file(root, split, list_dir=None):
    """``<list_dir or root>/<split>.txt`` if present, else the bundled
    copy."""
    split_fn = os.path.join(list_dir or root, split + ".txt")
    if not os.path.isfile(split_fn):
        bundled = os.path.join(BUNDLED_DIR, split + ".txt")
        if os.path.isfile(bundled):
            return bundled
    assert os.path.isfile(split_fn), (
        "Split file not found: {} (and no bundled data/{}.txt)".format(
            split_fn, split))
    return split_fn


def read_split(root, split, list_dir=None, must_exist=True):
    """Returns (image_paths, mask_paths) — mask is None when absent.

    Image/mask paths always resolve against ``root`` (the reference's
    DATASET.ROOT contract); the list file itself may live elsewhere
    (``list_dir``, e.g. an explicit --infer-list path's directory).
    ``must_exist=False`` skips the per-file existence asserts (the dataset
    checker counts the missing files itself).
    """
    split_fn = find_split_file(root, split, list_dir)
    images, masks = [], []
    with open(split_fn) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            img = os.path.join(root, parts[0].lstrip("/"))
            if must_exist:
                assert os.path.isfile(img), "{} not found".format(img)
            images.append(img)
            if len(parts) == 2:
                msk = os.path.join(root, parts[1].lstrip("/"))
                if must_exist:
                    assert os.path.isfile(msk), "{} not found".format(msk)
                masks.append(msk)
            else:
                masks.append(None)
    return images, masks


def canonical_size(split):
    """Host-side canonical (H, W) per split family, None for others.

    GTA frames are standardized to 1052x1914 (reference
    dataloader_seg.py:151-153); other datasets keep native size, which the
    loader still enforces for static shapes.
    """
    if "game" in split:
        return (1052, 1914)
    if "synthia" in split:
        return (760, 1280)
    if "cityscapes" in split:
        return (1024, 2048)
    return None
