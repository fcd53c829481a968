"""Cityscapes class taxonomy: 19 train classes + ignore (255).

A copy of ``dasac_tpu/data/category.py`` (the reference's
``tools/category.py``; the label metadata is the public Cityscapes
standard), with numpy lookup tables (trainId <-> Cityscapes id, color
palette).
"""

from collections import namedtuple

import numpy as np

Label = namedtuple(
    "Label",
    ["name", "id", "trainId", "category", "categoryId", "hasInstances",
     "ignoreInEval", "color"],
)

# fmt: off
LABELS = (
    Label("road",          7,   0, "flat",         1, False, False, (128,  64, 128)),
    Label("sidewalk",      8,   1, "flat",         1, False, False, (244,  35, 232)),
    Label("building",     11,   2, "construction", 2, False, False, ( 70,  70,  70)),
    Label("wall",         12,   3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",        13,   4, "construction", 2, False, False, (190, 153, 153)),
    Label("pole",         17,   5, "object",       3, False, False, (153, 153, 153)),
    Label("traffic light",19,   6, "object",       3, False, False, (250, 170,  30)),
    Label("traffic sign", 20,   7, "object",       3, False, False, (220, 220,   0)),
    Label("vegetation",   21,   8, "nature",       4, False, False, (107, 142,  35)),
    Label("terrain",      22,   9, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",          23,  10, "sky",          5, False, False, ( 70, 130, 180)),
    Label("person",       24,  11, "human",        6, True,  False, (220,  20,  60)),
    Label("rider",        25,  12, "human",        6, True,  False, (255,   0,   0)),
    Label("car",          26,  13, "vehicle",      7, True,  False, (  0,   0, 142)),
    Label("truck",        27,  14, "vehicle",      7, True,  False, (  0,   0,  70)),
    Label("bus",          28,  15, "vehicle",      7, True,  False, (  0,  60, 100)),
    Label("train",        31,  16, "vehicle",      7, True,  False, (  0,  80, 100)),
    Label("motorcycle",   32,  17, "vehicle",      7, True,  False, (  0,   0, 230)),
    Label("bicycle",      33,  18, "vehicle",      7, True,  False, (119,  11,  32)),
    Label("unlabeled",     0, 255, "void",         0, False, True,  (  0,   0,   0)),
)
# fmt: on

# kept as `labels` too for parity with the reference's public name
labels = LABELS

IGNORE_LABEL = 255


def get_class_names():
    """The 19 trainable class names (excludes 'unlabeled')."""
    return [l.name for l in LABELS if l.name != "unlabeled"]


def get_num_classes():
    return len(get_class_names())


def trainid_to_cs_table():
    """uint8 LUT [256] mapping trainIds -> Cityscapes label ids.

    Vectorized replacement for the reference's per-label loop
    (``infer_val.py:62-67`` convert_to_cs).
    """
    table = np.zeros(256, dtype=np.uint8)
    for l in LABELS:
        if l.trainId != 255:
            table[l.trainId] = l.id
    return table


def cs_to_trainid_table():
    """uint8 LUT [256] mapping Cityscapes label ids -> trainIds (255 = ignore)."""
    table = np.full(256, IGNORE_LABEL, dtype=np.uint8)
    for l in LABELS:
        if l.trainId != 255:
            table[l.id] = l.trainId
    return table


def train_palette():
    """Flat RGB palette [768] for paletted PNG export: index = trainId."""
    return color_table().reshape(-1)


def color_table():
    """uint8 [256,3] LUT mapping trainIds -> RGB color (index 255 = black)."""
    table = np.zeros((256, 3), dtype=np.uint8)
    for l in LABELS:
        if l.trainId != 255:
            table[l.trainId] = l.color
    return table


def colorize(mask):
    """Map a trainId mask [H,W] to an RGB image [H,W,3] (uint8)."""
    return color_table()[np.asarray(mask, dtype=np.uint8)]
