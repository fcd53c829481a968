"""Raw-dataset label id -> trainId mappers as uint8 lookup tables (a copy
of ``dasac_tpu/data/id_mappers.py``; the reference's
``tools/id_mappers.py:18-202``).  Label files are read by the port's PNG
codec (``data/png.py``): palette PNGs (GTA) give their raw indices, and
SYNTHIA's 16-bit ground truth its true 16-bit values.
"""

import numpy as np

from dasac_tpu_torch.data import png
from dasac_tpu_torch.data.category import IGNORE_LABEL, LABELS

# SYNTHIA id -> Cityscapes trainId (see the SYNTHIA-AL readme class table;
# parity with reference tools/id_mappers.py:52-70).  Ids absent from the map
# (void 0, parking 13, road-work 14, lanemarking 22) go to ignore.
_SYNTHIA_TO_TRAIN = {
    1: 10,   # sky
    2: 2,    # building
    3: 0,    # road
    4: 1,    # sidewalk
    5: 4,    # fence
    6: 8,    # vegetation
    7: 5,    # pole
    8: 13,   # car
    9: 7,    # traffic sign
    10: 11,  # pedestrian -> person
    11: 18,  # bicycle
    12: 17,  # motorcycle
    15: 6,   # traffic light
    16: 9,   # terrain
    17: 12,  # rider
    18: 14,  # truck
    19: 15,  # bus
    20: 16,  # train
    21: 3,   # wall
}


def _lut_from_map(mapping):
    table = np.full(256, IGNORE_LABEL, dtype=np.uint8)
    for raw_id, train_id in mapping.items():
        table[raw_id] = train_id
    return table


class _LUTMapper:
    """Reads a label image and remaps raw ids -> trainIds via one LUT gather."""

    LUT = None
    EXT = "*.png"

    @classmethod
    def read(cls, filepath):
        """The file's samples as uint8, as ``np.asarray(Image.open(f),
        np.uint8)`` gives them: 16-bit gray wraps modulo 256, 16-bit colour
        keeps its high bytes (gray + alpha opens as RGBA)."""
        img = png.read(filepath)
        arr = img.pixels
        if img.bit_depth == 16 and arr.ndim == 3:
            arr = arr >> 8
            if img.color_type == 4:
                arr = arr[..., [0, 0, 0, 1]]
        return np.asarray(arr, dtype=np.uint8)

    @classmethod
    def remap(cls, raw):
        return cls.LUT[np.asarray(raw, dtype=np.uint8)]

    @classmethod
    def ext(cls):
        return cls.EXT

    # dict-style access for parity with the reference mappers
    def __getitem__(self, key):
        return int(self.LUT[key])


class CityscapesMapper(_LUTMapper):
    """Cityscapes labelIds -> trainIds (the LABELS table itself)."""

    LUT = _lut_from_map({l.id: l.trainId for l in LABELS if l.trainId != 255})
    EXT = "*labelIds.png"


class GameMapper(_LUTMapper):
    """GTA5 uses Cityscapes-compatible ids; identical mapping."""

    LUT = CityscapesMapper.LUT
    EXT = "*.png"


class SynthiaMapper(_LUTMapper):
    LUT = _lut_from_map(_SYNTHIA_TO_TRAIN)
    EXT = "*.png"

    @classmethod
    def read(cls, filepath):
        """Channel 0 clipped to uint8: the class id of SYNTHIA's 16-bit RGB
        ground truth, the value itself of an 8-bit file."""
        arr = png.read(filepath).pixels
        if arr.ndim == 3:
            arr = arr[:, :, 0]
        return np.clip(arr, 0, 255).astype(np.uint8)


def get_mapper(dataname):
    maps = {"cs": CityscapesMapper, "synthia": SynthiaMapper, "gta": GameMapper}
    key = dataname.lower()
    assert key in maps, "Specify data from [cs|synthia|gta]"
    return maps[key]
