"""16-bit PNG reads (counterpart of ``dasac_tpu/data/png16.py``).

SYNTHIA's ground-truth masks are 16-bit RGB PNGs whose class id is the
VALUE of channel 0 (the reference reads them with imageio/FreeImage).  PIL
truncates 16-bit channels to the high byte, which maps every id 1..255 to
0, so these files need a real 16-bit decode: the port's codec
(``data/png.py``) gives one, for non-interlaced gray, RGB, gray + alpha and
RGBA at 16 bits.
"""

from dasac_tpu_torch.data import png


def read_png16(path):
    """Decode a 16-bit PNG into uint16 [H, W] or [H, W, C]; ``ValueError``
    (a :class:`png.PngError`) for any other PNG or a malformed file."""
    img = png.read(path)
    if img.bit_depth != 16:
        raise png.PngError("read_png16 expects bit depth 16, got %d (%s)"
                           % (img.bit_depth, path))
    return img.pixels
