"""PNG codec in numpy + zlib: the port's image I/O without PIL.

Non-interlaced 8-bit PNGs, and 16-bit gray for reading.

* :func:`read` decodes colour types 0 (gray, 8- or 16-bit; 16-bit samples
  come back as uint16), 2 (RGB), 3 (palette: the pixels are the palette
  *indices*, the palette is returned beside them) and 6 (RGBA), with all
  five row filters.  None, Sub and Up rows are unfiltered
  with whole-row numpy operations; Average and Paeth rows depend on the
  pixel to their left after unfiltering and go byte by byte in Python,
  which is slow (real datasets are read from packs, ``data/packed.py``).
* :func:`to_rgb` and :func:`to_mask` turn a decoded image into what
  ``dasac_tpu``'s loader takes from PIL: ``convert("RGB")`` for images
  (gray replicated, palette looked up, alpha dropped), and for masks the
  raw palette indices of a colour-type-3 file or else ``convert("L")``
  (ITU-R 601-2 luma in PIL's fixed-point arithmetic).  Both take 8-bit
  images only.
* :func:`write` encodes gray ``[H, W]`` or RGB ``[H, W, 3]`` uint8 arrays,
  or ``[H, W]`` palette indices with their ``[n, 3]`` palette (colour type
  3, a ``PLTE`` chunk), every row with one chosen filter (0, None, by
  default).
* :func:`png_size` reads ``(H, W)`` from the IHDR chunk alone.

Anything else (16-bit colour, sub-byte samples, interlacing, gray+alpha, a
file that is not a PNG) raises :class:`PngError` naming the file.
"""

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


class PngError(ValueError):
    pass


class PngImage(NamedTuple):
    pixels: np.ndarray            # uint8 [H, W] (gray, indices) or [H, W, C];
    #                               uint16 [H, W] for 16-bit gray
    color_type: int
    palette: Optional[np.ndarray]  # uint8 [n, 3] for colour type 3
    bit_depth: int = 8


def _header(ihdr, path):
    if len(ihdr) != 13:
        raise PngError("%s: bad IHDR chunk" % path)
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if ctype not in _CHANNELS or depth not in ((8, 16) if ctype == 0
                                               else (8,)):
        raise PngError("%s: bit depth %d, colour type %d: only 8-bit gray, "
                       "RGB, palette and RGBA and 16-bit gray are supported"
                       % (path, depth, ctype))
    if interlace:
        raise PngError("%s: interlaced PNGs are not supported" % path)
    if comp or filt:
        raise PngError("%s: unknown compression/filter method" % path)
    return h, w, ctype, depth


def png_size(path):
    """(H, W) of the PNG at ``path``, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise PngError("%s: not a PNG file" % path)
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read(path):
    """Decode the PNG at ``path`` into a :class:`PngImage`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise PngError("%s: not a PNG file" % path)
    pos, header, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(data):
            raise PngError("%s: truncated file (no IEND chunk)" % path)
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError("%s: truncated %r chunk" % (path, ctype))
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PngError("%s: CRC mismatch in the %r chunk" % (path, ctype))
        pos += 12 + length
        if header is None and ctype != b"IHDR":
            raise PngError("%s: the first chunk is not IHDR" % path)
        if ctype == b"IHDR":
            header = _header(body, path)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    h, w, color_type, depth = header
    if color_type == 3 and palette is None:
        raise PngError("%s: palette image without a PLTE chunk" % path)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError("%s: %s" % (path, e)) from None
    channels = _CHANNELS[color_type]
    # filters work on bytes: a 16-bit gray pixel is 2 of them
    pixels = _unfilter(raw, h, w, channels * depth // 8, path)
    if depth == 16:   # big-endian samples
        return PngImage(pixels.view(">u2").astype(np.uint16).reshape(h, w),
                        color_type, palette, depth)
    pixels = (pixels.reshape(h, w, channels) if channels > 1
              else pixels.reshape(h, w))
    return PngImage(pixels, color_type, palette)


def _unfilter(raw, h, w, bpp, path):
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise PngError("%s: %d bytes of image data, want %d"
                       % (path, len(raw), h * (stride + 1)))
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise PngError("%s: unknown row filter %d" % (path, kinds.max()))
    if not kinds.any():
        return data.copy()
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = kinds[y], data[y]
        if kind == 0:
            out[y] = cur
        elif kind == 1:   # Sub: a running sum along the row, per channel
            out[y] = np.cumsum(cur.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            out[y] = cur + prev
        elif kind == 3:
            out[y] = np.frombuffer(_average_row(cur, prev, bpp), np.uint8)
        else:
            out[y] = np.frombuffer(_paeth_row(cur, prev, bpp), np.uint8)
        prev = out[y]
    return out


def _average_row(cur, prev, bpp):
    out = bytearray(cur.tobytes())
    up = prev.tobytes()
    for i in range(bpp):
        out[i] = (out[i] + (up[i] >> 1)) & 0xFF
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + up[i]) >> 1)) & 0xFF
    return out


def _paeth_row(cur, prev, bpp):
    out = bytearray(cur.tobytes())
    up = prev.tobytes()
    for i in range(bpp):   # a = c = 0: the predictor is b
        out[i] = (out[i] + up[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _eight_bit(img):
    if img.bit_depth != 8:
        raise PngError("a %d-bit image where an 8-bit one is needed"
                       % img.bit_depth)
    return img.pixels


def to_rgb(img):
    """uint8 [H, W, 3], as PIL's ``convert("RGB")`` gives it."""
    px = _eight_bit(img)
    if img.color_type == 2:
        return px
    if img.color_type == 6:
        return np.ascontiguousarray(px[..., :3])
    if img.color_type == 0:
        return np.repeat(px[..., None], 3, axis=-1)
    if px.max(initial=0) >= len(img.palette):
        raise PngError("palette index %d beyond a palette of %d entries"
                       % (px.max(), len(img.palette)))
    return img.palette[px]


def to_mask(img):
    """uint8 [H, W]: palette indices for colour type 3 (trainIds stored as
    indices), otherwise PIL's ``convert("L")``."""
    px = _eight_bit(img)
    if img.color_type in (0, 3):
        return px
    rgb = px[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode(array, filter_type=0, palette=None):
    """PNG bytes of a uint8 gray ``[H, W]`` or RGB ``[H, W, 3]`` array, every
    row filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), compressed at zlib's level 1 (PIL saves at 6; on the
    synthetic frames level 1 writes ~1.7x faster and compresses as well).
    With a uint8 ``palette`` ``[n, 3]`` (n <= 256) the ``[H, W]`` array
    holds palette indices: colour type 3, which PIL opens in mode "P"."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise PngError("encode takes uint8 [H, W] or [H, W, 3], got %s %s"
                       % (arr.dtype, arr.shape))
    plte = b""
    if palette is not None:
        pal = np.asarray(palette)
        if (pal.dtype != np.uint8 or pal.ndim != 2 or pal.shape[1] != 3
                or not 1 <= len(pal) <= 256 or arr.ndim != 2):
            raise PngError("a palette image takes uint8 [H, W] indices and "
                           "a uint8 [n, 3] palette (n <= 256), got %s %s "
                           "and %s %s" % (arr.dtype, arr.shape, pal.dtype,
                                          pal.shape))
        if arr.size and arr.max() >= len(pal):
            raise PngError("palette index %d beyond a palette of %d entries"
                           % (arr.max(), len(pal)))
        plte = _chunk(b"PLTE", pal.tobytes())
    if filter_type not in range(5):
        raise PngError("unknown filter type %r" % (filter_type,))
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else 3
    x = arr.reshape(h, w * bpp)
    if filter_type == 0:
        rows = x
    else:
        x = x.astype(np.int16)
        a = np.zeros_like(x)
        a[:, bpp:] = x[:, :-bpp]
        b = np.zeros_like(x)
        b[1:] = x[:-1]
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        pred = {1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[filter_type]
        rows = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.empty((h, w * bpp + 1), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = rows
    ctype = 3 if plte else (0 if bpp == 1 else 2)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return b"".join((SIGNATURE, _chunk(b"IHDR", ihdr), plte,
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)),
                     _chunk(b"IEND", b"")))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write(path, array, filter_type=0, palette=None):
    """Write ``array`` to ``path`` as a PNG (see :func:`encode`)."""
    data = encode(array, filter_type, palette)
    with open(path, "wb") as f:
        f.write(data)
