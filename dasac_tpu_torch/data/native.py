"""ctypes bindings of the C++ PNG decoder (``native/dasac_io.cpp``), the
counterpart of ``dasac_tpu/data/native.py``.

The library is built by :mod:`dasac_tpu_torch.data.native_build` at its
first use, never at import.  The batch call decodes, unfilters and resizes
a whole batch on a pool of C++ threads; ctypes releases the GIL for every
call.  ``TPU.NATIVE_LOADER`` (:func:`set_enabled`) chooses it: when it is
on and the library cannot be built, the caller gets the build's
``RuntimeError``, not a quiet decode in Python.  A sample the library
refuses (a non-zero status: not an 8-bit non-interlaced PNG, a missing
file, sizes that differ) returns None here, and the loader decodes it in
Python, as ``dasac_tpu`` decodes it with PIL.

``PATH_DECODES`` counts the samples the loader decoded by route:
``"native"`` through this library, ``"python"`` through ``data/png.py``.
"""

import ctypes
import threading

import numpy as np

from dasac_tpu_torch.data import native_build

PATH_DECODES = {"native": 0, "python": 0}

_lock = threading.Lock()
_lib = None
_enabled = True


def set_enabled(flag):
    """Gate the native decoder (cfg ``TPU.NATIVE_LOADER``)."""
    global _enabled
    _enabled = bool(flag)


def enabled():
    return _enabled


def count(route, n=1):
    """Add ``n`` decodes to ``route`` (loader threads call this at once)."""
    with _lock:
        PATH_DECODES[route] += n


def get_lib():
    """The loaded library, built at the first call; raises when it cannot
    be built."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = native_build.load()
    return _lib


def _as_u8_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_pair(img_path, mask_path, out_hw, mask_fill=255):
    """Decode + resize one pair to ``out_hw``: (img [H,W,3], mask [H,W])
    uint8, or None when the library refuses it."""
    lib = get_lib()
    h, w = out_hw
    img = np.empty((h, w, 3), np.uint8)
    mask = np.empty((h, w), np.uint8)
    rc = lib.dasac_decode_pair(
        img_path.encode(), mask_path.encode() if mask_path else None,
        h, w, _as_u8_ptr(img), _as_u8_ptr(mask), mask_fill)
    if rc != 0:
        return None
    count("native")
    return img, mask


def decode_batch(img_paths, mask_paths, out_hw, threads=8, mask_fill=255):
    """Decode + resize a whole batch in one call on ``threads`` C++
    threads: (imgs [N,H,W,3], masks [N,H,W], status [N]); a sample with a
    non-zero status is left to the caller."""
    lib = get_lib()
    n = len(img_paths)
    h, w = out_hw
    imgs = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.uint8)
    status = np.zeros(n, np.int32)
    c_imgs = (ctypes.c_char_p * n)(*[p.encode() for p in img_paths])
    c_masks = (ctypes.c_char_p * n)(
        *[(p.encode() if p else None) for p in mask_paths])
    lib.dasac_decode_batch(
        c_imgs, c_masks, n, h, w, _as_u8_ptr(imgs), _as_u8_ptr(masks),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads,
        mask_fill)
    count("native", int((status == 0).sum()))
    return imgs, masks, status


def png_info(path):
    """(H, W) from the PNG's IHDR, or None when it is not a PNG."""
    lib = get_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dasac_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return h.value, w.value
