"""Build ``native/dasac_io.cpp`` (the C++ PNG decoder and resizer of the
host loader) with ``g++`` into a shared library, and load it with ``ctypes``.

The flags are ``native/Makefile``'s: ``-O3 -fPIC -std=c++17 -Wall
-pthread``, linked ``-shared -lz -pthread``, plus ``-DUSE_LIBDEFLATE
-ldeflate`` where a program links against libdeflate (the Makefile's
probe).  The source is compiled by path and nothing is written under
``native/``: the library goes to ``build/native/`` under the repo, named
after a hash of the source and the flags, and g++'s output is kept beside it
in a ``.log`` file.  The library is written under a temporary name and moved
into place, so processes that build at once never load a half-written file.
Nothing here gives way: a missing ``g++``, a missing ``zlib.h`` or any other
failed build raises ``RuntimeError`` naming the command and the config key
that turns the decoder off.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "dasac_io.cpp"
BUILD_DIR = REPO / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")
LDFLAGS = ("-shared", "-lz", "-pthread")
DEFLATE = (("-DUSE_LIBDEFLATE",), ("-ldeflate",))
OFF = "set TPU.NATIVE_LOADER False to decode in Python instead"

# the three entry points of dasac_io.cpp: (restype, argtypes)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    # (img_path, mask_path, out_h, out_w, out_img, out_mask, mask_fill)
    "dasac_decode_pair": (ctypes.c_int, (
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _U8P,
        _U8P, ctypes.c_int)),
    # (img_paths, mask_paths, n, out_h, out_w, out_imgs, out_masks,
    #  status, n_threads, mask_fill)
    "dasac_decode_batch": (ctypes.c_int, (
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, _U8P, _INTP,
        ctypes.c_int, ctypes.c_int)),
    # (path, w, h)
    "dasac_png_info": (ctypes.c_int, (ctypes.c_char_p, _INTP, _INTP)),
}


def has_libdeflate(cxx):
    """Whether a program links against libdeflate (the Makefile's probe)."""
    r = subprocess.run([cxx, "-x", "c++", "-", "-ldeflate", "-o",
                        os.devnull], input="int main(){}", text=True,
                       capture_output=True)
    return r.returncode == 0


def flags(deflate):
    """(compile flags, link flags) of a build with or without libdeflate."""
    if deflate:
        return CXXFLAGS + DEFLATE[0], LDFLAGS + DEFLATE[1]
    return CXXFLAGS, LDFLAGS


def library_path(deflate):
    """Where the library built from ``SOURCE`` goes."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(sum(flags(deflate), ())).encode())
    return BUILD_DIR / ("%s_%s.so" % (SOURCE.stem, digest.hexdigest()[:16]))


def build_command(cxx, deflate, out):
    cflags, ldflags = flags(deflate)
    return [cxx, *cflags, str(SOURCE), "-o", str(out), *ldflags]


def build():
    """The library of ``SOURCE``, built now unless it already exists."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build %s: no g++ on PATH; %s"
                           % (SOURCE, OFF))
    deflate = has_libdeflate(cxx)
    out = library_path(deflate)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cmd = build_command(cxx, deflate, tmp)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("the build of the native decoder failed (exit "
                           "%d): %s\n%s\n%s" % (r.returncode, " ".join(cmd),
                                                r.stderr, OFF))
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + r.stdout
                                       + r.stderr)
    os.replace(tmp, out)
    return out


def load():
    """Build (if needed) and load the library, with its signatures set."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
