"""Build a CUDA source of the port with ``nvcc`` into a shared library with a
plain ``extern "C"`` interface, and load it with ``ctypes``.

No PyTorch header is compiled, so a build takes seconds.  The library goes
to ``build/kernels/`` under the repo, named after a hash of the source and
the flags, so an edited source never loads a stale library; nvcc's output
(``-Xptxas -v``: registers, shared memory and spills of each kernel) is kept
beside it in a ``.log`` file.  Nothing here gives way: a missing ``nvcc``, a
failed build or a card other than Hopper (compute capability 9.0) raises
``RuntimeError``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
HOPPER = (9, 0)


def find_nvcc():
    """``nvcc`` under ``CUDA_HOME``, then under PyTorch's ``CUDA_HOME``,
    then on ``PATH``; None when there is none."""
    from torch.utils import cpp_extension

    for home in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def library_path(src):
    """Where the library built from ``src`` goes."""
    digest = hashlib.sha256(Path(src).read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / ("%s_%s.so" % (Path(src).stem,
                                      digest.hexdigest()[:16]))


def build_command(nvcc, src, out):
    return [nvcc, *FLAGS, "-o", str(out), str(src)]


def build(src):
    """The library of ``src``, built now unless it already exists."""
    out = library_path(src)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build %s: no nvcc under CUDA_HOME, PyTorch's CUDA_HOME "
            "or on PATH" % src)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    r = subprocess.run(build_command(nvcc, src, tmp), capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s (exit %d):\n%s"
                           % (src, r.returncode, r.stderr))
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def build_log(src):
    """nvcc's output from the build of ``src``'s library ('' if not built)."""
    log = library_path(src).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(src, signatures):
    """Build and load ``src``; ``signatures`` maps each entry point to
    ``(restype, argtypes)``, which are set on the loaded functions."""
    lib = ctypes.CDLL(str(build(src)))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


def require_hopper(device):
    """Raise unless ``device`` is a compute capability 9.0 card, the one
    target (``sm_90a``) the libraries are built for."""
    cap = tuple(torch.cuda.get_device_capability(device))
    if cap != HOPPER:
        raise RuntimeError(
            "the port's CUDA kernels are built for sm_90a (Hopper, compute "
            "capability 9.0); %s has %d.%d" % (device, *cap))
