"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller names another device.  With
no device given and no CUDA device present they raise instead of quietly
running on the CPU (a CPU run is a test, and the caller says so).
"""

import subprocess

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda``, raising when no CUDA device is present;
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def autotune_convolutions(device):
    """On a CUDA ``device``, let cuDNN time its algorithms for each new
    convolution shape and keep the fastest (``cudnn.benchmark``), as XLA
    does for the JAX package's convolutions; elsewhere a no-op.  The
    setting is process-wide, so the entry points make it."""
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True


def card_name():
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
