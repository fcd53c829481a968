"""The flagship SAC step that the step tools (``profile_step``,
``compare_refine_res``, ``op_traffic``) build and time: the counterpart of
the root ``bench.py``'s ``_build`` and ``_device_batch``, which
``dasac_tpu``'s tools use, with ``chip_smoke.py``'s flagship constants.

DeepLabv2/ResNet-101 in bf16 with random weights from a seed; 8 source
frames and 2 groups x 4 target views at 512x1024; SGD over the four LR
groups with ``bench.py``'s MODEL section; the step config of ``bench.py``
(bf16 refine at stride 8; the step tools take the CUDA CE kernels, the
bench ``bench.py``'s ``--ce-impl``).  Every size is a flag
(:func:`add_step_args`), so the tools also run tiny on the CPU.
"""

import statistics
import time

import numpy as np
import torch

from dasac_tpu_torch.core.device import card_name
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim, steps

C = 19
HW = (512, 1024)
BATCH_SIZE = 8   # TRAIN.BATCH_SIZE (source frames a step)
NUM_GROUPS = 2   # TRAIN.NUM_GROUPS
GROUP_SIZE = 4   # TRAIN.GROUP_SIZE


class ModelCfg:
    """The MODEL section ``bench.py`` uses."""
    LR = 2.5e-4
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9
    BETA1 = 0.5


def add_step_args(ap):
    """The flags of the flagship step's arch and sizes."""
    ap.add_argument("--arch", default="deeplabv2_resnet101")
    ap.add_argument("--hw", type=int, nargs=2, default=list(HW))
    ap.add_argument("--batch", type=int, default=BATCH_SIZE)
    ap.add_argument("--groups", type=int, default=NUM_GROUPS)
    ap.add_argument("--group-size", type=int, default=GROUP_SIZE)


def step_config(args, refine_dtype="bfloat16", refine_res="stride8",
                ce_impl="kernel", loss_dtype="float32"):
    """``bench.py``'s step config at ``args``' sizes, with the refine
    chain's dtype and resolution (``TPU.REFINE_DTYPE``, ``REFINE_RES``),
    the CE route (``kernel``: the CUDA pair; ``logsoftmax``: the plain
    formula) and the CE's precision (``TPU.LOSS_DTYPE``)."""
    return steps.StepConfig(
        num_classes=C, crop_hw=tuple(args.hw), group_size=args.group_size,
        lr_target=5.0, net_momentum_iter=100, zoom=(0.5, 1.0),
        guided_hflip=True, tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2,
        src_scale=(0.5, 1.0), refine_dtype=refine_dtype,
        refine_res=refine_res, ce_impl=ce_impl, loss_dtype=loss_dtype)


def build_state(args, device, remat="none"):
    """``args.arch`` in bf16 under ``remat``, random weights from seed 0,
    its SGD and train state on ``device``."""
    model = build_model(args.arch, C, dtype=torch.bfloat16, remat=remat,
                        device=device,
                        generator=torch.Generator().manual_seed(0))
    opt = optim.build_optimizer(ModelCfg, args.arch, model)
    return create_train_state(model, opt, C, device=device)


def random_batch(args, device, rng):
    """uint8 noise frames and labels from ``rng`` (a numpy
    ``RandomState``): ``args.batch`` source frames and ``args.groups``
    target frames at ``args.hw``."""
    b, g, hw = args.batch, args.groups, tuple(args.hw)
    return tuple(torch.from_numpy(a).to(device) for a in (
        (rng.rand(b, *hw, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (b, *hw)).astype(np.uint8),
        (rng.rand(g, *hw, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (g, *hw)).astype(np.uint8)))


def device_label(device):
    """The card's name and power limit (``nvidia-smi``) on CUDA, else the
    device's type: every record says where it was measured."""
    return card_name() if device.type == "cuda" else device.type


def median_ms(fn, device, iters):
    """Median ms of ``iters`` calls of ``fn`` after one warm-up call: each
    call between two CUDA events on the card (then synchronized), on the
    host clock elsewhere."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
