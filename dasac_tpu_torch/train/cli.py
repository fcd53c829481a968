"""Training entry point (counterpart of ``train.py``): the same flags and
configs, one process on one GPU.

    python -m dasac_tpu_torch.train.cli --cfg configs/deeplabv2_resnet101.yaml \\
        --exp abn_gta --run v1 --set MODEL.BASELINE True DATASET.ROOT <root>
    python -m dasac_tpu_torch.train.cli \\
        --cfg configs/deeplabv2_resnet101_train.yaml --exp sac_gta --run v1 \\
        --resume <ABN snapshot .pth> --set DATASET.ROOT <root>

``--resume auto`` continues from the run's ``last.pth``.  From Python,
``main(argv, device="cpu")`` runs it on the CPU; with ``device=None`` it
runs on the GPU and raises before anything else when there is none.
"""

import os
import random
import sys

import numpy as np
import torch

from dasac_tpu_torch.core.config import (cfg, cfg_from_file, cfg_from_list,
                                         reset_cfg)
from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.core.opts import get_arguments
from dasac_tpu_torch.train import loop


def main(argv=None, device=None):
    """Train as ``train.py`` does; returns the trainer after ``fit``."""
    device = resolve_device(device)
    argv = argv if argv is not None else sys.argv[1:]
    args = get_arguments(argv)
    # the config is process-global: start every run from the defaults
    reset_cfg()
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    if args.workers:
        cfg.TPU.LOADER_THREADS = args.workers
    autotune_convolutions(device)

    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    trainer = None
    try:
        trainer = loop.Trainer(args, cfg, seed=args.seed or 0, device=device)
        trainer.fit()
    finally:
        if trainer is not None:
            trainer.close()
        if prof is not None:
            prof.stop()
            path = os.path.join(args.logdir, "trace.json")
            prof.export_chrome_trace(path)
            print("Profiler trace -> {}".format(path))
    return trainer


if __name__ == "__main__":
    main()
