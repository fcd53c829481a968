"""Training entry point (counterpart of ``train.py``): the same flags and
configs.

    python -m dasac_tpu_torch.train.cli --cfg configs/deeplabv2_resnet101.yaml \\
        --exp abn_gta --run v1 --set MODEL.BASELINE True DATASET.ROOT <root>
    python -m dasac_tpu_torch.train.cli \\
        --cfg configs/deeplabv2_resnet101_train.yaml --exp sac_gta --run v1 \\
        --resume <ABN snapshot .pth> --set DATASET.ROOT <root>

``--resume auto`` continues from the run's ``last.pth``.  From Python,
``main(argv, device="cpu")`` runs it on the CPU; with ``device=None`` it
runs on the GPU and raises before anything else when there is none.

Data parallel, one process per device:

  * ``TPU.MESH_DEVICES`` N > 1 (0 = as many visible GPUs as divide both
    batch dimensions) spawns N processes on this host, NCCL on the GPUs,
    gloo on the CPU (``main(argv, device="cpu")`` with
    ``TPU.MESH_DEVICES 2`` runs two CPU ranks); the counterpart of
    ``dasac_tpu``'s one process driving every local device;
  * ``--multiprocessing-distributed`` joins a world the environment
    describes, e.g. ``torchrun --nproc-per-node 8 -m
    dasac_tpu_torch.train.cli --multiprocessing-distributed ...``
    (``core/opts.launch_plan``).

A rank that fails makes the spawning process fail with its traceback; a
rank left waiting at a collective gives up after ``dist.TIMEOUT``.
"""

import os
import random
import sys
import time

import numpy as np
import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.config import (cfg, cfg_from_file, cfg_from_list,
                                         reset_cfg)
from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.core.opts import get_arguments, launch_plan
from dasac_tpu_torch.train import loop
from dasac_tpu_torch.utils.sys_tools import find_free_port


def _load_config(args):
    # the config is process-global: start every run from the defaults
    reset_cfg()
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    if args.workers:
        cfg.TPU.LOADER_THREADS = args.workers


def main(argv=None, device=None):
    """Train as ``train.py`` does; returns the trainer after ``fit``, or
    ``None`` when it spawned one process per device (the trainers live in
    those)."""
    device = resolve_device(device)
    argv = argv if argv is not None else sys.argv[1:]
    args = get_arguments(argv)
    launch = launch_plan(args, os.environ)
    _load_config(args)
    if launch is None:
        available = (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
        n = loop.mesh_size(cfg, available)
        if device.type == "cuda" and n > available:
            raise ValueError("TPU.MESH_DEVICES=%d: only %d GPU(s) visible"
                             % (n, available))
        if n > 1:
            spawn(n, argv, device)
            return None
    return run(args, device, launch)


def spawn(n, argv, device):
    """One process per device on this host, each running ``argv`` as a rank
    of a world of ``n``; returns when all have finished and raises (with
    the failing rank's traceback) when one fails."""
    addr = "127.0.0.1:%d" % find_free_port()
    print("Spawning {} processes ({}, rendezvous {})".format(
        n, device.type, addr))
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_rank_main, args=(n, addr, argv, device.type),
                                nprocs=n, join=True)
    print("Spawned world of {} done in {:.1f} s".format(
        n, time.perf_counter() - t0))


def _rank_main(local_rank, n, addr, argv, device_type):
    args = get_arguments(argv)
    _load_config(args)
    run(args, torch.device(device_type),
        dist.Launch(addr, n, local_rank, local_rank))


def run(args, device, launch=None):
    """Train in this process, joining ``launch``'s world first when given
    (``LOCAL_RANK`` = ``launch.local_rank`` picks the GPU); the world is
    left at the end."""
    if launch is not None:
        if device.type == "cuda":
            torch.cuda.set_device(launch.local_rank)
            device = torch.device("cuda", launch.local_rank)
        t0 = time.perf_counter()
        dist.init(launch, device)
        print("Rank {} of {} joined at {} in {:.1f} s".format(
            launch.rank, launch.world_size, launch.addr,
            time.perf_counter() - t0))
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
            if dist.is_main():
                path = os.path.join(args.logdir, "trace.json")
                prof.export_chrome_trace(path)
                print("Profiler trace -> {}".format(path))
        if launch is not None:
            dist.destroy()
    return trainer


if __name__ == "__main__":
    main()
