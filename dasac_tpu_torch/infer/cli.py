"""Inference and export entry point (counterpart of ``infer_val.py``): the
same flags, one process per GPU.

    python -m dasac_tpu_torch.infer.cli \\
        --cfg configs/deeplabv2_resnet101_train.yaml --dataloader cityscapes \\
        --resume <snapshot .pth> --infer-list val_cityscapes \\
        --mask-output-dir <out> [--scales .75 1 1.25 --flip --fuse stride8]

The snapshot is read with the port's ``Checkpointer`` (the reference
``.pth`` container; its ``opt`` is not read).  ``--teacher`` runs the
snapshot's EMA teacher, or the initial weights' copy where the snapshot has
none.  From Python, ``main(argv, device="cpu")`` runs on the CPU; with
``device=None`` it runs on the GPU and raises before anything else when
there is none.

Several GPUs, one process each (``infer_val.py`` uses every local device):

  * on a host with more than one visible GPU, ``main`` spawns one process
    per GPU (NCCL); with one GPU, or on the CPU, it runs in this process;
  * ``--multiprocessing-distributed`` joins a world the environment
    describes (``torchrun --nproc-per-node N -m dasac_tpu_torch.infer.cli
    --multiprocessing-distributed ...``), ``--world-size N --rank R
    --dist-url tcp://host:port`` one given by flags
    (``core/opts.launch_plan``); on the CPU a world exists only so;
  * ``--batch`` frames split over the ranks (default one a rank),
    ``--spatial`` shards each frame's height over all ranks, ``--spatial
    N`` over N ranks a frame with world/N frames side by side
    (``engine.run_inference``); a layout the world cannot make raises
    ``ValueError``.  Rank 0 prints the IoUs; each frame's first ``sp``
    rank writes its exports.
"""

import argparse
import os
import sys

import numpy as np
import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.config import (cfg, cfg_from_file, cfg_from_list,
                                         reset_cfg)
from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.core.mesh import infer_mesh
from dasac_tpu_torch.core.opts import add_global_arguments, launch_plan
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.data.category import get_class_names, get_num_classes
from dasac_tpu_torch.infer.engine import InferDataset, run_inference
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train.checkpoints import Checkpointer
from dasac_tpu_torch.train.metrics import summarise
from dasac_tpu_torch.utils.sys_tools import find_free_port

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv):
    parser = argparse.ArgumentParser(description="dasac_tpu_torch inference")
    add_global_arguments(parser)
    parser.add_argument("--scales", type=float, nargs="+", default=[1.0],
                        help="multi-scale factors (default: single scale)")
    parser.add_argument("--flip", action="store_true",
                        help="average with the horizontally flipped forward")
    parser.add_argument("--fuse", choices=["full", "stride8"],
                        default="full",
                        help="'full': the reference protocol (softmax and "
                             "average at full resolution per scale); "
                             "'stride8': average on the stride-8 grid and "
                             "upsample the fused probabilities once")
    parser.add_argument("--save-raw", action="store_true")
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--teacher", action="store_true",
                        help="use the EMA teacher weights")
    parser.add_argument("--batch", type=int, default=0,
                        help="images per forward (default 1)")
    parser.add_argument("--spatial", type=int, nargs="?", const=-1,
                        default=0,
                        help="shard each image's HEIGHT over the GPUs: "
                             "bare flag = all GPUs on one frame; N = "
                             "N GPUs a frame, GPUs/N frames in parallel "
                             "(0 = split batches over the GPUs)")
    return parser.parse_args(argv)


def _load_config(args):
    # the config is process-global: start every run from the defaults
    reset_cfg()
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)


def main(argv=None, device=None):
    """Infer and export as ``infer_val.py`` does; prints the per-class IoU
    and the mIoU where the list has masks, and returns the int64 ``[C, C]``
    confusion (numpy) or None.  On a host with several GPUs it spawns one
    process per GPU and returns rank 0's confusion."""
    device = resolve_device(device)
    argv = argv if argv is not None else sys.argv[1:]
    args = parse_args(argv)
    if not args.resume:
        raise ValueError("--resume <snapshot .pth> is required")
    if not args.mask_output_dir:
        raise ValueError("--mask-output-dir is required")
    launch = launch_plan(args, os.environ)
    _load_config(args)
    if launch is not None:
        world = launch.world_size
    else:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    # the layout must exist before anything starts
    infer_mesh(world, args.batch or None, args.spatial)
    if launch is None and world > 1:
        return spawn(world, argv)
    return run(args, device, launch)


def spawn(n, argv):
    """One process per GPU of this host, each running ``argv`` as a rank of
    a world of ``n``; returns rank 0's confusion when all have finished,
    and raises (with the failing rank's traceback) when one fails."""
    addr = "127.0.0.1:%d" % find_free_port()
    print("Spawning {} processes (rendezvous {})".format(n, addr))
    result = torch.multiprocessing.get_context("spawn").SimpleQueue()
    torch.multiprocessing.spawn(_rank_main, args=(n, addr, argv, result),
                                nprocs=n, join=True)
    # rank 0 put its (small) confusion before it ended
    return result.get()


def _rank_main(local_rank, n, addr, argv, result):
    conf = run(parse_args(argv), torch.device("cuda"),
               dist.Launch(addr, n, local_rank, local_rank))
    if local_rank == 0:
        result.put(conf)


def run(args, device, launch=None):
    """Infer in this process, joining ``launch``'s world first when given
    (``LOCAL_RANK`` = ``launch.local_rank`` picks the GPU); the world is
    left at the end.  Rank 0 prints the IoUs."""
    if launch is not None:
        if device.type == "cuda":
            torch.cuda.set_device(launch.local_rank)
            device = torch.device("cuda", launch.local_rank)
        dist.init(launch, device)
    try:
        _load_config(args)
        autotune_convolutions(device)
        conf = _infer(args, device)
    finally:
        if launch is not None:
            dist.destroy()
    return conf


def _infer(args, device):
    num_classes = get_num_classes()
    model = build_model(cfg.MODEL.ARCH, num_classes,
                        dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE], device=device,
                        generator=torch.Generator().manual_seed(
                            args.seed or 0))
    state = create_train_state(model, None, num_classes, device=device)
    Checkpointer(None).load(args.resume, state)
    if args.teacher:
        model.load_state_dict({**state.teacher_params,
                               **state.teacher_stats}, strict=False)

    # --infer-list: a split name or a path like data/val_cityscapes.txt; the
    # image paths inside resolve against DATASET.ROOT
    # (reference dataloader_infer.py:41-64)
    split = os.path.splitext(os.path.basename(args.infer_list))[0]
    list_dir = (os.path.dirname(args.infer_list)
                if os.path.isfile(args.infer_list) else None)
    dataset = InferDataset(cfg.DATASET.ROOT, split, list_dir=list_dir,
                           cityscapes_names=(args.dataloader == "cityscapes"))
    conf = run_inference(
        model, dataset, args.mask_output_dir, mean=tuple(cfg.DATASET.MEAN),
        std=tuple(cfg.DATASET.STD), num_classes=num_classes,
        scales=tuple(args.scales), flip=args.flip, save_raw=args.save_raw,
        vis=args.vis, workers=args.workers or 4,
        batch_size=args.batch or None, spatial=args.spatial, fuse=args.fuse,
        device=device, group=dist.group())

    if conf is not None and dist.is_main():
        iou, _, _ = summarise(conf)
        keep = [i for i in range(num_classes)
                if i not in set(cfg.VAL.IGNORE_CLASS)]
        for name, v in zip(get_class_names(), iou):
            print("IoU_{}: {:4.3f}".format(name, v))
        print("mIoU ({} classes): {:4.3f}".format(
            len(keep), float(np.mean(iou[keep]))))
    return conf


if __name__ == "__main__":
    main()
