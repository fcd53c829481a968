"""Inference and export entry point (counterpart of ``infer_val.py``): the
same flags, one process on one GPU.

    python -m dasac_tpu_torch.infer.cli \\
        --cfg configs/deeplabv2_resnet101_train.yaml --dataloader cityscapes \\
        --resume <snapshot .pth> --infer-list val_cityscapes \\
        --mask-output-dir <out> [--scales .75 1 1.25 --flip --fuse stride8]

The snapshot is read with the port's ``Checkpointer`` (the reference
``.pth`` container; its ``opt`` is not read).  ``--teacher`` runs the
snapshot's EMA teacher, or the initial weights' copy where the snapshot has
none.  ``--spatial`` with N != 0 needs more than one GPU and raises
(ROADMAP Queue 1 item 10).  From Python, ``main(argv, device="cpu")`` runs
on the CPU; with ``device=None`` it runs on the GPU and raises before
anything else when there is none.
"""

import argparse
import os
import sys

import numpy as np
import torch

from dasac_tpu_torch.core.config import (cfg, cfg_from_file, cfg_from_list,
                                         reset_cfg)
from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.core.opts import add_global_arguments
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.data.category import get_class_names, get_num_classes
from dasac_tpu_torch.infer.engine import InferDataset, run_inference
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train.checkpoints import Checkpointer
from dasac_tpu_torch.train.metrics import summarise

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
                        help="height-sharded inference over several GPUs: "
                             "not ported (any value but 0 raises)")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Infer and export as ``infer_val.py`` does; prints the per-class IoU
    and the mIoU where the list has masks, and returns the int64 ``[C, C]``
    confusion (numpy) or None."""
    device = resolve_device(device)
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.spatial:
        raise NotImplementedError(
            "--spatial needs more than one GPU; multi-GPU inference is not "
            "ported yet (ROADMAP Queue 1 item 10)")
    if not args.resume:
        raise ValueError("--resume <snapshot .pth> is required")
    if not args.mask_output_dir:
        raise ValueError("--mask-output-dir is required")
    # the config is process-global: start every run from the defaults
    reset_cfg()
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    autotune_convolutions(device)

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
        batch_size=args.batch or None, fuse=args.fuse, device=device)

    if conf is not None:
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
