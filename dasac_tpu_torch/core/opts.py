"""CLI arguments (a copy of ``dasac_tpu/core/opts.py``): the reference's
flag surface (opts.py:15-109), so launch scripts carry over, with the same
defaults and the same ``logdir`` / ``snapshot_dir`` joins.

The port trains on one GPU in one process: ``--multiprocessing-distributed``
or a ``--world-size`` above 1 raise ``NotImplementedError`` (multi-GPU
training is ROADMAP Queue 1 item 10); ``--dist-url``, ``--dist-backend`` and
``--rank`` are accepted and not read.  ``--profile`` writes a
``torch.profiler`` trace into the logdir.
"""

import argparse
import os


def add_global_arguments(parser):
    parser.add_argument("--snapshot-dir", type=str, default="./snapshots",
                        help="Where to save snapshots of the model.")
    parser.add_argument("--logdir", type=str, default="./logs",
                        help="Where to save log files of the model.")
    parser.add_argument("--exp", type=str, default="main",
                        help="ID of the experiment (multiple runs)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Snapshot (.pth) to resume from, or 'auto' for "
                             "the run's last.pth")
    parser.add_argument("--run", type=str, default="run0", help="ID of the run")
    parser.add_argument("--mask-output-dir", type=str, default=None,
                        help="path where to save masks")
    parser.add_argument("--split", type=str, default=None,
                        help="[train|val|test] split to use")
    parser.add_argument("--workers", type=int, default=None, metavar="N",
                        help="host decode threads")
    parser.add_argument("--dataloader", type=str, default=None,
                        help="Specifies dataloader to use.")
    parser.add_argument("--infer-list", default="data/val_cityscapes.txt",
                        type=str)
    # distributed flags: accepted for launch-script compatibility (the
    # defaults are dasac_tpu's); more than one process raises
    parser.add_argument("--world-size", default=-1, type=int)
    parser.add_argument("--dist-url", default="", type=str)
    parser.add_argument("--dist-backend", default="xla", type=str)
    parser.add_argument("--rank", default=0, type=int)
    parser.add_argument("--multiprocessing-distributed", action="store_true")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--profile", action="store_true",
                        help="capture a torch.profiler trace into the logdir")
    parser.add_argument("--cfg", dest="cfg_file", required=True,
                        help="Config file for training (and optionally testing)")
    parser.add_argument("--set", dest="set_cfgs", default=[], nargs="+",
                        help="Set config keys: KEY VALUE [KEY VALUE ...]")


def get_arguments(args_in):
    parser = argparse.ArgumentParser(description="dasac_tpu_torch")
    add_global_arguments(parser)
    args = parser.parse_args(args_in)
    if args.multiprocessing_distributed or args.world_size > 1:
        raise NotImplementedError(
            "multi-process / multi-GPU training is not ported yet (ROADMAP "
            "Queue 1 item 10); run one process on one GPU")

    if args.dataloader is None:
        args.dataloader = "default"
    args.logdir = os.path.join(args.logdir, args.dataloader, args.exp,
                               args.run or "run0")
    os.makedirs(args.logdir, exist_ok=True)
    args.snapshot_dir = os.path.join(args.snapshot_dir, args.dataloader,
                                     args.exp, args.run or "run0")
    os.makedirs(args.snapshot_dir, exist_ok=True)
    return args
