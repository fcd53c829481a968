"""CLI arguments (a copy of ``dasac_tpu/core/opts.py``): the reference's
flag surface (opts.py:15-109), so launch scripts carry over, with the same
defaults and the same ``logdir`` / ``snapshot_dir`` joins.

Data-parallel launches (:func:`launch_plan`): ``--multiprocessing-distributed``
joins a world that the environment describes (torchrun, multi-node
launches, the reference's recipes; the counterpart of ``train.py``'s pod
flag), and ``--world-size`` N > 1 joins a world of N processes as rank
``--rank`` at ``--dist-url`` (the reference's meaning).  Without either,
``train.cli`` spawns one process per device when ``TPU.MESH_DEVICES`` asks
for more than one.  ``--dist-backend`` is accepted and not read: the port
takes NCCL on the GPU and gloo on the CPU.  ``--profile`` writes a
``torch.profiler`` trace into the logdir.
"""

import argparse
import os

from dasac_tpu_torch.core import dist


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
    # distributed flags (the defaults are dasac_tpu's): see launch_plan
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

    if args.dataloader is None:
        args.dataloader = "default"
    args.logdir = os.path.join(args.logdir, args.dataloader, args.exp,
                               args.run or "run0")
    os.makedirs(args.logdir, exist_ok=True)
    args.snapshot_dir = os.path.join(args.snapshot_dir, args.dataloader,
                                     args.exp, args.run or "run0")
    os.makedirs(args.snapshot_dir, exist_ok=True)
    return args


def launch_plan(args, env):
    """The world this process joins (a ``dist.Launch``), or ``None``:

      * ``--multiprocessing-distributed``: the one ``env`` describes
        (``dist.launch_from_env``; ``LOCAL_RANK`` picks the device);
      * ``--world-size`` N > 1: N processes, this one ``--rank``, meeting
        at ``--dist-url`` (``tcp://host:port``; empty or ``env://`` reads
        ``MASTER_ADDR``/``MASTER_PORT``).
    """
    if args.multiprocessing_distributed:
        return dist.launch_from_env(env)
    if args.world_size <= 1:
        return None
    url = args.dist_url
    if url in ("", "env://"):
        addr = "{}:{}".format(env.get("MASTER_ADDR", "localhost"),
                              env.get("MASTER_PORT", dist.DEFAULT_PORT))
    elif url.startswith("tcp://"):
        addr = url[len("tcp://"):]
    else:
        raise ValueError("--dist-url must be tcp://host:port or env://, "
                         "got %r" % url)
    return dist.Launch(addr, args.world_size, args.rank,
                       int(env.get("LOCAL_RANK", 0)))
