"""Inference benchmark: throughput and per-frame latency of the
inference program over a world of GPUs, one process each (counterpart of
``dasac_tpu/tools/bench_infer.py``).

Modes (the layouts of ``infer/engine.run_inference``, ``core/mesh.py``):
  * batch   ``--batch`` frames a step split over the ranks (default one a
            rank);
  * spatial one frame's height over all ranks, or over ``--sp`` N ranks a
            frame with world/N frames side by side (``nn/spatial.py``'s
            halo exchanges);
  * single  one frame on one rank.

The world is the one this process is in (from Python), else one process
per visible GPU of this host (``dasac_tpu``'s bench uses its local
devices).  Synthetic uint8 frames from ``RandomState(0)`` at a
fixed shape (default Cityscapes val 1024x2048) already on the card, random
weights from seed 0, so the number is the device program's alone (no
decode, no H2D).  cuDNN autotunes the convolutions
(``core.device.autotune_convolutions``, as the infer and train CLIs do;
the record says so).  Two warm-up calls, then ``--iters`` calls, each
rank's run fenced with ``torch.cuda.synchronize()``; a step takes as long
as its slowest rank.  Rank 0 prints ONE JSON line: img/s, ms per frame,
every rank's step ms, the layout (``devices``, ``mesh``), the exchanges and
bytes a forward by layer kind with their transport, peak allocated GB, and
the card's name and power limit from ``nvidia-smi``; and the cost of the
global call, counted once on rank 0 outside the timed window as the
unsharded forward of the whole batch (``tools/bench.py``'s
``count_cost``): ``step_flops_tf`` and ``hbm_gb_per_step``, and over the
step time and the card's peaks times the ranks that ran it, ``mfu`` and
``hbm_util`` (left out for a card or CPU not in ``tools/bench.py``'s
table).

Not ported: ``--dump-hlo`` / ``--compile-only`` (XLA only).

    python -m dasac_tpu_torch.tools.bench_infer --arch fcn_vgg16_bn --batch 4
    python -m dasac_tpu_torch.tools.bench_infer --mode spatial --sp 2
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.device import (autotune_convolutions, card_name,
                                         resolve_device)
from dasac_tpu_torch.core.mesh import infer_mesh, sp_group
from dasac_tpu_torch.infer.engine import make_infer_fn
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.nn.spatial import Sharded
from dasac_tpu_torch.tools.bench import (bf16_peak_flops, count_cost,
                                        hbm_peak_bw)
from dasac_tpu_torch.utils.sys_tools import find_free_port

# the config defaults (DATASET.MEAN / STD)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deeplabv2_resnet101")
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048),
                    help="frame size (default: Cityscapes val)")
    ap.add_argument("--mode", choices=["batch", "spatial", "single"],
                    default="batch")
    ap.add_argument("--sp", type=int, default=0,
                    help="spatial mode: ranks a frame (0 = all; N below "
                         "the world = (world/N, N) mesh, world/N frames "
                         "side by side)")
    ap.add_argument("--batch", type=int, default=0,
                    help="frames a step (0 = one a rank; the data axis in "
                         "spatial mode; 1 in single mode)")
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0])
    ap.add_argument("--flip", action="store_true")
    ap.add_argument("--fuse", choices=["full", "stride8"], default="full",
                    help="scale-fusion point (engine.make_infer_fn)")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--output", choices=["probs", "argmax"],
                    default="probs",
                    help="program result: probability volume or on-device "
                         "uint8 argmax (engine.make_infer_fn)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--num-classes", type=int, default=19)
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the benchmark; returns its JSON record (rank 0 prints it; the
    other ranks return theirs unprinted).  ``device`` defaults to CUDA
    (raises when there is none); the timing fences need a card.

    The ranks are those of the world this process is in, else one process
    per visible GPU (spawned when there are several; the record is rank
    0's)."""
    device = resolve_device(device)
    argv = argv if argv is not None else sys.argv[1:]
    args = parse_args(argv)
    if device.type != "cuda":
        raise ValueError("bench_infer times the card: give it a CUDA device")
    if dist.initialized():
        return bench(args, device, dist.group())
    n = torch.cuda.device_count()
    layout(args, n)   # the layout must exist before any process starts
    if n > 1:
        addr = "127.0.0.1:%d" % find_free_port()
        result = torch.multiprocessing.get_context("spawn").SimpleQueue()
        torch.multiprocessing.spawn(_rank_main, args=(n, addr, argv, result),
                                    nprocs=n, join=True)
        return result.get()
    return bench(args, device, None)


def _rank_main(local_rank, n, addr, argv, result):
    device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
    dist.init(dist.Launch(addr, n, local_rank, local_rank), device)
    try:
        rec = bench(parse_args(argv), device, dist.group())
    finally:
        dist.destroy()
    if local_rank == 0:
        result.put(rec)


def layout(args, world):
    """The mode's :class:`~dasac_tpu_torch.core.mesh.Layout` over
    ``world`` ranks, as ``dasac_tpu``'s bench lays out its devices."""
    lay = infer_mesh(
        world, batch_size=1 if args.mode == "single" else args.batch or None,
        spatial=(args.sp or -1) if args.mode == "spatial" else 0)
    if lay.n_sp and args.hw[0] % lay.n_sp:
        raise ValueError("spatial mode: height %d must tile the %d ranks a "
                         "frame" % (args.hw[0], lay.n_sp))
    return lay


def global_cost(args, model, device, b):
    """``count_cost`` of the global call: the unsharded forward of the
    whole batch, ``b`` frames from ``RandomState(0)`` (what XLA costs for
    the program over the mesh)."""
    fn = make_infer_fn(model, MEAN, STD, tuple(args.scales), args.flip,
                       args.fuse, output=args.output, device=device)
    frames = torch.from_numpy((np.random.RandomState(0).rand(
        b, *args.hw, 3) * 255).astype(np.uint8)).to(device)
    return count_cost(lambda: fn(frames))


def bench(args, device, group):
    """The benchmark on this rank of ``group`` (``None``: alone)."""
    world, rank = (1, 0) if group is None else (group.size(), group.rank())
    lay = layout(args, world)
    sp = None if group is None else sp_group(lay, rank)
    coords = lay.coords(rank)
    autotune_convolutions(device)
    b = lay.b
    h, w = args.hw
    per_step = float("nan")
    calls = {}
    if coords is not None:
        d, _ = coords
        model = build_model(args.arch, args.num_classes,
                            dtype=_DTYPES[args.dtype], device=device,
                            generator=torch.Generator().manual_seed(0))
        fn = make_infer_fn(model, MEAN, STD, tuple(args.scales), args.flip,
                           args.fuse, output=args.output, device=device,
                           sharded=None if sp is None else Sharded(sp))
        rng = np.random.RandomState(0)
        bl = b // lay.n_data
        frames = torch.from_numpy((rng.rand(b, h, w, 3) * 255).astype(
            np.uint8)[d * bl:(d + 1) * bl]).to(device)

        for _ in range(2):   # cuDNN autotuning, allocator warm-up
            fn(frames)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        calls0 = dict(dist.CALLS)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(frames)
        torch.cuda.synchronize(device)
        per_step = (time.perf_counter() - t0) / args.iters
        calls = {k: (dist.CALLS[k] - v) / args.iters
                 for k, v in calls0.items() if k.startswith("exchange")}
        del out
    # every rank's step time; a step is as slow as the slowest rank
    steps = [per_step]
    if group is not None:
        t = torch.zeros(world, dtype=torch.float64, device=device)
        t[rank] = per_step if coords is not None else 0.0
        dist.all_reduce_sum_([t], group)
        steps = [v for r, v in enumerate(t.tolist())
                 if lay.coords(r) is not None]
    per_step = max(steps)
    rec = {
        "metric": "infer_images_per_sec",
        "value": b / per_step,
        "unit": "img/s",
        "latency_ms_per_frame": per_step * 1e3 / b,
        "step_ms": per_step * 1e3,
        "rank_step_ms": [v * 1e3 for v in steps],
        "mode": args.mode,
        "devices": lay.ranks,
        "mesh": [lay.n_data, lay.n_sp] if lay.n_sp else [lay.n_data],
        "world": world,
        "transport": None if sp is None else dist.transport(sp),
        "exchanges_per_forward": {k: v for k, v in calls.items()
                                  if not k.startswith("exchange_bytes")},
        "exchange_bytes_per_forward": {
            k: v for k, v in calls.items()
            if k.startswith("exchange_bytes")},
        "batch": b,
        "hw": [h, w],
        "scales": args.scales,
        "flip": bool(args.flip),
        "fuse": args.fuse,
        "arch": args.arch,
        "dtype": args.dtype,
        "output": args.output,
        "iters": args.iters,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "device": torch.cuda.get_device_name(device),
        "card": card_name(),
    }
    if rank == 0:
        flops, nbytes, _ = global_cost(args, model, device, b)
        peak, bw = bf16_peak_flops(rec["card"]), hbm_peak_bw(rec["card"])
        rec["step_flops_tf"] = flops / 1e12
        rec["hbm_gb_per_step"] = nbytes / 1e9
        if peak:
            rec["mfu"] = flops / per_step / (peak * lay.ranks)
        if bw:
            rec["hbm_util"] = nbytes / per_step / (bw * lay.ranks)
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
