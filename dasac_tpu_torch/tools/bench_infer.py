"""Inference benchmark on one GPU: throughput and per-frame latency of
the inference program (counterpart of ``dasac_tpu/tools/bench_infer.py``).

Modes:
  * batch   ``--batch`` frames per forward (default 1);
  * single  one frame per forward;
  * spatial one frame's height over several GPUs: not ported (raises;
            ROADMAP Queue 1 item 10).

Synthetic uint8 frames from ``RandomState(0)`` at a fixed shape (default
Cityscapes val 1024x2048) already on the card, random weights from seed 0,
so the number is the device program's alone (no decode, no H2D).  cuDNN
autotunes the convolutions (``core.device.autotune_convolutions``, as the
infer and train CLIs do; the record says so).  Two warm-up calls, then ``--iters`` calls, the whole run
fenced with ``torch.cuda.synchronize()``.  Prints ONE JSON line: img/s, ms
per frame, peak allocated GB, and the card's name and power limit from
``nvidia-smi``.

Not ported: ``mfu`` and ``hbm_util`` (XLA's ``cost_analysis`` has no
counterpart here; a FLOP count belongs to the port's bench, ROADMAP Queue
1 item 6), and ``--dump-hlo`` / ``--compile-only`` (XLA only).

    python -m dasac_tpu_torch.tools.bench_infer --arch fcn_vgg16_bn --batch 4
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from dasac_tpu_torch.core.device import (autotune_convolutions, card_name,
                                         resolve_device)
from dasac_tpu_torch.infer.engine import make_infer_fn
from dasac_tpu_torch.nn.factory import build_model

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
    ap.add_argument("--batch", type=int, default=0,
                    help="frames per forward in batch mode (default 1)")
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
    """Run the benchmark; prints and returns its JSON record.  ``device``
    defaults to CUDA (raises when there is none); the timing fences need a
    card."""
    device = resolve_device(device)
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.mode == "spatial":
        raise NotImplementedError(
            "--mode spatial needs more than one GPU; multi-GPU inference is "
            "not ported yet (ROADMAP Queue 1 item 10)")
    if device.type != "cuda":
        raise ValueError("bench_infer times the card: give it a CUDA device")
    autotune_convolutions(device)
    b = 1 if args.mode == "single" else (args.batch or 1)
    h, w = args.hw
    model = build_model(args.arch, args.num_classes,
                        dtype=_DTYPES[args.dtype], device=device,
                        generator=torch.Generator().manual_seed(0))
    fn = make_infer_fn(model, MEAN, STD, tuple(args.scales), args.flip,
                       args.fuse, output=args.output, device=device)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        (rng.rand(b, h, w, 3) * 255).astype(np.uint8)).to(device)

    for _ in range(2):   # cuDNN autotuning, allocator warm-up
        fn(frames)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = fn(frames)
    torch.cuda.synchronize(device)
    per_step = (time.perf_counter() - t0) / args.iters
    del out
    rec = {
        "metric": "infer_images_per_sec",
        "value": b / per_step,
        "unit": "img/s",
        "latency_ms_per_frame": per_step * 1e3 / b,
        "step_ms": per_step * 1e3,
        "mode": args.mode,
        "devices": 1,
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
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
