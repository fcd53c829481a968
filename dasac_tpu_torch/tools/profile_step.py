"""Stage breakdown of the SAC train step on the card (counterpart of
``dasac_tpu/tools/profile_step.py``).

Times each stage of the flagship step:
  aug        device-side source + target augmentation
  teacher    teacher forward (no grad) on the clean views
  refine     warp -> pool -> unwarp + running confidence + pseudo-labels
  src_grad   source CE forward + backward
  tgt_grad   target focal-CE forward + backward
  full       the complete step (reference point)

The port's own step (``train/steps.make_sac_step``) runs once to warm up
and then ``--iters`` times under ``spans.recording()``; a stage's time in
a step is the stream ms of its span (``utils/spans.py``; ``full`` is
``step.sac``), and its median prints as one JSON line ``{"stage", "ms",
"card"}``.  The step is ``tools/flagship.py``'s (``bench.py``'s sizes and
modes); random weights from seed 0, uint8 noise from ``RandomState(0)``
already on the card, and a generator seeded 0 for every step.  ``main``
returns ``{stage: ms}``.  With ``device="cpu"`` it runs on the CPU and
times with the host clock.

    python -m dasac_tpu_torch.tools.profile_step [--remat convs] [--iters 5]
"""

import argparse
import json
import statistics

import numpy as np
import torch

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.tools import flagship
from dasac_tpu_torch.train import steps
from dasac_tpu_torch.utils import spans

STAGES = ("aug", "teacher", "refine", "src_grad", "tgt_grad", "full")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    flagship.add_step_args(ap)
    ap.add_argument("--remat", choices=["none", "block", "convs"],
                    default="none")
    ap.add_argument("--refine-dtype", choices=["float32", "bfloat16"],
                    default="bfloat16")
    ap.add_argument("--refine-res", choices=["full", "stride8"],
                    default="stride8")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=None,
                    help="subset of stages to run")
    ap.add_argument("--resize-method", choices=["matmul", "gather"],
                    default="matmul",
                    help="accepted for dasac_tpu's command lines; no effect "
                         "(XLA's resize formulation; the port has one)")
    return ap.parse_args(argv)


def stage_times(args, device):
    """``{stage: [ms in each timed step]}`` of the flagship SAC step."""
    scfg = flagship.step_config(args, args.refine_dtype, args.refine_res)
    state = flagship.build_state(args, device, remat=args.remat)
    batch = flagship.random_batch(args, device, np.random.RandomState(0))
    step = steps.make_sac_step(scfg, device=device)

    def run():
        step(state, batch, torch.Generator(device=device).manual_seed(0))

    run()
    times = {s: [] for s in STAGES}
    with spans.recording():
        for _ in range(args.iters):
            spans.reset()
            run()
            got = spans.totals()
            for s in STAGES:
                times[s].append(got["step.sac" if s == "full" else s]
                                .stream_ms)
    return times


def main(argv=None, device=None):
    """Print and return ``{stage: median ms}``; ``device`` defaults to
    CUDA (raises when there is none)."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    card = flagship.device_label(device)
    times = stage_times(args, device)
    results = {}
    for name in args.stages or STAGES:
        results[name] = statistics.median(times[name])
        print(json.dumps({"stage": name, "ms": results[name], "card": card,
                          "remat": args.remat}), flush=True)
    return results


if __name__ == "__main__":
    main()
