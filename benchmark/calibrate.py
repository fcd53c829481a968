"""The readings that the correctness limits are set from, on the card at
the cell's own sizes: for each seed, the numbers the run compares, read
for the program (the lower reading), for the control (the reference in
bf16 with fp8-rounded convolution operands: the precision below the
configuration's) and, for a training cell, for the planted faults of
half of each batch left out (the reference on the first half, the mean
taken over it) and of one leaf altered after each step.  A state left
unchanged reads 1 on the gaps of norms of a change and needs no run.
On ``--witness-seeds`` a training cell also reads the reference in the
configuration's own precision against the float32 one; with
``--program-dtype float32`` the program runs in float32 and is read
against the reference with the program's bf16 refine, the same
arithmetic.  One process reads every seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n>... \
        [--control-seeds <n>...] [--witness-seeds <n>...] \
        [--program-dtype float32] [--out <file.jsonl>]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def train_seed(ctx, control, witness=False):
    import torch

    from benchmark.loops import common, train
    from benchmark.reference.layers import CONTROL, REFERENCE, Precision

    step, state, pool, gen, prog = train.program_setup(ctx)
    del step, state, pool, gen
    common.free()
    ref = train.reference_readings(ctx, Precision(
        torch.float32, False, torch.bfloat16) if ctx.program_dtype
        else REFERENCE)
    gaps = train.leaf_gaps(prog, ref)
    out = {"program": train.compare(prog, ref),
           "worst_leaves": {name: sorted(gaps[n], key=gaps[n].get)[-3:]
                            for _, n, name in train.TENSORS}}
    if control:
        out["control"] = train.compare(
            train.reference_readings(ctx, CONTROL), ref)
        out["half_batch"] = train.compare(
            train.reference_readings(ctx, half=True), ref)
        out["altered_leaf"] = train.compare(
            train.reference_readings(ctx, altered=True), ref)
    if witness:
        # the reference in the configuration's own precision (bf16, no
        # fp8), read as the program is
        out["reference_bf16"] = train.compare(train.reference_readings(
            ctx, Precision(torch.bfloat16, False, torch.bfloat16)), ref)
    return out


def infer_seed(ctx, control, witness=False):
    from benchmark.loops import common, infer
    from benchmark.reference.layers import CONTROL

    fn, pool = infer.program_setup(ctx)
    served = {j: infer.serve(fn, f)[0] for j, f in enumerate(pool)}
    del fn
    common.free()
    idx = infer.sample(ctx, served)
    frames = [pool[j] for j in idx]
    ref = infer.reference_probs(ctx, frames)
    out = {"program": infer.gaps(ref, [served[j] for j in idx])}
    if control:
        ctrl = infer.reference_probs(ctx, frames, CONTROL)
        out["control"] = infer.gaps(ref, [p[0].argmax(-1) for p in ctrl])
    return out


def main(argv=None, device=None, adjust=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-dtype", choices=("float32",))
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.loops.common import Ctx, card

    cell = harness.cell(args.workload)
    device = torch.device(device or "cuda")
    kw = {}
    if adjust is not None:      # tests: a tiny cell on the CPU
        cell, kw = adjust(cell)
    if args.program_dtype:
        kw["program_dtype"] = args.program_dtype
    fn = {"train": train_seed, "infer": infer_seed}[cell.traffic["loop"]]
    rows = []
    for seed in args.seeds:
        ctx = Ctx(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=device, t0=time.perf_counter(),
                  keys=harness.cfg_keys(cell), **kw)
        t = time.perf_counter()
        row = dict(workload=cell.name, seed=seed, card=card(device),
                   program_dtype=ctx.program_dtype,
                   **fn(ctx, seed in args.control_seeds,
                        seed in args.witness_seeds),
                   seconds=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
