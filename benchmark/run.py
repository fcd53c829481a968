"""The benchmark of ``dasac_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json``), makes
the weights and inputs from the seed on the card, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints the result as the last line of standard output
(the numbers compared, each beside its limit, also as the last lines of
standard error).  ``--trace 1`` traces a few units of work after the
window and reports the cell's per-layer metrics instead of its
end-to-end ones.  Exits non-zero, printing no result, without enough
CUDA devices, or when a module of JAX or of ``dasac_tpu`` is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "CUDA_CACHE_PATH": "nv"}
for var, sub in CACHES.items():
    os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("the cell %s needs %d CUDA device(s); %d visible"
              % (cell.name, cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    from benchmark.loops.common import Ctx

    device = torch.device("cuda", 0)
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device, t0=T0,
              keys=harness.cfg_keys(cell))
    rec = harness.loop(cell).run(ctx)
    banned = harness.banned_modules()
    if banned:
        print("modules loaded that the benchmark must not load: %s"
              % ", ".join(banned), file=sys.stderr)
        return 3
    line = harness.result_line(cell, rec, ctx.trace, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device),
        "count": cell.chips})
    sys.stderr.write("\n".join(harness.check_lines(rec)) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
