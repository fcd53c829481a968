"""Closed-loop trajectory comparison of ``TPU.REFINE_RES`` full vs stride8
(counterpart of ``dasac_tpu/tools/compare_refine_res.py``).

Unit-level stability (tests/test_refine_torch_parity.py) shows the stride-8
refine chain moves pseudo-labels only in a label-boundary band.  This tool
adds the closed-loop system check on the flagship step: train on a
learnable synthetic segmentation task until the teacher is confident, then
continue the SAME state under both settings and print the self-supervision
metric trajectories side by side.

Protocol (``dasac_tpu``'s):
1. Build a blob task: smooth low-frequency field per image, all three
   channels carry it; label = field > 0.5 -> class 5 else 9, from
   ``RandomState(0)``.
2. Warm up N steps with the stride8 step (the refine path is inert during
   warmup: the EMA teacher still tracks the random init, coverage = 0, so
   the warmup's setting cannot bias the arms).
3. Copy the student into the teacher (the lazy-init copy the reference
   performs when resuming SAC from a baseline snapshot,
   models/sac.py:74-81), fork the state, and run both arms from identical
   states on identical batches and per-step generator seeds.
4. Compare: ``src_loss_ce`` at the first step must be identical (the
   source branch never touches refine; the tool asserts it), later it
   drifts only through the shared trunk; pseudo_cover / self_ce /
   teacher_diff must track.

The step is ``tools/flagship.py``'s (``bench.py``'s: r101 bf16, 8 source
frames, 2 groups x 4 views at 512x1024, bf16 refine); ``--arch``, ``--hw``,
``--batch``, ``--groups`` and ``--group-size`` shrink it.

Usage:  python -m dasac_tpu_torch.tools.compare_refine_res
            [--warmup N] [--steps N] [--every K] [--json PATH]
"""

import argparse
import copy
import json

import numpy as np
import torch

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.tools import flagship
from dasac_tpu_torch.train import steps

_SCALARS = ("src_loss_ce", "self_ce", "teacher_diff", "pseudo_cover")


def _blob_batch(rng, batch, groups, hw):
    """Smooth-field images + thresholded two-class labels."""

    def field(n):
        coarse = rng.rand(n, 8, 16).astype(np.float32)
        reps = (hw[0] + 7) // 8, (hw[1] + 15) // 16
        f = np.repeat(np.repeat(coarse, reps[0], 1), reps[1], 2)
        f = f[:, :hw[0], :hw[1]]
        # separable box blur so the threshold boundary is smooth, not blocky
        k = 31

        def blur(x, axis):
            pad = np.pad(x, [(k // 2, k - k // 2) if a == axis else (0, 0)
                             for a in range(3)], mode="edge")
            cs = np.cumsum(pad, axis=axis, dtype=np.float64)
            n = x.shape[axis]
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[axis], hi[axis] = slice(0, n), slice(k, k + n)
            return ((cs[tuple(hi)] - cs[tuple(lo)]) / k).astype(np.float32)

        return blur(blur(f, 1), 2)

    def render(f):
        img = (f[..., None] * 200 + 25 +
               rng.randn(*f.shape, 3) * 8).clip(0, 255)
        return img.astype(np.uint8)

    fs = field(batch)
    ft = field(groups)
    return (render(fs), np.where(fs > 0.5, 5, 9).astype(np.uint8),
            render(ft), np.where(ft > 0.5, 5, 9).astype(np.uint8))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--batches", type=int, default=4,
                    help="distinct synthetic batches cycled through")
    ap.add_argument("--resize-method", choices=["matmul", "gather"],
                    default="matmul",
                    help="accepted for dasac_tpu's command lines; no effect")
    ap.add_argument("--json", default=None)
    flagship.add_step_args(ap)
    return ap.parse_args(argv)


def _scalars(metrics):
    return {k: float(metrics[k]) for k in _SCALARS}


def main(argv=None, device=None):
    """Run the protocol; returns ``{"trajectories", "worst_abs_delta"}``
    (what ``--json`` writes).  ``device`` defaults to CUDA (raises when
    there is none)."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    card = flagship.device_label(device)

    rng = np.random.RandomState(0)
    batches = [tuple(torch.from_numpy(a).to(device) for a in _blob_batch(
        rng, args.batch, args.groups, tuple(args.hw)))
        for _ in range(args.batches)]

    def gen(i):
        return torch.Generator(device=device).manual_seed(i)

    step = {res: steps.make_sac_step(flagship.step_config(args,
                                                          refine_res=res),
                                     device=device)
            for res in ("full", "stride8")}
    state = flagship.build_state(args, device)
    m = None
    for i in range(args.warmup):
        m = step["stride8"](state, batches[i % len(batches)], gen(i))
    if m is not None:
        print("after warmup:", json.dumps(_scalars(m)), flush=True)

    # the reference's resume-time lazy init: teacher <- student wholesale
    with torch.no_grad():
        for store, src in ((state.teacher_params, state.student_params()),
                           (state.teacher_stats, state.student_stats())):
            for k, t in store.items():
                t.copy_(src[k])

    rows = {}
    for res in ("full", "stride8"):
        st = copy.deepcopy(state)
        traj = []
        for i in range(args.steps):
            metrics = step[res](st, batches[i % len(batches)],
                                gen(args.warmup + i))
            if (i + 1) % args.every == 0 or i == 0:
                traj.append(dict(_scalars(metrics), step=i + 1))
        rows[res] = traj
        del st

    first = rows["full"][0]["src_loss_ce"], rows["stride8"][0]["src_loss_ce"]
    if first[0] != first[1]:
        raise RuntimeError("src_loss_ce differs at the first step (full %r, "
                           "stride8 %r): the source branch must not see the "
                           "refine setting" % first)
    worst = {k: 0.0 for k in _SCALARS}
    for a, b in zip(rows["full"], rows["stride8"]):
        cells = []
        for k in _SCALARS:
            d = abs(a[k] - b[k])
            worst[k] = max(worst[k], d)
            cells.append("%s %.5f/%.5f |Δ|=%.5f" % (k, a[k], b[k], d))
        print("%4d  %s" % (a["step"], "  ".join(cells)), flush=True)
    print("worst |Δ|: " + json.dumps(worst), flush=True)
    out = {"trajectories": rows, "worst_abs_delta": worst, "card": card}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
