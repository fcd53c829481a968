"""Inference traffic: a closed loop of one frame a call through the
port's ``infer.engine.make_infer_fn`` (the traffic's scales, flip and
fuse, ``output="argmax"``), the label map copied to the host before the
next call, as ``run_inference`` does.  The frames are a pool of
loader-size uint8 frames made on the device, served in turn.

Each call's latency runs from the call to its label map on the host.
Once the window has closed and the program is freed, the plain
reference computes the fused float32 probabilities of a sample of the
served frames, drawn from the seed, and each served label is judged by
how far the reference's probability of it lies below the reference's
best at that pixel."""

import math
import random
import time

import torch

from benchmark import inputs
from benchmark.loops import common
from benchmark.harness import Record
from benchmark.reference import steps as ref_steps
from benchmark.reference.layers import REFERENCE

TRACE_FRAMES = 4


def program_setup(ctx):
    """The port's inference function and the frame pool: (fn, pool)."""
    from dasac_tpu_torch.core.device import autotune_convolutions
    from dasac_tpu_torch.infer.engine import make_infer_fn

    cfg = common.port_cfg(ctx)
    autotune_convolutions(ctx.device)
    model = common.program_model(ctx, cfg, common.reference_weights(ctx))
    t = ctx.cell.traffic
    fn = make_infer_fn(model, tuple(cfg.DATASET.MEAN), tuple(cfg.DATASET.STD),
                       scales=tuple(t["scales"]), flip=t["flip"],
                       fuse=t["fuse"], output="argmax", device=ctx.device)
    return fn, inputs.infer_pool(ctx.seed, t, ctx.device)


def serve(fn, frame):
    """One request: the frame's label map on the host."""
    return fn(frame).cpu()


def reference_probs(ctx, frames, prec=REFERENCE):
    """The reference's fused float32 probabilities of each of ``frames``
    (uint8 [1, H, W, 3]), on the device."""
    common.reference_mode()
    t = ctx.cell.traffic
    model = ref_steps.build_model(ctx.arch, ctx.num_classes,
                                  common.reference_weights(ctx), ctx.device,
                                  **ctx.model_kw)
    out = [ref_steps.infer_probs(
        model, f, prec, mean=tuple(ctx.keys["DATASET.MEAN"]),
        std=tuple(ctx.keys["DATASET.STD"]), scales=tuple(t["scales"]),
        flip=t["flip"]) for f in frames]
    del model
    common.free()
    return out


def gaps(probs, labels):
    """``gap``: the widest by which the reference's probability of a
    served label lies below its best at that pixel; ``disagree``: the
    share of pixels whose served label is not the reference's argmax."""
    gap, off, n = 0.0, 0, 0
    for p, lab in zip(probs, labels):
        p, lab = p.reshape(*lab.shape, -1), lab.to(p.device).long()
        best, arg = p.max(dim=-1)
        got = p.gather(-1, lab[..., None])[..., 0]
        gap = max(gap, float((best - got).max()))
        off += int((arg != lab).sum())
        n += lab.numel()
    return {"gap": gap, "disagree": off / n}


def sample(ctx, served):
    """The pool indices whose served labels are compared: a draw from the
    seed among those served."""
    k = min(ctx.cell.traffic["check_frames"], len(served))
    return sorted(random.Random(inputs.stream(ctx.seed, "check")).sample(
        sorted(served), k))


def _passes(ctx):
    t = ctx.cell.traffic
    h, w = t["hw"]

    def run(model, prec):
        x = torch.zeros((1, h, w, 3), dtype=torch.uint8)
        ref_steps.infer_probs(model, x, prec,
                              mean=tuple(ctx.keys["DATASET.MEAN"]),
                              std=tuple(ctx.keys["DATASET.STD"]),
                              scales=tuple(t["scales"]), flip=t["flip"])
    return run


def run(ctx):
    fn, pool = program_setup(ctx)
    for f in pool[:ctx.cell.traffic["warmup"]]:
        serve(fn, f)
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    shape = (1, *ctx.cell.traffic["hw"])
    lat, served, i, failed = [], {}, 0, 0
    t_start = time.perf_counter()
    while True:
        ta = time.perf_counter()
        labels = serve(fn, pool[i % len(pool)])
        tb = time.perf_counter()
        lat.append(tb - ta)
        if tuple(labels.shape) == shape and labels.dtype == torch.uint8:
            served[i % len(pool)] = labels
        else:
            failed += 1
        i += 1
        if tb - t_start >= ctx.seconds:
            break
    window_s = tb - t_start
    n = len(lat)

    reads = None
    if ctx.trace:
        from benchmark import trace

        def one():
            nonlocal i
            serve(fn, pool[i % len(pool)])
            i += 1

        t = trace.record(one, TRACE_FRAMES)
        reads = common.readings(ctx, t, n / window_s,
                                common.count(ctx, _passes(ctx)))
    peak = common.peak_bytes(ctx.device)
    del fn
    common.free()

    idx = sample(ctx, served)
    probs = reference_probs(ctx, [pool[j] for j in idx])
    lim = ctx.cell.limits
    got = gaps(probs, [served[j][0] for j in idx])
    checks = {k: (got[k], lim[k]) for k in lim}
    lat.sort()
    p95 = lat[max(0, math.ceil(0.95 * n) - 1)]
    return Record(setup_s=setup_s,
                  end_to_end={"infer_frames_s": n / window_s,
                              "infer_frame_ms_p95": p95 * 1e3,
                              "peak_gb": peak / 1e9, "setup_s": setup_s},
                  attempted=n, failed=failed, peak_bytes=peak, checks=checks,
                  readings=reads)
