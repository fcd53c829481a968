#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``dasac_tpu_torch``).

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a nonzero exit code and
no result line:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. kernels  the fused-CE CUDA pair (``dasac_tpu_torch/csrc/ce.cu``,
              bound in ``ops/ce.py``) built by nvcc from this checkout, with
              nvcc's ``-Xptxas -v`` figures for each kernel; it and the
              Triton pair kept as a yardstick (``ops/ce_triton.py``) held
              against their plain PyTorch version at the flagship shape
              (f32 ``[8,512,1024,19]``, ~20% ignored labels), with bf16
              logits, and with every label ignored; then the CUDA kernel,
              the Triton kernel, the plain version and ``F.cross_entropy``
              (a yardstick the port never calls) timed in turns with CUDA
              events;
  3. agree    the SAC views step on a small input, on the card and on the
              CPU (plain kernels, held against ``dasac_tpu`` by the tests),
              2 iterations, same weights and views;
  4. slice    the flagship SAC step: ``make_sac_step`` on a full-width,
              full-depth ``deeplabv2_resnet101`` in bf16 at 512x1024, with
              8 source images and 2 target groups of 4 views, random
              weights and uint8 batches made from a seed.  The kernels'
              launch counts (by kernel and by path) are set to 0 just
              before and read just after: every launch on the bulk path.
              Then 2 more steps run under torch.profiler and their device
              time is printed by kernel and by part of the step.

Before the last line it prints one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_STEPS = 8          # steps of the flagship slice; the first 2 are warm-up
WARMUP_STEPS = 2
REPS = 25            # timed samples per kernel measurement and round
CALLS_PER_SAMPLE = 5  # calls in a row between a sample's two events
SPIN_CYCLES = 2_000_000  # ~1 ms of spin ahead of each sample's calls
C = 19
IGNORE = 255
FLAGSHIP = (8, 512, 1024)
# published device-memory rate of the card, by product (NVIDIA data sheets)
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
F32_PEAK = 67e12     # H100 SXM, float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def need(cond, msg):
    """A check of the run's results (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def mem_rate(name):
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError("no memory rate known for %r" % name)


# ---------------------------------------------------------------------------
# phase 2: the kernels
# ---------------------------------------------------------------------------

def ptxas_summary(log):
    """One dict per kernel from nvcc's ``-Xptxas -v`` output: registers,
    spill stores and loads, stack frame."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def build_cuda(ce):
    """Build (or load) the CE library and print each kernel's ptxas
    figures."""
    import torch

    from dasac_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    ce._library(torch.device("cuda"))
    log("build: %s in %.1f s" % (cuda_build.library_path(ce.SOURCE).name,
                                 time.perf_counter() - t0))
    rows = ptxas_summary(cuda_build.build_log(ce.SOURCE))
    need(rows, "no ptxas figures in the build log")
    for r in rows:
        log("ptxas %s" % json.dumps(r))
    return rows


def cuda_times(fn, samples=REPS, per_sample=CALLS_PER_SAMPLE, warmup=3):
    """``samples`` device times of one call, ms: each the CUDA-event time of
    ``per_sample`` calls in a row over ``per_sample``.  A spin kernel ahead
    of the first event holds the card while the host enqueues the calls,
    so the host's launch latency is not counted, only the card's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return times


def in_turns(fns, rounds=2):
    """Median ms of each of ``fns`` (name -> callable), timed in turns:
    in order, then in reverse order."""
    samples = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            samples[k] += cuda_times(fns[k])
    return {k: statistics.median(v) for k, v in samples.items()}


def kernel_inputs(dtype, ignore_frac, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    n = math.prod(FLAGSHIP)
    x = (torch.randn(*FLAGSHIP, C, generator=gen, device=device) * 3).to(dtype)
    lbl = torch.randint(0, C, FLAGSHIP, generator=gen, device=device,
                        dtype=torch.int32)
    lbl[torch.rand(FLAGSHIP, generator=gen, device=device) < ignore_frac] = \
        IGNORE
    g = torch.rand(n, generator=gen, device=device)
    return x.view(n, C), lbl.view(n), g


def check_kernels(ce, device):
    """Each case: (name, dtype, ignore_frac, fwd tol, bwd tol).  Tolerances
    are absolute.  The NLL of these logits reaches ~25, so 1e-4 is a few
    f32 ulps of it.  dx lies in [-1, 1]: 1e-6 covers f32 exp/division
    roundoff; in bf16 both sides round an f32 value that may differ in its
    last bits, so one bf16 ulp at 1 (2^-8) bounds the difference."""
    import torch

    cases = [("f32", torch.float32, 0.2, 1e-4, 1e-6),
             ("bf16", torch.bfloat16, 0.2, 1e-4, 2.0 ** -8),
             ("all_ignored", torch.float32, 1.0, 0.0, 0.0)]
    results = []
    for name, dtype, frac, tol_f, tol_b in cases:
        x2, lbl, g = kernel_inputs(dtype, frac, device)
        nll = ce.nll_fwd(x2, lbl)
        dx = ce.nll_bwd(x2, lbl, g)
        if x2.is_cuda:
            torch.cuda.synchronize()
        need(nll.dtype == torch.float32 and dx.dtype == dtype,
             "%s: dtypes %s %s" % (name, nll.dtype, dx.dtype))
        err_f = (nll - ce.nll_fwd_plain(x2, lbl)).abs().max().item()
        err_b = (dx.float() - ce.nll_bwd_plain(x2, lbl, g).float()
                 ).abs().max().item()
        if frac == 1.0:
            need(not nll.any() and not dx.any(), name + ": nonzero output")
        for kern, err, tol in (("nll_fwd", err_f, tol_f),
                               ("nll_bwd", err_b, tol_b)):
            log("kernel check %-7s %-11s max_abs_err %.3e (tol %.1e) %s"
                % (kern, name, err, tol, ce.__name__))
            need(err <= tol, "%s %s disagrees with its plain version: "
                 "%.3e > %.1e" % (kern, name, err, tol))
            results.append(dict(kernel=kern, case=name, max_abs_err=err,
                                tol=tol))
        del x2, lbl, g, nll, dx
    return results


def time_kernels(ce, ce_triton, device, name):
    """The CUDA kernel, the Triton kernel, the plain version and the
    library call of each of K1, K2, in turns on the same inputs (335 MB,
    above the 50 MB L2: cold by size)."""
    import torch
    import torch.nn.functional as F

    x2, lbl, g = kernel_inputs(torch.float32, 0.2, device)
    lbl64 = lbl.long()
    n, c = x2.shape
    rate = mem_rate(name)
    xb = n * c * x2.element_size()
    lb = n * lbl.element_size()

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / rate * 1e3, ops / F32_PEAK * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    xg = x2.detach().requires_grad_(True)

    def lib_fwd():
        with torch.no_grad():
            F.cross_entropy(x2, lbl64, reduction="none", ignore_index=IGNORE)

    def lib_fwd_bwd():
        loss = F.cross_entropy(xg, lbl64, reduction="none",
                               ignore_index=IGNORE)
        torch.autograd.grad(loss, xg, g)

    fwd_bound, fwd_by = bound(xb + lb + n * 4, 6 * n * c)
    bwd_bound, bwd_by = bound(2 * xb + lb + n * 4, 8 * n * c)
    fwd = in_turns(dict(
        ms=lambda: ce.nll_fwd(x2, lbl),
        triton_ms=lambda: ce_triton.nll_fwd(x2, lbl),
        plain_ms=lambda: ce.nll_fwd_plain(x2, lbl),
        library_ms=lib_fwd))
    bwd = in_turns(dict(
        ms=lambda: ce.nll_bwd(x2, lbl, g),
        triton_ms=lambda: ce_triton.nll_bwd(x2, lbl, g),
        plain_ms=lambda: ce.nll_bwd_plain(x2, lbl, g),
        library_ms=lib_fwd_bwd))
    out = {
        "nll_fwd": dict(fwd, bound_ms=fwd_bound, bound_by=fwd_by,
                        bytes=xb + lb + n * 4),
        "nll_bwd": dict(bwd, bound_ms=bwd_bound, bound_by=bwd_by,
                        bytes=2 * xb + lb + n * 4),
    }
    for k, v in out.items():
        v["bound_share"] = v["bound_ms"] / v["ms"]
        v["triton_bound_share"] = v["bound_ms"] / v["triton_ms"]
        log("kernel time  %-7s cuda %.4f ms (%.0f%% of bound), triton %.4f "
            "(%.0f%%), plain %.4f, F.cross_entropy %.4f, bound %.4f by %s"
            % (k, v["ms"], 100 * v["bound_share"], v["triton_ms"],
               100 * v["triton_bound_share"], v["plain_ms"],
               v["library_ms"], v["bound_ms"], v["bound_by"]))
    return out


# ---------------------------------------------------------------------------
# phase 3: card against CPU on a small input
# ---------------------------------------------------------------------------

class _ModelCfg:
    """The MODEL section bench.py uses."""
    LR = 2.5e-4
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


def check_agreement(device):
    import torch

    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.nn.layers import Conv2d
    from dasac_tpu_torch.train import optim, steps

    h, w, g, t = 40, 48, 2, 3
    scfg = steps.StepConfig(crop_hw=(h, w), group_size=t, lr_target=0.1,
                            net_momentum_iter=1, run_conf_lower=0.01)
    rng = np.random.RandomState(SEED)
    views = pipelines.augment_target_groups(
        torch.Generator().manual_seed(SEED),
        torch.from_numpy(rng.randint(0, 256, (g, h, w, 3)).astype(np.uint8)),
        torch.from_numpy(rng.randint(0, C, (g, h, w)).astype(np.uint8)),
        group_size=t, jitter=0.4, greyscale=0.2)
    src_x = torch.from_numpy(rng.randn(2, h, w, 3).astype(np.float32))
    src_y = torch.from_numpy(rng.randint(0, C, (2, h, w)).astype(np.int32))

    gen = torch.Generator().manual_seed(SEED)
    ref_model = build_model("deeplabv2_resnet101", C, device="cpu",
                            layers=(1, 1, 1, 1), generator=gen)
    with torch.no_grad():   # He-scaled weights: confident, varied logits
        for m in ref_model.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    runs = {}
    for dev in ("cpu", device):
        model = build_model("deeplabv2_resnet101", C, device="cpu",
                            layers=(1, 1, 1, 1))
        model.load_state_dict(ref_model.state_dict())
        opt = optim.build_optimizer(_ModelCfg, "deeplabv2_resnet101", model)
        state = create_train_state(model, opt, C, device=dev)
        step = steps.make_sac_views_step(scfg, debug="light")
        v = pipelines.TargetViews(*(a.to(dev) for a in views))
        mets = [step(state, src_x.to(dev), src_y.to(dev), v)
                for _ in range(2)]
        runs[dev] = (state, [{k: x.cpu() for k, x in m.items()} for m in mets])
    (s_ref, m_ref), (s_dev, m_dev) = runs["cpu"], runs[device]
    worst = 0.0
    for it, (a, b) in enumerate(zip(m_ref, m_dev)):
        for k in ("src_loss_ce", "self_ce", "running_conf"):
            torch.testing.assert_close(b[k], a[k], rtol=1e-3, atol=1e-5,
                                       msg="iter %d %s" % (it, k))
        mismatch = (a["pseudo"] != b["pseudo"]).float().mean().item()
        cover = (a["pseudo"] != IGNORE).float().mean().item()
        need(cover > 0.05 and mismatch < 0.01,
             "iter %d: pseudo cover %.4f mismatch %.4f" % (it, cover,
                                                           mismatch))
        worst = max(worst, mismatch)
    ref_p = dict(s_ref.model.named_parameters())
    for k, p in s_dev.model.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), ref_p[k].detach(),
                                   rtol=1e-3, atol=1e-5, msg=k)
        torch.testing.assert_close(s_dev.teacher_params[k].cpu(),
                                   s_ref.teacher_params[k], rtol=1e-3,
                                   atol=1e-5, msg="teacher " + k)
    log("agree: card vs CPU views step, 2 iterations: losses, running_conf, "
        "params and teacher within rtol 1e-3 / atol 1e-5; pseudo-label "
        "mismatch %.5f (< 0.01)" % worst)


# ---------------------------------------------------------------------------
# phase 4: the flagship slice
# ---------------------------------------------------------------------------

def run_slice(ce, ce_triton, device, card):
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    torch.backends.cudnn.benchmark = True
    b, h, w = FLAGSHIP
    groups, group_size = 2, 4
    scfg = steps.StepConfig(
        num_classes=C, crop_hw=(h, w), group_size=group_size, lr_target=5.0,
        net_momentum_iter=2, zoom=(0.5, 1.0), guided_hflip=True,
        tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2, src_scale=(0.5, 1.0),
        refine_dtype="bfloat16", refine_res="stride8", ce_impl="kernel")
    model = build_model("deeplabv2_resnet101", C, dtype=torch.bfloat16,
                        remat="none", device=device,
                        generator=torch.Generator().manual_seed(SEED))
    opt = optim.build_optimizer(_ModelCfg, "deeplabv2_resnet101", model)
    state = create_train_state(model, opt, C, device=device)
    step = steps.make_sac_step(scfg, device=device)
    rng = np.random.RandomState(SEED)
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        (rng.rand(b, h, w, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (b, h, w)).astype(np.uint8),
        (rng.rand(groups, h, w, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (groups, h, w)).astype(np.uint8)))
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counts in (ce.LAUNCHES, ce_triton.LAUNCHES):
        for k in counts:
            counts[k] = 0
    for by_path in ce.PATH_LAUNCHES.values():
        for p in by_path:
            by_path[p] = 0
    times, rows = [], []
    for i in range(N_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        row = {k: float(m[k]) for k in ("src_loss_ce", "self_ce",
                                        "teacher_diff", "pseudo_cover")}
        for k, v in row.items():
            need(math.isfinite(v), "step %d: %s = %r" % (i, k, v))
        need(bool(torch.isfinite(m["self_ce_per_class"]).all()),
             "step %d: self_ce_per_class" % i)
        rows.append(row)
        log("slice step %d: %.1f ms %s" % (i, times[-1], json.dumps(row)))
    launches = dict(ce.LAUNCHES)
    paths = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    triton_launches = dict(ce_triton.LAUNCHES)
    want = {"nll_fwd": 2 * N_STEPS, "nll_bwd": 2 * N_STEPS}
    need(launches == want, "CE launches %s, want %s" % (launches, want))
    need(paths == {k: {"bulk": v, "strided": 0} for k, v in want.items()},
         "CE launches by path %s: want all on the bulk path" % paths)
    need(not any(triton_launches.values()),
         "the Triton yardstick ran on the main path: %s" % triton_launches)
    need(state.step == N_STEPS and state.slow_init == 1,
         "step %d slow_init %d" % (state.step, state.slow_init))
    need(any(r["teacher_diff"] > 0 for r in rows[1:]),
         "the teacher never moved from the student")
    nonfinite = [k for k, p in model.named_parameters()
                 if not torch.isfinite(p).all()]
    need(not nonfinite, "non-finite params: %s" % nonfinite[:4])
    out = dict(
        card=card, steps=N_STEPS, warmup=WARMUP_STEPS,
        step_ms=times, step_ms_median=statistics.median(times[WARMUP_STEPS:]),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        ce_launches=launches, ce_launches_by_path=paths,
        triton_launches=triton_launches,
        batch=dict(source=b, target_groups=groups, group_size=group_size,
                   hw=[h, w]))
    log("slice: %s" % json.dumps(out))
    profile_steps(step, state, batch, gen, card)
    return launches, paths, triton_launches


# kernel-name fragments -> the part of the step they belong to
_GROUPS = (("ce_kernels", ("nll_fwd", "nll_bwd")),
           ("convolution", ("conv", "xmma", "implicit", "fprop", "dgrad",
                            "wgrad", "cudnn", "winograd")),
           ("matmul", ("gemm", "cutlass", "cublas")),
           ("copy_layout", ("copy", "transpose", "permute", "cat")),
           ("reduction", ("reduce", "softmax", "norm", "sum", "max", "argm")),
           ("elementwise", ("elementwise", "vectorized", "where", "fill")))


def profile_steps(step, state, batch, gen, card, n=2):
    """Device time of ``n`` steps by kernel, from torch.profiler: the
    largest kernels, the sums by part of the step, and the device busy
    share of the host wall time (kernel time summed over the window; the
    step runs on one stream, so kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the kernels themselves; the operators that launched them carry the
    # same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    groups = {}
    for key, ms, _ in rows:
        low = key.lower()
        g = next((g for g, frags in _GROUPS
                  if any(f in low for f in frags)), "other")
        groups[g] = groups.get(g, 0.0) + ms / n
    need(total > 0, "the profiler saw no device time")
    log("profile: %s" % json.dumps(dict(
        card=card, steps=n, wall_ms_per_step=wall / n,
        device_ms_per_step=total / n, busy_share=total / wall,
        by_part_ms_per_step=groups,
        top=[dict(name=k[:90], ms_per_step=ms / n, calls_per_step=c / n)
             for k, ms, c in rows[:25]],
        # the CE kernels inside the step, device time of one launch
        ce_kernels=[dict(name=k[:90], ms_per_launch=ms / c,
                         calls_per_step=c / n)
                    for k, ms, c in rows
                    if any(f in k for f in _GROUPS[0][1])])))


# ---------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dasac_tpu_torch.ops import ce, ce_triton

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")

    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log("card: %s" % card)
    log("torch: %s, cuda %s, %s x %d" % (torch.__version__, torch.version.cuda,
                                         name, torch.cuda.device_count()))

    ptxas = build_cuda(ce)
    paths_before = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    checks = check_kernels(ce, device)
    need(all(ce.PATH_LAUNCHES[k]["bulk"] == paths_before[k]["bulk"] + 3
             for k in ce.PATH_LAUNCHES),
         "kernel checks off the bulk path: %s" % ce.PATH_LAUNCHES)
    triton_checks = check_kernels(ce_triton, device)
    timing = time_kernels(ce, ce_triton, device, name)
    torch.cuda.empty_cache()
    check_agreement(device)
    launches, paths, triton_launches = run_slice(ce, ce_triton, device, card)

    replaces = {"nll_fwd": "dasac_tpu/ops/ce.py:49",
                "nll_bwd": "dasac_tpu/ops/ce.py:60"}
    kernels = []
    for route, results in (("cuda", checks), ("triton", triton_checks)):
        for k in ("nll_fwd", "nll_bwd"):
            mine = [c for c in results if c["kernel"] == k]
            t = timing[k]
            row = dict(
                name=k if route == "cuda" else k + "_triton", route=route,
                source=("dasac_tpu_torch/csrc/ce.cu" if route == "cuda"
                        else "dasac_tpu_torch/ops/ce_triton.py"),
                replaces=replaces[k], main_path=route == "cuda",
                launches=(launches if route == "cuda"
                          else triton_launches)[k],
                max_abs_err=max(c["max_abs_err"] for c in mine),
                tolerance={c["case"]: c["tol"] for c in mine}, checks=mine,
                ms=t["ms"] if route == "cuda" else t["triton_ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                bound_share=(t["bound_share"] if route == "cuda"
                             else t["triton_bound_share"]),
                bytes=t["bytes"], card=card)
            if route == "cuda":
                row.update(triton_ms=t["triton_ms"],
                           launches_by_path=paths[k],
                           ptxas=[r for r in ptxas if k + "_bulk_kernelILi19E"
                                  in r["kernel"]])
            kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log("card: %s; total %.1f s" % (card, time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
