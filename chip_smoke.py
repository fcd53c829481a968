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
              against their plain PyTorch version at the SAC step's shape
              (f32 ``[8,512,1024,19]``, ~20% ignored labels), with bf16
              logits, and with every label ignored, and at the ABN step's
              source and target shapes (f32 ``[12,640,640,19]`` and
              ``[8,640,640,19]``, 10% ignored plus crop padding) and the
              VGG ABN step's source rows (``[16,640,640,19]``); then
              the CUDA kernel, the Triton kernel, the plain version and
              ``F.cross_entropy`` (a yardstick the port never calls) timed
              in turns with CUDA events at the SAC step's shape;
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
              time is printed by kernel and by part of the step;
  5. abn_agree  the ABN frames step on a small input (shallow r101, f32,
              64x64), on the card and on the CPU, 2 iterations, same
              weights and frames: losses, BN running statistics and
              parameters;
  6. abn      the flagship ABN step: ``make_abn_step`` on the full-width,
              full-depth r101 in bf16 with the config of
              ``configs/deeplabv2_resnet101.yaml`` (640x640 crops at scale
              0.5-2.0 from 12 source frames of 1052x1914 and 8 target
              frames of 1024x2048), 8 steps with the launch counts set to 0
              before and read after (2 ``nll_fwd`` + 1 ``nll_bwd`` a step,
              all bulk), then 2 steps under the profiler;
  7. handoff  the ABN state saved with the port's Checkpointer and loaded
              into a fresh SAC state (teacher not initialized, momentum
              restored), then 2 flagship SAC steps from it;
  8. eval     student and teacher eval (4 frames), the four-layer target
              eval (2 groups of 4 views) and the visual step (1 group), at
              512x1024, with their confusions checked against the labelled
              pixel counts and each timed call's host and device ms;
  9. infer    ``make_infer_fn`` on one 1024x2048 frame: one scale with
              full-resolution fusion (held against the argmax of the
              probabilities), and 3 scales with flip fused at stride 8;
 10. train    the training program through its CLI
              (``dasac_tpu_torch.train.cli.main``), in this process, on a
              synthetic root written under ``build/smoke_train`` (removed
              after) by the port's PNG encoder at the real frame sizes: 24
              GTA-sized source frames (1052x1914), 8 Cityscapes-sized
              target frames (cut from 16 to keep the smoke's time down; the
              target split is stretched to the source's length, so the
              step counts do not change) and 4 frames for every
              val split (1024x2048), labels 0..18 with ~10% ignored; with
              the decode time of one 1024x2048 frame of the root.  Then
              the recipe's stages with ``TPU.CE_IMPL pallas``: ABN
              (``configs/deeplabv2_resnet101.yaml``, 2 epochs x 2 steps
              and one validation round), SAC from the ABN ``last.pth``
              (``configs/deeplabv2_resnet101_train.yaml``, epochs 2 and 3, 3
              steps each, one validation round with the four-layer target
              validation) and ``--resume auto`` of the SAC run (epoch 4,
              from the saved parameters and momentum).  Each stage is
              measured from outside the trainer (a subclass times each
              step call, each metrics readback, each loader wait, each
              validation and each snapshot) and checked: finite losses, 2 +
              1 CE launches per ABN step and 2 + 2 per SAC step all on the
              bulk path, the events of every val split and of the target
              split, the best snapshot and ``last.pth``, the start epoch;
 11. vgg_agree  the SAC views step of ``deeplabv2_vgg16_bn`` and
              ``fcn_vgg16_bn`` (full width, FCN8s without dropout) on a
              40x48 input, on the card and on the CPU, 2 iterations;
 12. vgg      for each VGG arch at full width and depth in bf16: the SAC
              step of its ``_train.yaml`` (512x1024, 8 source frames + 2
              groups of 4 views, FCN8s's dropout on), 2 + 6 steps, and the
              ABN step of its base YAML (640x640 crops from 16 source
              frames of 1052x1914 and 2 target frames of 1024x2048, the
              YAMLs' TRAIN.BATCH_SIZE and NUM_GROUPS), 2 + 4 steps; launch
              counts (2 + 2 and 2 + 1 a step, all bulk), peak memory, and
              2 steps of each under the profiler;
 13. infer_cli  the inference program through its CLI
              (``dasac_tpu_torch.infer.cli.main``) in this process, with
              the SAC snapshot of phase 7, on a Cityscapes-val layout of 8
              frames at 1024x2048 written under ``build/smoke_infer``
              (removed after): one scale at batch 1, then 3 scales + flip
              fused at stride 8 at batch 2; the exports checked, scored by
              ``tools.evaluate_miou`` (equal to the CLI's confusion and
              mIoU) and turned into IS weights by
              ``tools.compute_is_weights``; ms per frame by part;
 14. bench_infer  ``tools.bench_infer`` (on-device argmax, 1024x2048):
              r101 and both VGG archs at batch 1 and 4, and r101 with 3
              scales + flip fused at stride 8, one JSON line each.
Each phase prints one JSON line with the card's name and power limit.
Phases 10, 13 and 14 call each entry point with cuDNN autotuning off, as a
new process starts, and check that the entry point turned it on.

Before the last line it prints one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``; the CUDA rows of the kernels
line carry the trainer's launches (``launches_train``) and the VGG steps'
(``launches_vgg``).

``python3 chip_smoke.py --abn-lr-witness`` runs none of these phases: it
runs the flagship ABN step for 8 steps at 1, 0.1, 0.01 and 0.001 times
the recipe's learning rates, from the same weights and frames, and prints
the losses of every step.
"""

import json
import math
import os
import re
import statistics
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
# loader sizes of the ABN recipe's frames: GTA5 (data/lists.py:71) and
# Cityscapes; 12 source + 8 target frames (TRAIN.BATCH_SIZE, NUM_GROUPS),
# cropped to ABN_CROP
ABN_SRC = (12, 1052, 1914)
ABN_TGT = (8, 1024, 2048)
ABN_CROP = (640, 640)
# the VGG ABN YAMLs' source batch (TRAIN.BATCH_SIZE 16): the most CE rows
# of any path, 16x640x640
VGG_ABN_ROWS = (16, *ABN_CROP)
INFER_HW = (1024, 2048)  # one Cityscapes val frame
# published device-memory rate of the card, by product (NVIDIA data sheets)
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
F32_PEAK = 67e12     # H100 SXM, float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def need(cond, msg):
    """A check of the run's results (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def fresh_cudnn():
    """cuDNN autotuning off, as a new process starts it, so that an entry
    point driven in this process runs with the setting it makes itself
    (``core.device.autotune_convolutions``); the bare-step phases turn it
    on for themselves."""
    import torch

    torch.backends.cudnn.benchmark = False


def mem_rate(name):
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError("no memory rate known for %r" % name)


def abn_step_config():
    """The ABN phase's step config: ``configs/deeplabv2_resnet101.yaml``
    over the config defaults, spelled out (this script reads no YAML; a CPU
    test holds it equal to ``step_config_from_cfg`` of the YAML), with the
    CE kernels chosen explicitly."""
    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.train import steps

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    src_mean, src_std = pipelines.renorm_stats(
        mean, std, (0.481, 0.479, 0.465), (0.243, 0.239, 0.237),
        (0.300, 0.344, 0.297), (0.175, 0.180, 0.177))
    return steps.StepConfig(
        num_classes=C, crop_hw=ABN_CROP, group_size=1, lr_target=0.0,
        refine_dtype="bfloat16", refine_res="stride8", ce_impl="kernel",
        src_scale=(0.5, 2.0), src_jitter=0.5, src_mean=src_mean,
        src_std=src_std, guided_hflip=False, tgt_jitter=0.5, mean=mean,
        std=std)


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


def kernel_inputs(dtype, ignore_frac, device, shape=FLAGSHIP, pad_rows=0):
    """Logits ``[N, C]`` (N = prod(shape)), int32 labels with a share
    ``ignore_frac`` ignored and the last ``pad_rows`` rows of every image
    ignored (a crop's padding), and an f32 upstream gradient ``[N]``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    n = math.prod(shape)
    x = (torch.randn(*shape, C, generator=gen, device=device) * 3).to(dtype)
    lbl = torch.randint(0, C, shape, generator=gen, device=device,
                        dtype=torch.int32)
    lbl[torch.rand(shape, generator=gen, device=device) < ignore_frac] = \
        IGNORE
    if pad_rows:
        lbl[:, -pad_rows:] = IGNORE
    g = torch.rand(n, generator=gen, device=device)
    return x.view(n, C), lbl.view(n), g


def kernel_cases():
    """(name, dtype, ignore_frac, shape, pad_rows, fwd tol, bwd tol): the
    SAC path's shape in f32 and bf16 and with every label ignored, then the
    ABN path's source (12x640x640) and target (8x640x640) rows and the VGG
    ABN source rows (16x640x640) in f32 with the ABN label mix (10%
    ignored, and 80 rows of crop padding: the crop of a frame shrunk below
    640 rows)."""
    import torch

    return [("f32", torch.float32, 0.2, FLAGSHIP, 0, 1e-4, 1e-6),
            ("bf16", torch.bfloat16, 0.2, FLAGSHIP, 0, 1e-4, 2.0 ** -8),
            ("all_ignored", torch.float32, 1.0, FLAGSHIP, 0, 0.0, 0.0),
            ("abn_src_f32", torch.float32, 0.1, (ABN_SRC[0], *ABN_CROP), 80,
             1e-4, 1e-6),
            ("abn_tgt_f32", torch.float32, 0.1, (ABN_TGT[0], *ABN_CROP), 80,
             1e-4, 1e-6),
            ("vgg_abn_src_f32", torch.float32, 0.1, VGG_ABN_ROWS, 80, 1e-4,
             1e-6)]


def check_kernels(ce, device):
    """Each of ``kernel_cases()`` through both kernels against their plain
    versions.  Tolerances are absolute.  The NLL of these logits reaches
    ~25, so 1e-4 is a few f32 ulps of it.  dx lies in [-1, 1]: 1e-6 covers
    f32 exp/division roundoff; in bf16 both sides round an f32 value that
    may differ in its last bits, so one bf16 ulp at 1 (2^-8) bounds the
    difference."""
    import torch

    results = []
    for name, dtype, frac, shape, pad, tol_f, tol_b in kernel_cases():
        x2, lbl, g = kernel_inputs(dtype, frac, device, shape, pad)
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
            results.append(dict(kernel=kern, case=name, rows=x2.shape[0],
                                max_abs_err=err, tol=tol))
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


def check_agreement(device, arch="deeplabv2_resnet101", label="agree",
                    card=None, **model_kw):
    """The SAC views step of ``arch`` (default a shallow full-width r101;
    ``model_kw`` go to ``build_model``) on a 40x48 input, 2 iterations on
    the CPU and on ``device`` from the same He-scaled weights and views:
    losses, running_conf, parameters and teacher within rtol 1e-3 / atol
    1e-5, pseudo-labels within 1%."""
    import torch

    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.nn.layers import Conv2d
    from dasac_tpu_torch.train import optim, steps

    if arch == "deeplabv2_resnet101" and not model_kw:
        model_kw = dict(layers=(1, 1, 1, 1))
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
    ref_model = build_model(arch, C, device="cpu", generator=gen, **model_kw)
    with torch.no_grad():   # He-scaled weights: confident, varied logits
        for m in ref_model.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    runs = {}
    for dev in ("cpu", device):
        model = build_model(arch, C, device="cpu", **model_kw)
        model.load_state_dict(ref_model.state_dict())
        opt = optim.build_optimizer(_ModelCfg, arch, model)
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
    log("%s: %s card vs CPU views step, 2 iterations: losses, running_conf, "
        "params and teacher within rtol 1e-3 / atol 1e-5; pseudo-label "
        "mismatch %.5f (< 0.01); %s" % (label, arch, worst, card))


# ---------------------------------------------------------------------------
# phase 4: the flagship slice
# ---------------------------------------------------------------------------

SAC_GROUPS, SAC_GROUP_SIZE = 2, 4


def sac_step_config():
    """The flagship SAC step's config (``bench.py:110-116``)."""
    from dasac_tpu_torch.train import steps

    return steps.StepConfig(
        num_classes=C, crop_hw=FLAGSHIP[1:], group_size=SAC_GROUP_SIZE,
        lr_target=5.0, net_momentum_iter=2, zoom=(0.5, 1.0),
        guided_hflip=True, tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2,
        src_scale=(0.5, 1.0), refine_dtype="bfloat16", refine_res="stride8",
        ce_impl="kernel")


def flagship_state(device, seed=SEED):
    """Full-width, full-depth ``deeplabv2_resnet101`` in bf16 with random
    weights from ``seed``, its SGD and train state."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim

    model = build_model("deeplabv2_resnet101", C, dtype=torch.bfloat16,
                        remat="none", device=device,
                        generator=torch.Generator().manual_seed(seed))
    opt = optim.build_optimizer(_ModelCfg, "deeplabv2_resnet101", model)
    return create_train_state(model, opt, C, device=device)


def sac_batch(device):
    """uint8 noise at the flagship shape: 8 source frames and 2 target
    frames at 512x1024."""
    import torch

    b, h, w = FLAGSHIP
    rng = np.random.RandomState(SEED)
    return tuple(torch.from_numpy(a).to(device) for a in (
        (rng.rand(b, h, w, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (b, h, w)).astype(np.uint8),
        (rng.rand(SAC_GROUPS, h, w, 3) * 255).astype(np.uint8),
        rng.randint(0, C, (SAC_GROUPS, h, w)).astype(np.uint8)))


def reset_counts(ce, ce_triton):
    for counts in (ce.LAUNCHES, ce_triton.LAUNCHES):
        for k in counts:
            counts[k] = 0
    for by_path in ce.PATH_LAUNCHES.values():
        for p in by_path:
            by_path[p] = 0


def read_counts(ce, ce_triton, want):
    """The launch counts since ``reset_counts``; fails unless they are
    ``want`` (kernel -> launches), every one on the bulk path, and no
    Triton launch."""
    launches = dict(ce.LAUNCHES)
    paths = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    triton_launches = dict(ce_triton.LAUNCHES)
    need(launches == want, "CE launches %s, want %s" % (launches, want))
    need(paths == {k: {"bulk": v, "strided": 0} for k, v in want.items()},
         "CE launches by path %s: want all on the bulk path" % paths)
    need(not any(triton_launches.values()),
         "the Triton yardstick ran on the main path: %s" % triton_launches)
    return launches, paths, triton_launches


def run_slice(ce, ce_triton, device, card):
    import torch

    from dasac_tpu_torch.train import steps

    torch.backends.cudnn.benchmark = True
    b, h, w = FLAGSHIP
    groups, group_size = SAC_GROUPS, SAC_GROUP_SIZE
    state = flagship_state(device)
    model = state.model
    step = steps.make_sac_step(sac_step_config(), device=device)
    batch = sac_batch(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(ce, ce_triton)
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
    launches, paths, triton_launches = read_counts(
        ce, ce_triton, {"nll_fwd": 2 * N_STEPS, "nll_bwd": 2 * N_STEPS})
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
    return launches, paths, triton_launches, out["step_ms_median"]


# kernel-name fragments -> the part of the step they belong to
_GROUPS = (("ce_kernels", ("nll_fwd", "nll_bwd")),
           ("convolution", ("conv", "xmma", "implicit", "fprop", "dgrad",
                            "wgrad", "cudnn", "winograd")),
           ("matmul", ("gemm", "cutlass", "cublas")),
           ("copy_layout", ("copy", "transpose", "permute", "cat")),
           ("reduction", ("reduce", "softmax", "norm", "sum", "max", "argm")),
           ("elementwise", ("elementwise", "vectorized", "where", "fill")))


def profile_steps(step, state, batch, gen, card, n=2, label="profile"):
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
    log("%s: %s" % (label, json.dumps(dict(
        card=card, steps=n, wall_ms_per_step=wall / n,
        device_ms_per_step=total / n, busy_share=total / wall,
        by_part_ms_per_step=groups,
        top=[dict(name=k[:90], ms_per_step=ms / n, calls_per_step=c / n)
             for k, ms, c in rows[:25]],
        # the CE kernels inside the step, device time of one launch
        ce_kernels=[dict(name=k[:90], ms_per_launch=ms / c,
                         calls_per_step=c / n)
                    for k, ms, c in rows
                    if any(f in k for f in _GROUPS[0][1])]))))


# ---------------------------------------------------------------------------
# phase 5: the ABN step, card against CPU on a small input
# ---------------------------------------------------------------------------

def check_abn_agreement(device, card=None):
    """``make_abn_frames_step`` on a shallow full-width r101 in f32 at 64x64
    (2 source + 2 target frames), 2 iterations on the CPU and on
    ``device`` from the same weights.  Tolerances: losses rtol 1e-3 /
    atol 1e-5, BN running statistics and parameters after the 2 steps
    rtol 1e-3 / atol 1e-5 (tests/test_torch_abn.py holds the CPU side to
    ``dasac_tpu`` at that size and learning rate); step counters equal;
    the teacher tensors unchanged bit for bit."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    h, w = 64, 64
    scfg = steps.StepConfig(num_classes=C, crop_hw=(h, w), ce_impl="kernel")
    rng = np.random.RandomState(SEED)
    frames = []
    for _ in range(2):
        src_y = rng.randint(0, C, (2, h, w)).astype(np.int32)
        src_y[:, -6:] = IGNORE
        tgt_y = rng.randint(0, C, (2, h, w)).astype(np.int32)
        tgt_y[:, :4] = IGNORE
        frames.append(tuple(torch.from_numpy(a) for a in (
            rng.randn(2, h, w, 3).astype(np.float32), src_y,
            (rng.randn(2, h, w, 3) * 0.8 + 0.2).astype(np.float32), tgt_y)))
    ref_sd = build_model("deeplabv2_resnet101", C, device="cpu",
                         layers=(1, 1, 1, 1),
                         generator=torch.Generator().manual_seed(SEED)
                         ).state_dict()
    runs = {}
    for dev in ("cpu", device):
        model = build_model("deeplabv2_resnet101", C, device="cpu",
                            layers=(1, 1, 1, 1))
        model.load_state_dict(ref_sd)
        opt = optim.build_optimizer(_ModelCfg, "deeplabv2_resnet101", model)
        state = create_train_state(model, opt, C, device=dev)
        teacher0 = {k: v.clone() for k, v in state.teacher_params.items()}
        step = steps.make_abn_frames_step(scfg)
        mets = [step(state, *(a.to(dev) for a in f)) for f in frames]
        need(all(torch.equal(v, teacher0[k])
                 for k, v in state.teacher_params.items()),
             "abn_agree: the teacher moved on %s" % dev)
        runs[dev] = (state.model.state_dict(),
                     [{k: float(v) for k, v in m.items()} for m in mets])
    (sd_ref, m_ref), (sd_dev, m_dev) = runs["cpu"], runs[device]
    for it, (a, b) in enumerate(zip(m_ref, m_dev)):
        for k in a:
            need(math.isclose(b[k], a[k], rel_tol=1e-3, abs_tol=1e-5),
                 "abn_agree iter %d %s: %r vs %r" % (it, k, b[k], a[k]))
    worst = 0.0
    for k, v in sd_dev.items():
        if v.is_floating_point():
            torch.testing.assert_close(v.cpu(), sd_ref[k], rtol=1e-3,
                                       atol=1e-5, msg=k)
            worst = max(worst, (v.cpu() - sd_ref[k]).abs().max().item())
        else:
            need(torch.equal(v.cpu(), sd_ref[k]), k)
    out = dict(phase="abn_agree", card=card, iterations=2, hw=[h, w],
               losses_cpu=m_ref, losses_card=m_dev,
               max_abs_diff_params_and_stats=worst)
    log("abn_agree: %s" % json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 6: the flagship ABN step
# ---------------------------------------------------------------------------

def abn_batch(device, src=ABN_SRC, tgt=ABN_TGT):
    """uint8 frames from ``RandomState(SEED)``, labels 0..18 with about 10%
    ignored: ``src`` and ``tgt`` are (frames, H, W)."""
    import torch

    rng = np.random.RandomState(SEED)
    out = []
    for b, h, w in (src, tgt):
        lbl = rng.randint(0, C, (b, h, w)).astype(np.uint8)
        lbl[rng.rand(b, h, w) < 0.1] = IGNORE
        out += [rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8), lbl]
    return tuple(torch.from_numpy(a).to(device) for a in out)


def run_abn(ce, ce_triton, device, card):
    """8 ABN steps (2 warm-up) on the flagship model, then 2 more under the
    profiler.  Returns the state, the launch counts of the 8 steps (CUDA
    by kernel, CUDA by path, Triton by kernel) and the step median."""
    import torch

    from dasac_tpu_torch.train import steps

    scfg = abn_step_config()
    state = flagship_state(device)
    model = state.model
    step = steps.make_abn_step(scfg, device=device)
    batch = abn_batch(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    teacher0 = {k: v.clone() for k, v in {**state.teacher_params,
                                          **state.teacher_stats}.items()}
    stats0 = {k: v.clone() for k, v in model.named_buffers()
              if k.endswith("running_mean")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(ce, ce_triton)
    times, rows = [], []
    for i in range(N_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        row = {k: float(v) for k, v in m.items()}
        for k, v in row.items():
            need(math.isfinite(v), "abn step %d: %s = %r" % (i, k, v))
        rows.append(row)
        log("abn step %d: %.1f ms %s" % (i, times[-1], json.dumps(row)))
    launches, paths, triton_launches = read_counts(
        ce, ce_triton, {"nll_fwd": 2 * N_STEPS, "nll_bwd": N_STEPS})
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(v, stats0[k]) for k, v in
                model.named_buffers() if k in stats0)
    need(moved == len(stats0), "BN running means moved in %d of %d layers"
         % (moved, len(stats0)))
    need(all(torch.equal(v, teacher0[k]) for k, v in
             {**state.teacher_params, **state.teacher_stats}.items()),
         "the ABN step moved the teacher")
    need(not state.running_conf.any() and state.slow_init == 0,
         "the ABN step touched running_conf or slow_init")
    tracked = {int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    need(tracked == {2 * N_STEPS}, "num_batches_tracked %s" % tracked)
    nonfinite = [k for k, p in model.named_parameters()
                 if not torch.isfinite(p).all()]
    need(not nonfinite, "non-finite params: %s" % nonfinite[:4])
    out = dict(
        phase="abn", card=card, steps=N_STEPS, warmup=WARMUP_STEPS,
        step_ms=times, step_ms_median=statistics.median(times[WARMUP_STEPS:]),
        max_memory_allocated=peak, losses=rows, ce_launches=launches,
        ce_launches_by_path=paths, bn_layers_moved=moved,
        batch=dict(source=list(ABN_SRC), target=list(ABN_TGT),
                   crop=list(scfg.crop_hw), scale=list(scfg.src_scale)))
    log("abn: %s" % json.dumps(out))
    profile_steps(step, state, batch, gen, card, label="abn_profile")
    log("abn_augment: %s" % json.dumps(dict(
        card=card, augment_ms=augment_ms(scfg, batch, gen))))
    return state, launches, paths, triton_launches, out["step_ms_median"]


def augment_ms(scfg, batch, gen):
    """Host time of the ABN step's augmentation alone (``augment_abn``, the
    function the step calls), median of 3 after a warm-up."""
    from dasac_tpu_torch.train import steps

    return median_ms(lambda: steps.augment_abn(scfg, gen, batch))[0]


def run_abn_lr_witness(device, card, scales=(1.0, 0.1, 0.01, 0.001)):
    """The flagship ABN step at the recipe's learning rates scaled by each
    of ``scales``, every run from the same weights, frames and generator
    seed: ``N_STEPS`` steps each, and the losses of every step.  With
    random labels the best the model can do is the class prior (source CE
    about ln 19 = 2.94); a correct gradient at a small enough step brings
    the loss down towards it.  Run by ``--abn-lr-witness`` only."""
    import torch

    from dasac_tpu_torch.train import steps

    scfg = abn_step_config()
    batch = abn_batch(device)
    runs = []
    for s in scales:
        state = flagship_state(device)
        for group in state.optimizer.param_groups:
            group["lr"] *= s
        step = steps.make_abn_step(scfg, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        rows = []
        for i in range(N_STEPS):
            rows.append({k: float(v) for k, v in
                         step(state, batch, gen).items()})
            need(all(math.isfinite(v) for v in rows[-1].values()),
                 "lr x%g step %d: %s" % (s, i, rows[-1]))
        runs.append(dict(lr_scale=s, lrs=[g["lr"] for g in
                                          state.optimizer.param_groups],
                         losses=rows))
        log("abn_lr_witness lr x%g: src_loss_ce %s" % (
            s, " ".join("%.3f" % r["src_loss_ce"] for r in rows)))
        del state, step
        torch.cuda.empty_cache()
    out = dict(phase="abn_lr_witness", card=card, steps=N_STEPS, runs=runs)
    log("abn_lr_witness: %s" % json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 7: ABN -> SAC through a snapshot
# ---------------------------------------------------------------------------

def run_handoff(ce, ce_triton, abn_state, device, card):
    """Save the ABN state with the port's Checkpointer (inside the
    checkout's ``build/``), load it into a fresh flagship SAC state, run 2
    SAC steps from it.  Returns the SAC state."""
    import shutil

    import torch

    from dasac_tpu_torch.train import checkpoints, steps

    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke_handoff")
    try:
        ck = checkpoints.Checkpointer(ckpt_dir)
        t0 = time.perf_counter()
        path = ck.save_latest(abn_state, 0.0, 0)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        state = flagship_state(device, seed=SEED + 1)
        t0 = time.perf_counter()
        _, epoch, _ = ck.load(path, state)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    need(state.slow_init == 0, "slow_init %r after an ABN snapshot"
         % state.slow_init)
    params = list(state.model.parameters())
    need(all("momentum_buffer" in state.optimizer.state[p] for p in params),
         "momentum missing after the load")
    for (k, a), b in zip(state.model.state_dict().items(),
                         abn_state.model.state_dict().values()):
        need(torch.equal(a, b), "student %s differs from the snapshot" % k)

    step = steps.make_sac_step(sac_step_config(), device=device)
    batch = sac_batch(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    reset_counts(ce, ce_triton)
    rows = []
    for i in range(2):
        m = step(state, batch, gen)
        row = {k: float(m[k]) for k in ("src_loss_ce", "self_ce",
                                        "teacher_diff", "pseudo_cover")}
        for k, v in row.items():
            need(math.isfinite(v), "handoff step %d: %s = %r" % (i, k, v))
        rows.append(row)
    torch.cuda.synchronize()
    launches, paths, _ = read_counts(ce, ce_triton,
                                     {"nll_fwd": 4, "nll_bwd": 4})
    need(state.slow_init == 1, "the first SAC step did not init the teacher")
    out = dict(phase="handoff", card=card, snapshot_bytes=size,
               save_s=save_s, load_s=load_s, epoch=epoch, sac_steps=rows,
               ce_launches=launches, ce_launches_by_path=paths)
    log("handoff: %s" % json.dumps(out))
    return state


# ---------------------------------------------------------------------------
# phases 8 and 9: evaluation and inference at full width
# ---------------------------------------------------------------------------

def median_ms(fn, n=3):
    """One warm-up call, then ``n`` calls, each timed on the host (ending in
    a synchronize) and on the device (CUDA events around it).  Returns the
    median host ms, the warm-up call's output, and every call's
    ``{"host_ms": [...], "device_ms": [...]}``: a device time well below
    the host time means the host held the card back."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = {"host_ms": [], "device_ms": []}
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times["host_ms"].append((time.perf_counter() - t0) * 1e3)
        times["device_ms"].append(start.elapsed_time(end))
    return statistics.median(times["host_ms"]), out, times


def run_eval(state, device, card):
    """Student and teacher eval on 4 frames (the val batch, BATCH_SIZE //
    2), the four-layer target eval on 2 groups of 4 views and the visual
    step on 1 group, all at 512x1024."""
    import torch

    from dasac_tpu_torch.train import steps

    scfg = sac_step_config()
    _, h, w = FLAGSHIP
    rng = np.random.RandomState(SEED + 2)
    images = torch.from_numpy(
        rng.randint(0, 256, (4, h, w, 3), dtype=np.uint8)).to(device)
    lbl = rng.randint(0, C, (4, h, w)).astype(np.uint8)
    lbl[rng.rand(4, h, w) < 0.1] = IGNORE
    labels = torch.from_numpy(lbl).to(device)
    n_valid = int((labels != IGNORE).sum())
    out = dict(phase="eval", card=card, hw=[h, w])
    for who in ("student", "teacher"):
        fn = steps.make_eval_step(scfg, device=device,
                                  teacher=who == "teacher")
        ms, conf, out["times_%s" % who] = median_ms(
            lambda: fn(state, images, labels))
        need(conf.shape == (C, C) and int(conf.sum()) == n_valid,
             "eval %s: confusion sums to %d, want %d"
             % (who, int(conf.sum()), n_valid))
        out["eval_%s_ms" % who] = ms

    tgt_images, tgt_labels = sac_batch(device)[2:]
    fn = steps.make_target_eval_step(scfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    gen_state = gen.get_state()
    confs = fn(state, tgt_images, tgt_labels, gen)
    # the same views again, to count their labelled pixels
    views = steps.augment_target(scfg, gen.set_state(gen_state),
                                  tgt_images, tgt_labels)
    n_views = int((views.labels != IGNORE).sum())
    need(set(confs) == {"logits_up", "teacher_init", "teacher_refined",
                        "teacher_labels"}, "target eval layers %s" % list(confs))
    sums = {k: int(v.sum()) for k, v in confs.items()}
    need(all(sums[k] == n_views for k in ("logits_up", "teacher_init",
                                          "teacher_refined")),
         "target eval sums %s, want %d" % (sums, n_views))
    # unlabelled teacher pixels are not counted
    need(0 <= sums["teacher_labels"] <= n_views,
         "teacher_labels sums to %d of %d" % (sums["teacher_labels"],
                                             n_views))
    out["target_eval_ms"], _, out["times_target_eval"] = median_ms(
        lambda: fn(state, tgt_images, tgt_labels, gen))
    out["target_eval_sums"] = dict(sums, labelled_view_pixels=n_views)

    vis = steps.make_visual_step(scfg, device=device)
    out["visual_ms"], res, out["times_visual"] = median_ms(
        lambda: vis(state, tgt_images[:1], tgt_labels[:1], gen))
    views, refined, pseudo, up, diags = res
    need(tuple(refined.shape) == (SAC_GROUP_SIZE, h, w, C)
         and bool(torch.isfinite(refined).all())
         and set(diags) == {"teacher_aligned", "frames_aligned"},
         "visual step outputs")
    log("eval: %s" % json.dumps(out))
    return out


def run_infer(state, device, card):
    """``make_infer_fn`` on one 1024x2048 frame: (a) the reference protocol
    (one scale, full-resolution fusion, labels), held against the argmax of
    the probabilities program; (b) 3 scales with flip fused at stride 8."""
    import torch

    from dasac_tpu_torch.infer import engine

    cfg = abn_step_config()
    rng = np.random.RandomState(SEED + 3)
    image = torch.from_numpy(
        rng.randint(0, 256, (1, *INFER_HW, 3), dtype=np.uint8)).to(device)
    settings = {
        "single": dict(scales=(1.0,)),
        "multi_flip_stride8": dict(scales=(0.75, 1.0, 1.25), flip=True,
                                   fuse="stride8")}
    out = dict(phase="infer", card=card, hw=list(INFER_HW))
    for name, kw in settings.items():
        fn = engine.make_infer_fn(state.model, cfg.mean, cfg.std,
                                  output="argmax", device=device, **kw)
        ms, labels, times = median_ms(lambda: fn(image), n=5)
        need(labels.dtype == torch.uint8
             and tuple(labels.shape) == (1, *INFER_HW)
             and int(labels.max()) < C, "infer %s labels" % name)
        out[name] = dict(ms_per_image=ms, images_per_s=1e3 / ms, **times)
        if name == "single":
            probs = engine.make_infer_fn(state.model, cfg.mean, cfg.std,
                                         device=device, **kw)(image)
            # the two may differ only where softmax rounds the top two
            # logits to the same probability (argmax then takes the first)
            differ = probs.argmax(-1).to(torch.uint8) != labels
            top2 = probs[differ].topk(2, dim=-1).values
            need(bool((top2[:, 0] == top2[:, 1]).all()),
                 "infer: the argmax program differs from the argmax of the "
                 "probabilities away from a tie")
            out[name]["argmax_vs_probs_mismatch"] = int(differ.sum())
            del probs, differ
    log("infer: %s" % json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the training program, from files on disk
# ---------------------------------------------------------------------------

# frames of the synthetic root: GTA-sized source, Cityscapes-sized target
# and val (every val split), labels 0..18 with ~10% ignored
TRAIN_SRC = (24, 1052, 1914)
TRAIN_TGT = (8, 1024, 2048)
TRAIN_VAL = (4, 1024, 2048)
TRAIN_IGNORE = 0.1
TRAIN_CFG = {"abn": "configs/deeplabv2_resnet101.yaml",
             "sac": "configs/deeplabv2_resnet101_train.yaml"}
TRAIN_SETS = []  # extra --set pairs after the stage's own (none here)


def write_train_root(root, card):
    """The synthetic root, written by the port's own PNG encoder (filter 0);
    then the decode time of one of its Cityscapes-sized frames."""
    from dasac_tpu_torch.data import lists, png, synth

    t0 = time.perf_counter()
    synth.make_synthetic_root(
        root, n_train_src=TRAIN_SRC[0], n_train_tgt=TRAIN_TGT[0],
        n_val=TRAIN_VAL[0], src_hw=TRAIN_SRC[1:], tgt_hw=TRAIN_TGT[1:],
        val_hw=TRAIN_VAL[1:], ignore_frac=TRAIN_IGNORE, seed=SEED)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
    images, _ = lists.read_split(root, "val_cityscapes")
    t0 = time.perf_counter()
    frame = png.to_rgb(png.read(images[0]))
    decode_ms = (time.perf_counter() - t0) * 1e3
    out = dict(phase="train_root", card=card, root_write_s=write_s,
               root_bytes=nbytes, frames=dict(source=list(TRAIN_SRC),
                                              target=list(TRAIN_TGT),
                                              val=list(TRAIN_VAL)),
               ignore_frac=TRAIN_IGNORE, host_cpus=os.cpu_count(),
               decode_ms_filter0=decode_ms, frame_hw=list(frame.shape[:2]))
    log("train_root: %s" % json.dumps(out))
    return out


class _TimedLoader:
    """A loader whose every ``next`` is timed into ``waits`` (seconds)."""

    def __init__(self, loader, waits):
        self.loader, self.waits = loader, waits

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield item


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device, into):
    """``fn`` with the host ms of each call (ending in a synchronize)
    appended to ``into``."""
    def call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        _sync(device)
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    return call


def measured_trainer(probe, check_resume=None):
    """A subclass of the port's ``Trainer`` that measures it from outside:
    each ``train_step`` call (host time in the call, and on the card a CUDA
    event before and after it), each wait on the train and val loaders,
    each validation with its eval calls and its panel writes, and each
    snapshot write.  ``check_resume(trainer)`` runs once the trainer is
    built."""
    import torch

    from dasac_tpu_torch.train import loop

    class MeasuredTrainer(loop.Trainer):
        def __init__(self, *a, **k):
            t0 = time.perf_counter()
            super().__init__(*a, **k)
            probe["setup_s"] = time.perf_counter() - t0
            probe["start_epoch"] = self.start_epoch
            if check_resume is not None:
                check_resume(self)
            step = self.train_step

            def timed_step(state, batch, gen):
                cuda = self.device.type == "cuda"
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2 if cuda else 0)]
                t0 = time.perf_counter()
                if cuda:
                    events[0].record()
                out = step(state, batch, gen)
                if cuda:
                    events[1].record()
                    probe["events"].append(events)
                probe["host_ms"].append((time.perf_counter() - t0) * 1e3)
                return out

            self.train_step = timed_step
            train_loaders = self.loaders.train_loaders

            def timed_loaders(epoch, replicated_eval=False):
                src, tgt = train_loaders(epoch, replicated_eval)
                if replicated_eval:   # target validation
                    return src, _TimedLoader(tgt, probe["val_wait"])
                probe["epoch_starts"].append(len(probe["host_ms"]))
                return (_TimedLoader(src, probe["wait_src"]),
                        _TimedLoader(tgt, probe["wait_tgt"]))

            self.loaders.train_loaders = timed_loaders
            val_loader = self.loaders.val_loader
            self.loaders.val_loader = lambda *a, **k: _TimedLoader(
                val_loader(*a, **k), probe["val_wait"])
            for name in ("eval_step", "target_eval_step", "visual_step"):
                setattr(self, name, _timed(getattr(self, name), self.device,
                                           probe["val_eval"]))
            for w in (self.writer, self.writer_target,
                      *self.writer_val.values()):
                w.add_image = _timed(w.add_image, self.device,
                                     probe["val_panel"])
            ck = self.checkpointer
            for name in ("save", "save_latest"):
                fn = getattr(ck, name)

                def timed(*a, _fn=fn, **k):
                    t0 = time.perf_counter()
                    out = _fn(*a, **k)
                    probe["save_ms"].append((time.perf_counter() - t0) * 1e3)
                    return out

                setattr(ck, name, timed)

        def validation(self, epoch, split, max_batches=None,
                       target_mode=False):
            for k in ("val_wait", "val_eval", "val_panel"):
                probe[k].clear()
            t0 = time.perf_counter()
            out = super().validation(epoch, split, max_batches, target_mode)
            _sync(self.device)
            key = ("target:" if target_mode else "") + split
            probe["val_ms"][key] = dict(
                total=(time.perf_counter() - t0) * 1e3,
                loader_wait=sum(probe["val_wait"]) * 1e3,
                eval_calls=list(probe["val_eval"]),
                panel_writes=list(probe["val_panel"]))
            return out

    return MeasuredTrainer


def _step_times(probe):
    """(step ms, loader-wait ms) per step.  On the card a step's time is the
    CUDA-event time from the event recorded as the host entered
    ``train_step`` to the one recorded as it left: the device reaches the
    first when it is done with the step before (or at once, when it was
    idle), so this is the step's share of the device's timeline, with any
    time the device waited for the host's enqueue.  On the CPU it is the
    host time in the call."""
    if probe["events"]:
        steps = [a.elapsed_time(b) for a, b in probe["events"]]
    else:
        steps = list(probe["host_ms"])
    waits = [(a + b) * 1e3 for a, b in zip(probe["wait_src"],
                                          probe["wait_tgt"])]
    need(len(steps) == len(waits), "%d steps, %d loader waits"
         % (len(steps), len(waits)))
    return steps, waits


def _events(logdir):
    """{writer: {tag: [(step, value)]}} from the run's events.jsonl files."""
    out = {}
    for d, _, files in os.walk(logdir):
        if "events.jsonl" in files:
            tags = out.setdefault(os.path.basename(d), {})
            with open(os.path.join(d, "events.jsonl")) as f:
                for line in f:
                    rec = json.loads(line)
                    tags.setdefault(rec["tag"], []).append(
                        (rec["step"], rec["value"]))
    return out


def run_train_stage(ce, ce_triton, stage, argv, want_start, want_steps,
                    device, card, bare_ms=None, check_resume=None):
    """One ``cli.main`` run, measured from outside the trainer; checks its
    losses, CE launches, events, snapshots and start epoch."""
    import torch

    from dasac_tpu_torch.train import cli, loop

    probe = dict(events=[], host_ms=[], wait_src=[], wait_tgt=[], val_ms={},
                 save_ms=[], val_wait=[], val_eval=[], val_panel=[],
                 epoch_starts=[])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(ce, ce_triton)
    original = loop.Trainer
    loop.Trainer = measured_trainer(probe, check_resume)
    fresh_cudnn()
    t0 = time.perf_counter()
    try:
        trainer = cli.main(argv, device=None if device.type == "cuda"
                           else device)
    finally:
        loop.Trainer = original
    wall_s = time.perf_counter() - t0
    need(torch.backends.cudnn.benchmark == (device.type == "cuda"),
         "%s: the train CLI left cuDNN autotuning off" % stage)
    if device.type == "cuda":
        torch.cuda.synchronize()
    baseline = trainer.cfg.MODEL.BASELINE
    n_steps = len(probe["host_ms"])
    need(probe["start_epoch"] == want_start,
         "%s: started at epoch %d, want %d" % (stage, probe["start_epoch"],
                                              want_start))
    need(n_steps == want_steps, "%s: %d steps, want %d" % (stage, n_steps,
                                                          want_steps))
    per_step = ({"nll_fwd": 2, "nll_bwd": 1} if baseline
                else {"nll_fwd": 2, "nll_bwd": 2})
    launches, paths, triton_launches = read_counts(
        ce, ce_triton, {k: v * n_steps for k, v in per_step.items()})
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)

    logdir, snapdir = trainer.args.logdir, trainer.args.snapshot_dir
    events = _events(logdir)
    losses = {t: v for t, v in events.get("train", {}).items()
              if t.startswith("train_epoch/")}
    loss_keys = (("train_epoch/src_loss_ce", "train_epoch/loss_ce")
                 if baseline else ("train_epoch/src_loss_ce",
                                   "train_epoch/self_ce"))
    for t in loss_keys:
        need(t in losses, "%s: no %s scalar" % (stage, t))
    need(all(math.isfinite(v) for vals in losses.values() for _, v in vals),
         "%s: non-finite epoch losses %s" % (stage, losses))
    validated = any(probe["val_ms"])
    if validated:
        for split in trainer.loaders.val:
            need("logits_up_all/mIoU" in events.get(split, {}),
                 "%s: no mIoU for %s" % (stage, split))
        layers = ("logits_up",) if baseline else (
            "logits_up", "teacher_init", "teacher_refined", "teacher_labels")
        for layer in layers:
            need(layer + "_all/mIoU" in events.get("train_target", {}),
                 "%s: no train-target %s mIoU" % (stage, layer))
        need(any(f.startswith("epoch") and f.endswith(".pth")
                 for f in os.listdir(snapdir)), "%s: no best snapshot" % stage)
    need(os.path.isfile(os.path.join(snapdir, "last.pth")),
         "%s: no last.pth" % stage)

    steps, waits = _step_times(probe)
    # an epoch's first step follows the loader's start (and validation):
    # the steady steps are the others
    steady = [t for k, t in enumerate(steps)
              if k not in probe["epoch_starts"]]
    out = dict(
        phase="train", stage=stage, card=card, argv=argv, wall_s=wall_s,
        setup_s=probe["setup_s"], start_epoch=probe["start_epoch"],
        steps=n_steps, step_ms=steps, loader_wait_ms=waits,
        host_ms_in_step=probe["host_ms"], epoch_first_steps=sorted(set(
            probe["epoch_starts"])),
        step_ms_median=statistics.median(steps[1:]),
        steady_step_ms_median=statistics.median(steady),
        loader_wait_ms_median=statistics.median(waits[1:]),
        bare_step_ms_median=bare_ms, val_ms=probe["val_ms"],
        snapshot_save_ms=probe["save_ms"], max_memory_allocated=peak,
        epoch_losses={t: v for t, v in losses.items()
                      if not t.startswith("train_epoch/self_ce_class")},
        miou={w: tags["logits_up_all/mIoU"] for w, tags in events.items()
              if "logits_up_all/mIoU" in tags},
        ce_launches=launches, ce_launches_by_path=paths,
        triton_launches=triton_launches)
    log("train %s: %s" % (stage, json.dumps(out)))
    return trainer, out


def run_train(ce, ce_triton, device, card, bare_ms=None):
    """Phase 10: the trainer CLI on a synthetic root of real frame sizes;
    ABN (2 epochs x 2 steps, one validation round), SAC from the ABN
    snapshot (epochs 2 and 3, 3 steps each, one validation round), and
    ``--resume auto`` of the SAC run (epoch 4).  Returns the CE launches of
    each stage."""
    import shutil

    import torch

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_train")
    root = os.path.join(base, "root")
    shutil.rmtree(base, ignore_errors=True)
    bare_ms = bare_ms or {}
    try:
        write_train_root(root, card)
        common = ["--snapshot-dir", os.path.join(base, "snap"), "--logdir",
                  os.path.join(base, "logs"), "--exp", "smoke"]
        sets = ["DATASET.ROOT", root, "TPU.CE_IMPL", "pallas",
                "LOG.ITER_VAL", "1", "LOG.ITER_TARGET", "1"]
        stages = {}
        abn, stages["abn"] = run_train_stage(
            ce, ce_triton, "abn",
            ["--cfg", TRAIN_CFG["abn"], *common, "--run", "abn", "--set",
             *sets, "MODEL.BASELINE", "True", "TRAIN.NUM_EPOCHS", "1",
             *TRAIN_SETS], 0, 4, device, card, bare_ms.get("abn"))
        abn_last = os.path.join(abn.args.snapshot_dir, "last.pth")
        del abn
        torch.cuda.empty_cache()
        sac, stages["sac"] = run_train_stage(
            ce, ce_triton, "sac",
            ["--cfg", TRAIN_CFG["sac"], *common, "--run", "sac",
             "--resume", abn_last, "--set", *sets, "TRAIN.NUM_EPOCHS", "3",
             *TRAIN_SETS], 2, 6, device, card, bare_ms.get("sac"))
        sac_last = os.path.join(sac.args.snapshot_dir, "last.pth")
        del sac
        torch.cuda.empty_cache()
        saved = torch.load(sac_last, map_location="cpu", weights_only=True)
        need(saved["epoch"] == 4, "the SAC run saved epoch %d, want 4"
             % saved["epoch"])

        def check_resume(trainer):
            """The resumed state is the saved one: parameters, statistics,
            teacher, running_conf and SGD momentum."""
            state = trainer.state
            for k, v in state.model.state_dict().items():
                need(torch.equal(v.cpu(), saved["model"][
                    "module.backbone." + k]), "resume: student %s" % k)
            for k, v in {**state.teacher_params,
                         **state.teacher_stats}.items():
                need(torch.equal(v.cpu(), saved["model"][
                    "module.slow_net." + k]), "resume: teacher %s" % k)
            need(torch.equal(state.running_conf.cpu(),
                             saved["model"]["module.running_conf"]),
                 "resume: running_conf")
            opt = state.optimizer
            params = [p for g in opt.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                need(torch.equal(opt.state[p]["momentum_buffer"].cpu(),
                                 saved["opt"]["state"][i]["momentum_buffer"]),
                     "resume: momentum of parameter %d" % i)

        resumed, stages["resume"] = run_train_stage(
            ce, ce_triton, "resume",
            ["--cfg", TRAIN_CFG["sac"], *common, "--run", "sac",
             "--resume", "auto", "--set", *sets, "TRAIN.NUM_EPOCHS", "4",
             *TRAIN_SETS], 4, 3, device, card, bare_ms.get("sac"),
            check_resume)
        del resumed, saved
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return stages


# ---------------------------------------------------------------------------
# phases 11 and 12: the VGG-16 family
# ---------------------------------------------------------------------------

VGG_ARCHS = ("deeplabv2_vgg16_bn", "fcn_vgg16_bn")
# (SAC config, ABN config) of each arch, as launch/train.sh pairs them
VGG_CFG = {"deeplabv2_vgg16_bn": ("configs/deeplabv2_vgg16_train.yaml",
                                  "configs/deeplabv2_vgg16.yaml"),
           "fcn_vgg16_bn": ("configs/fcn_vgg16_train.yaml",
                            "configs/fcn_vgg16.yaml")}
VGG_ABN_STEPS = 6    # the first 2 are warm-up


def yaml_config(path):
    """The port's config from ``path`` over the defaults, with the CE
    kernels chosen (``TPU.CE_IMPL pallas``), and its step config."""
    from dasac_tpu_torch.core.config import (cfg, cfg_from_file,
                                             cfg_from_list, reset_cfg)
    from dasac_tpu_torch.train import steps

    reset_cfg()
    cfg_from_file(path)
    cfg_from_list(["TPU.CE_IMPL", "pallas"])
    return cfg, steps.step_config_from_cfg(cfg)


def check_vgg_agreement(device, card):
    """Phase 11: the SAC views step of each VGG arch, card against CPU
    (FCN8s without dropout: the two devices' generators differ)."""
    for arch in VGG_ARCHS:
        kw = {"drop_rate": 0.0} if arch == "fcn_vgg16_bn" else {}
        check_agreement(device, arch, label="vgg_agree", card=card, **kw)


def run_vgg(ce, ce_triton, device, card):
    """Phase 12: for each VGG arch at full width and depth in bf16, the SAC
    step of its ``_train.yaml`` (512x1024, 8 source frames + 2 groups of 4
    views, FCN8s with its dropout on) for ``N_STEPS`` steps, and the ABN
    step of its base YAML (640x640 crops from TRAIN.BATCH_SIZE source
    frames of 1052x1914 and TRAIN.NUM_GROUPS target frames of 1024x2048)
    for ``VGG_ABN_STEPS``; launch counts set to 0 before and read after
    each run (2 + 2 a SAC step, 2 + 1 an ABN step, all bulk), peak memory,
    then 2 steps of each under the profiler.  Returns {arch: {kind:
    launches}}."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    torch.backends.cudnn.benchmark = True
    launches = {}
    for arch in VGG_ARCHS:
        launches[arch] = {}
        for kind, path in zip(("sac", "abn"), VGG_CFG[arch]):
            cfg, scfg = yaml_config(path)
            need(cfg.MODEL.ARCH == arch, "%s is for %s" % (path,
                                                           cfg.MODEL.ARCH))
            model = build_model(arch, C, dtype=torch.bfloat16, device=device,
                                generator=torch.Generator().manual_seed(SEED))
            state = create_train_state(
                model, optim.build_optimizer(cfg.MODEL, arch, model), C,
                device=device)
            if kind == "sac":
                step = steps.make_sac_step(scfg, device=device)
                batch = sac_batch(device)
                n, per = N_STEPS, {"nll_fwd": 2, "nll_bwd": 2}
                shape = dict(source=FLAGSHIP[0], target_groups=SAC_GROUPS,
                             group_size=scfg.group_size,
                             hw=list(scfg.crop_hw))
            else:
                src = (cfg.TRAIN.BATCH_SIZE, *ABN_SRC[1:])
                tgt = (cfg.TRAIN.NUM_GROUPS, *ABN_TGT[1:])
                step = steps.make_abn_step(scfg, device=device)
                batch = abn_batch(device, src, tgt)
                n, per = VGG_ABN_STEPS, {"nll_fwd": 2, "nll_bwd": 1}
                shape = dict(source=list(src), target=list(tgt),
                             crop=list(scfg.crop_hw))
            gen = torch.Generator(device=device).manual_seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ce, ce_triton)
            times, rows = [], []
            for i in range(n):
                t0 = time.perf_counter()
                m = step(state, batch, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                row = {k: float(v) for k, v in m.items() if v.dim() == 0}
                for k, v in row.items():
                    need(math.isfinite(v), "vgg %s %s step %d: %s = %r"
                         % (arch, kind, i, k, v))
                rows.append(row)
            got, paths, _ = read_counts(ce, ce_triton,
                                        {k: v * n for k, v in per.items()})
            peak = torch.cuda.max_memory_allocated()
            nonfinite = [k for k, p in model.named_parameters()
                         if not torch.isfinite(p).all()]
            need(not nonfinite, "non-finite params: %s" % nonfinite[:4])
            launches[arch][kind] = got
            log("vgg: %s" % json.dumps(dict(
                phase="vgg", arch=arch, step=kind, config=path, card=card,
                steps=n, warmup=WARMUP_STEPS, step_ms=times,
                step_ms_median=statistics.median(times[WARMUP_STEPS:]),
                max_memory_allocated=peak, losses=rows, ce_launches=got,
                ce_launches_by_path=paths, batch=shape)))
            profile_steps(step, state, batch, gen, card,
                          label="vgg_profile %s %s" % (arch, kind))
            del state, model, step, batch
            torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 13: the inference program through its CLI, and the offline tools
# ---------------------------------------------------------------------------

INFER_FRAMES = 8     # Cityscapes-val frames of the synthetic root
INFER_CFG = "configs/deeplabv2_resnet101_train.yaml"
INFER_RUNS = {"single": ["--batch", "1"],
              "multi_flip_stride8": ["--scales", "0.75", "1.0", "1.25",
                                     "--flip", "--fuse", "stride8",
                                     "--batch", "2"]}


def write_cityscapes_val(root, card):
    """A Cityscapes-val layout of ``INFER_FRAMES`` frames at 1024x2048,
    written by the port's PNG encoder: ``leftImg8bit/val/<city>/``, the
    masks the split list names (trainIds, as the reference's converted
    ``gtFine2``) and ``gtFine/val/<city>/*_gtFine_labelIds.png``
    (Cityscapes labelIds, for the offline scorer); blocky labels with ~10%
    ignored, frames coloured by class plus noise."""
    from concurrent.futures import ThreadPoolExecutor

    from dasac_tpu_torch.data import png
    from dasac_tpu_torch.data.category import (color_table,
                                               trainid_to_cs_table)

    h, w = INFER_HW
    rng = np.random.RandomState(SEED + 4)
    t2c, colors = trainid_to_cs_table(), color_table()
    lines, jobs = [], []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for i in range(INFER_FRAMES):
            stem = "frankfurt_%06d_000019" % i
            lbl = np.repeat(np.repeat(rng.randint(0, C, (h // 64, w // 64)),
                                      64, 0), 64, 1).astype(np.uint8)
            lbl[rng.rand(h, w) < 0.1] = IGNORE
            img = np.clip(colors[lbl].astype(np.int16)
                          + rng.randint(-40, 41, (h, w, 3)), 0,
                          255).astype(np.uint8)
            files = {"leftImg8bit": (img, "_leftImg8bit"),
                     "gtFine2": (lbl, "_gtFine_labelIds"),
                     "gtFine": (t2c[lbl], "_gtFine_labelIds")}
            for d, (arr, suffix) in files.items():
                rel = "%s/val/frankfurt/%s%s.png" % (d, stem, suffix)
                os.makedirs(os.path.dirname(os.path.join(root, rel)),
                            exist_ok=True)
                jobs.append(pool.submit(png.write, os.path.join(root, rel),
                                        arr))
            lines.append("leftImg8bit/val/frankfurt/%s_leftImg8bit.png "
                         "gtFine2/val/frankfurt/%s_gtFine_labelIds.png"
                         % (stem, stem))
    for j in jobs:
        j.result()
    with open(os.path.join(root, "val_cityscapes.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("infer_root: %s" % json.dumps(dict(
        phase="infer_root", card=card, frames=INFER_FRAMES, hw=list(INFER_HW),
        write_s=time.perf_counter() - t0)))


def measured_inference(probe):
    """Patches of the inference engine that measure a run from outside:
    each wait on the loader and the host time of each loop body after it,
    the device time (CUDA events) and host time (to a synchronize) of each
    call of the inference program, and each export's time in its worker
    thread and the wait in ``close``.  Returns the function that undoes
    them."""
    import torch

    from dasac_tpu_torch.data import host_loader
    from dasac_tpu_torch.infer import engine

    orig = (host_loader.padded_plain_loader, engine.make_infer_fn,
            engine.ResultWriter)

    def loader(*a, **k):
        inner = orig[0](*a, **k)

        def batches():
            it = iter(inner)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                probe["wait_ms"].append((time.perf_counter() - t0) * 1e3)
                t1 = time.perf_counter()
                yield item
                probe["body_ms"].append((time.perf_counter() - t1) * 1e3)
        return batches()

    def make_infer_fn(*a, **k):
        fn = orig[1](*a, **k)

        def timed(images):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = fn(images)
            end.record()
            torch.cuda.synchronize()
            probe["infer_host_ms"].append((time.perf_counter() - t0) * 1e3)
            probe["device_ms"].append(start.elapsed_time(end))
            return out
        return timed

    class Writer(orig[2]):
        def _write(self, *a, **k):
            t0 = time.perf_counter()
            out = super()._write(*a, **k)
            probe["write_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        def close(self):
            t0 = time.perf_counter()
            super().close()
            probe["close_ms"] = (time.perf_counter() - t0) * 1e3

    host_loader.padded_plain_loader = loader
    engine.make_infer_fn = make_infer_fn
    engine.ResultWriter = Writer

    def undo():
        (host_loader.padded_plain_loader, engine.make_infer_fn,
         engine.ResultWriter) = orig
    return undo


def run_infer_cli(ce, ce_triton, snapshot, device, card):
    """Phase 13: ``dasac_tpu_torch.infer.cli.main`` in this process on the
    synthetic Cityscapes-val root with the SAC snapshot of phase 7, one
    scale at batch 1 and 3 scales + flip fused at stride 8 at batch 2;
    each run's exports checked (8 palette and 8 ``cs/`` PNGs), scored
    offline by ``tools.evaluate_miou`` (its confusion is the CLI's, its
    mIoU the CLI's to 1e-6), and the trainId exports turned into IS
    weights by ``tools.compute_is_weights`` and read back by the sampler.
    Prints each run's ms per frame by part: loader wait, inference
    program (device ms and host ms to its end), the rest of the loop body
    (the uint8 D2H copy, the confusion's enqueue, the submits), and the
    exports (worker-thread ms per frame, and the wait in ``close``)."""
    import glob
    import shutil

    import torch

    from dasac_tpu_torch.data import png, sampler
    from dasac_tpu_torch.infer import cli
    from dasac_tpu_torch.tools import compute_is_weights, evaluate_miou
    from dasac_tpu_torch.train.metrics import mean_iou

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_infer")
    root = os.path.join(base, "root")
    try:
        write_cityscapes_val(root, card)
        for name, flags in INFER_RUNS.items():
            out_dir = os.path.join(base, "out_" + name)
            probe = dict(wait_ms=[], body_ms=[], infer_host_ms=[],
                         device_ms=[], write_ms=[], close_ms=None)
            reset_counts(ce, ce_triton)
            undo = measured_inference(probe)
            fresh_cudnn()
            t0 = time.perf_counter()
            try:
                conf = cli.main(["--cfg", INFER_CFG, "--dataloader",
                                 "cityscapes", "--resume", snapshot,
                                 "--infer-list", "val_cityscapes",
                                 "--mask-output-dir", out_dir, "--set",
                                 "DATASET.ROOT", root, *flags])
            finally:
                undo()
            wall_ms = (time.perf_counter() - t0) * 1e3
            need(torch.backends.cudnn.benchmark,
                 "%s: the infer CLI left cuDNN autotuning off" % name)
            read_counts(ce, ce_triton, {"nll_fwd": 0, "nll_bwd": 0})
            n = INFER_FRAMES
            preds = sorted(glob.glob(os.path.join(out_dir, "*.png")))
            cs = sorted(glob.glob(os.path.join(out_dir, "cs", "*.png")))
            need(len(preds) == n and len(cs) == n,
                 "%s: %d trainId and %d cs exports" % (name, len(preds),
                                                      len(cs)))
            need(all(png.read(p).color_type == 3 for p in preds)
                 and all(png.read(p).color_type == 0 for p in cs),
                 "%s: export formats" % name)
            ev, matched = evaluate_miou.evaluate_dirs(
                os.path.join(out_dir, "cs"), os.path.join(root, "gtFine",
                                                          "val"))
            _, payload = evaluate_miou.format_report(ev)
            miou = mean_iou(conf)
            need(matched == n and np.array_equal(ev[:C, :C], conf)
                 and not ev[:, C].any() and not ev[C].any(),
                 "%s: evaluate_miou's confusion is not the CLI's" % name)
            need(abs(payload["mean_iou"] - miou) <= 1e-6,
                 "%s: evaluate_miou %r vs the CLI's %r"
                 % (name, payload["mean_iou"], miou))
            weights_path = os.path.join(base, "weights_%s.data" % name)
            weights = compute_is_weights.count(out_dir, out=weights_path,
                                               verbose=False)
            loaded = sampler.load_sample_weights(weights_path)
            need(loaded == weights and len(loaded) == n,
                 "%s: IS weights did not load back" % name)
            # the first batch (the loader's first wait, cuDNN autotuning at
            # a new shape) is set-up: the loop's figures a frame leave it
            # out, the exports' and the wall's keep every frame
            body_rest = [b - i for b, i in zip(probe["body_ms"],
                                               probe["infer_host_ms"])]
            steady = n - n // len(probe["device_ms"])
            per = {k: sum(probe[v][1:]) / steady for k, v in (
                ("loader_wait", "wait_ms"), ("device", "device_ms"),
                ("infer_host", "infer_host_ms"))}
            per.update(d2h_and_rest=sum(body_rest[1:]) / steady,
                       first_batch_device=probe["device_ms"][0],
                       writer_worker=sum(probe["write_ms"]) / n,
                       writer_close_wait=probe["close_ms"] / n,
                       wall=wall_ms / n)
            log("infer_cli: %s" % json.dumps(dict(
                phase="infer_cli", run=name, card=card, argv_flags=flags,
                frames=n, miou_cli=miou, miou_evaluate=payload["mean_iou"],
                ms_per_frame=per, batches=len(probe["device_ms"]),
                loader_wait_ms=probe["wait_ms"],
                infer_host_ms=probe["infer_host_ms"],
                device_ms=probe["device_ms"], body_rest_ms=body_rest,
                write_ms=probe["write_ms"], close_ms=probe["close_ms"],
                is_weights_images=len(loaded))))
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)


def save_infer_snapshot(state):
    """The SAC state as a reference-format snapshot for phase 13, under
    ``build/smoke_infer`` (removed by phase 13)."""
    from dasac_tpu_torch.train import checkpoints

    return checkpoints.Checkpointer(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "smoke_infer",
        "snap")).save_latest(state, 0.0, 0)


# ---------------------------------------------------------------------------
# phase 14: the serving benchmark
# ---------------------------------------------------------------------------

BENCH_RUNS = ([["--arch", a, "--batch", b] for a in ("deeplabv2_resnet101",
                                                     *VGG_ARCHS)
               for b in ("1", "4")]
              + [["--arch", "deeplabv2_resnet101", "--batch", "1",
                  "--scales", "0.75", "1.0", "1.25", "--flip", "--fuse",
                  "stride8"]])


def run_bench_infer(device):
    """``tools.bench_infer`` at 1024x2048 (its default), the on-device
    argmax (what ``run_inference`` runs): r101 and both VGG archs at batch
    1 and 4, and r101 with 3 scales + flip fused at stride 8."""
    import torch

    from dasac_tpu_torch.tools import bench_infer

    out = []
    for flags in BENCH_RUNS:
        fresh_cudnn()
        rec = bench_infer.main([*flags, "--output", "argmax"], device=device)
        need(rec["value"] > 0 and rec["cudnn_benchmark"]
             and rec["device"] == torch.cuda.get_device_name(0),
             "bench_infer %s" % flags)
        out.append(rec)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

def main(argv=()):
    import argparse

    import torch

    parser = argparse.ArgumentParser(
        description="On-card smoke of the PyTorch/CUDA port.")
    parser.add_argument(
        "--abn-lr-witness", action="store_true",
        help="instead of the phases, run the flagship ABN step for %d steps "
             "at 1, 0.1, 0.01 and 0.001 times the recipe's learning rates "
             "and print the losses" % N_STEPS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dasac_tpu_torch.core.device import card_name
    from dasac_tpu_torch.ops import ce, ce_triton

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")

    card = card_name()
    name = torch.cuda.get_device_name(0)
    log("card: %s" % card)
    log("torch: %s, cuda %s, %s x %d" % (torch.__version__, torch.version.cuda,
                                         name, torch.cuda.device_count()))
    if args.abn_lr_witness:
        torch.backends.cudnn.benchmark = True
        run_abn_lr_witness(device, card)
        return 0

    phase_s, lap_t = {}, [t_start]

    def lap(phase):
        """Seconds since the previous lap, kept for the summary line."""
        now = time.perf_counter()
        phase_s[phase] = now - lap_t[0]
        lap_t[0] = now

    ptxas = build_cuda(ce)
    paths_before = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    checks = check_kernels(ce, device)
    need(all(ce.PATH_LAUNCHES[k]["bulk"]
             == paths_before[k]["bulk"] + len(kernel_cases())
             for k in ce.PATH_LAUNCHES),
         "kernel checks off the bulk path: %s" % ce.PATH_LAUNCHES)
    triton_checks = check_kernels(ce_triton, device)
    timing = time_kernels(ce, ce_triton, device, name)
    torch.cuda.empty_cache()
    lap("kernels")
    check_agreement(device, card=card)
    lap("agree")
    launches, paths, triton_launches, sac_ms = run_slice(ce, ce_triton,
                                                         device, card)
    torch.cuda.empty_cache()
    lap("slice")
    check_abn_agreement(device, card)
    lap("abn_agree")
    abn_state, abn_launches, abn_paths, abn_triton, abn_ms = run_abn(
        ce, ce_triton, device, card)
    lap("abn")
    sac_state = run_handoff(ce, ce_triton, abn_state, device, card)
    del abn_state
    torch.cuda.empty_cache()
    lap("handoff")
    run_eval(sac_state, device, card)
    lap("eval")
    run_infer(sac_state, device, card)
    snapshot = save_infer_snapshot(sac_state)
    del sac_state
    torch.cuda.empty_cache()
    lap("infer")
    train = run_train(ce, ce_triton, device, card,
                      bare_ms={"sac": sac_ms, "abn": abn_ms})
    lap("train")
    check_vgg_agreement(device, card)
    lap("vgg_agree")
    vgg = run_vgg(ce, ce_triton, device, card)
    lap("vgg")
    run_infer_cli(ce, ce_triton, snapshot, device, card)
    lap("infer_cli")
    run_bench_infer(device)
    lap("bench_infer")

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
            row.update(launches_abn=(abn_launches if route == "cuda"
                                     else abn_triton)[k],
                       launches_by_path_abn=(abn_paths[k] if route == "cuda"
                                             else None))
            # the trainer CLI's three stages (phase 10)
            by_stage = {st: o["ce_launches" if route == "cuda"
                              else "triton_launches"][k]
                        for st, o in train.items()}
            row.update(launches_train=sum(by_stage.values()),
                       launches_train_by_stage=by_stage)
            # the VGG steps (phase 12), by arch and step
            row["launches_vgg"] = {
                arch: {kind: (got[k] if route == "cuda" else 0)
                       for kind, got in by_kind.items()}
                for arch, by_kind in vgg.items()}
            if route == "cuda":
                row.update(triton_ms=t["triton_ms"],
                           launches_by_path=paths[k],
                           ptxas=[r for r in ptxas if k + "_bulk_kernelILi19E"
                                  in r["kernel"]])
            kernels.append(row)
    log("phase_s: %s" % json.dumps(phase_s))
    log(json.dumps({"kernels": kernels}))
    log("card: %s; total %.1f s" % (card, time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
