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
              in turns with CUDA events at the SAC step's shape; then live
              BN's four kernels (``csrc/live_bn.cu``, bound in
              ``ops/live_bn.py``) at the r101 ABN step's bf16 shapes
              (layer3's bn3 with its residual, its bn1, the stem's BN):
              each against its plain version, the sums twice bit for bit,
              the sums of small integers equal to the plain version's (there
              and at 4551 rows), and each and its plain version timed in
              turns beside its bound, its bytes at the card's memory rate;
  3. agree    the SAC views step on a small input, on the card and on the
              CPU (plain kernels, held against ``dasac_tpu`` by the tests),
              2 iterations, same weights and views;
  4. slice    the flagship SAC step: ``make_sac_step`` on a full-width,
              full-depth ``deeplabv2_resnet101`` in bf16 at 512x1024, with
              8 source images and 2 target groups of 4 views, random
              weights and uint8 batches made from a seed.  The kernels'
              launch counts (by kernel and by path) are set to 0 just
              before and read just after: every launch on the bulk path,
              and no live-BN launch (its BN is frozen).
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
              all bulk; 6 live-BN launches a BN layer a step: ``sums`` and
              ``apply`` in the source and in the target forward,
              ``apply_bwd`` and ``sums_bwd`` in the backward, 624 for the
              104 layers), then 2 steps under the profiler;
  7. handoff  the ABN state saved with the port's Checkpointer and loaded
              into a fresh SAC state (teacher not initialized, momentum
              restored), then 2 flagship SAC steps from it;
  8. eval     student and teacher eval (4 frames), the four-layer target
              eval (2 groups of 4 views) and the visual step (1 group), at
              512x1024, with their confusions checked against the labelled
              pixel counts and each timed call's host and device ms;
  9. infer    ``make_infer_fn`` on one 1024x2048 frame: one scale with
              full-resolution fusion (held against the argmax of the
              probabilities), and 3 scales with flip fused at stride 8; no
              live-BN launch;
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
              scales + flip fused at stride 8, one JSON line each, with
              its FLOPs and bytes a step, ``mfu`` and ``hbm_util`` in (0,
              1.05];
 15. dataset  the dataset program from raw files, under
              ``build/smoke_dataset`` (removed after):
              ``make_domain_gap_root``'s scenes rewritten as a GTA5
              layout (24 train frames of 1052x1914 and 2 val frames, RGB,
              palette labels of raw GTA ids) and a Cityscapes layout (8
              train and 2 val frames of 1024x2048, gray labelIds), every frame and label with Paeth
              or Average rows in turn; ``convert_train_ids`` (gta, cs),
              ``make_split_lists`` (five splits), ``check_dataset`` (must
              report the root ready), ``pack_dataset`` (source and target
              train splits at their canonical sizes, two packed frames held
              against the Python decode, which is timed); the native
              decoder's ms a frame (one thread, and one batch call); then
              the train CLI from the packs with ``TPU.NATIVE_LOADER True``
              and ``DATASET.VAL_CROP True``: ABN (2 epochs of 2 steps, one
              validation round center-cropped through the C++ decoder),
              SAC from its ``last.pth`` (1 epoch of 3 steps), checked as
              in phase 10; every decode of the loader on the native route;
 16. ddp      data-parallel training (``core/dist.py``): (a) a NCCL world
              of one rank in this process: one flagship SAC and one ABN
              step with the group (every collective runs) and twice
              without, from the same state and augmented inputs, cuDNN
              deterministic: losses and every tensor of the state equal
              (max abs diff at most twice that between the two runs
              without a group, which is 0 when the step is
              deterministic), the collectives a step counted; then phase
              10's three CLI stages on phase 10's root, each a
              torchrun-style launch of one rank
              (``--multiprocessing-distributed``, the environment set
              here), measured and checked as in phase 10 (the trainer
              ran in the world, one event record a tag and epoch); (b)
              two spawned ranks sharing the card over gloo with CUDA
              tensors: per rank its half of the flagship SAC batch (4
              source frames, 1 group) and of the ABN batch (6 + 4
              frames), augmented with its own generator, one step each
              from the same state (held, bit-equal on both ranks, against
              a single-process emulation of the two ranks: SAC and an
              ABN step on a shallow r101 at the same batch within rtol
              1e-3 / atol 1e-5 and an update error under 5e-2, the
              full-depth ABN step on its forward, see ``DDP_KINDS``),
              then a second step timed; per rank step ms, peak memory,
              the gradient all-reduce's ms and bytes, the BN collectives
              a step, start and group set-up seconds;
 17. recipe   the three-stage recipe (``dasac_tpu_torch.tools.recipe``)
              in this process, r101 at full width, on a domain-gap
              corpus cut to 16 source frames of 1052x1914, 4 target
              frames and 2 frames a val split of 1024x2048, under
              ``build/smoke_recipe`` (removed after): ABN epochs 0-1 (2
              steps each), the gate reported and not enforced
              (``--gate-ce inf``: two epochs cannot converge), the mask
              export, the IS weights, SAC target-only with the weights and
              the control (epoch 2 each), the 8 evals; checked: the
              stages' records (also in the records file), 2 + 1 CE
              launches a step in ABN and the control and 1 + 1 in SAC, all
              bulk, none outside the train stages, the SAC stage's
              ``TARGET_ONLY`` (its logged source CE 0) and
              ``SAMPLE_WEIGHTS``, one mask per target frame, IS weights
              that ``ImportanceSampler`` reads with class densities moved
              from uniform for exactly the classes whose pixel share
              differs between the exported masks (none when the two-epoch
              ABN predicts one class everywhere), every mIoU finite in
              [0, 1];
 18. infer_mesh  inference over a world of ranks (``core/mesh.py``,
              ``nn/spatial.py``), the full-width, full-depth r101 with
              random weights from the seed: (a) a NCCL world of one rank
              in this process: ``run_inference`` over a synthetic
              Cityscapes-val root of 4 frames at 1024x2048 under
              ``build/smoke_infer_mesh`` (removed after) in bf16 with the
              world's group and with none (labels and confusion bit-equal,
              no row exchanged, no CE launch), then ``tools.bench_infer
              --mode batch`` and ``--mode spatial --sp 1`` in the world;
              (b) 4 spawned ranks sharing the card over gloo (CUDA tensors
              staged through host memory), no TF32: each pair of ranks
              splitting the height of its own 1024x2048 frame (the 2 x 2
              combined mesh, ``spatial=2``) and all 4 on one frame
              (``spatial=-1``), one scale fused at full resolution and 3
              scales + flip fused at stride 8, in f32 and bf16, and a
              1050x1914 frame edge-padded to 1052 rows over the 4 ranks
              (1052 tiles 2 and 4); uint8 frames from ``RandomState(0)``;
              each case run twice, the second timed; every case held
              against the unsharded forward in this process on the same
              frame (the padded canvas for the padded frame; its second
              call timed beside the ranks' ms): f32
              probabilities within 1e-4 and labels equal on >= 99.99% of
              pixels, bf16 labels on >= 99.9%; every rank exchanged rows.
              Per rank: ms per frame, exchanges and bytes a forward by
              layer kind, peak GB, the transport;
 19. remat_opt  remat (``TPU.REMAT``) and ``MODEL.OPT adam``, at full
              width and depth in bf16, random weights from the seed: (a)
              the flagship SAC step (phase 4's batch) under none, block
              and convs: the first step through the views step with its
              gradients (loss within rtol 1e-3 of none's, every
              parameter's gradient within a relative L2 error of 2e-2),
              then 8 steps timed (median of the last 6), peak GB, 2 + 2
              CE launches a step, all bulk, the same in every mode; (b)
              the ABN step under none and block, cuDNN deterministic: on
              the flagship model (phase 6's frames) the step's source
              half alone, with autotuning off, leaves block's BN buffers
              equal to none's, every ``num_batches_tracked`` at 1 (the
              replay updated nothing) and every gradient within a
              relative L2 error of 2e-2 of none's (``remat_drift`` first
              shows why autotuning must be off: cuDNN's plans are kept
              per thread and the replay runs in autograd's), then 6
              steps timed; on a shallow f32 r101 at the
              same frames 2 whole steps leave every running statistic
              within rtol 1e-3 of none's and ``num_batches_tracked`` 4 in
              both; (c) the ABN step of each VGG
              arch (phase 12's) under block and convs, 6 steps, beside
              phase 12's none figures; (d) the flagship SAC step with
              Adam, 8 steps, saved through ``Checkpointer`` and loaded into
              a fresh state (moments and step counts equal to the bit),
              and the SAC views step with Adam, card against CPU on phase
              3's input (losses and labels as there, gradients within rel
              L2 1e-3, parameters and moments within rtol 1e-3 of a CPU
              Adam fed the card's gradients);
 20. step_tools  each step tool's ``main`` at its flagship defaults
              (``tools/flagship.py``): ``profile_step`` (six stages'
              spans in 2 timed steps) under each remat mode, ``conv_roofline``
              (every shape's TF/s and share of the card's dense bf16
              peak, the conv-bound floor),
              ``op_traffic`` (top 15 ops, totals) under none and convs,
              ``compare_refine_res`` cut to 6 + 6 + 6 steps
              (``src_loss_ce`` equal in the arms at their first step);
              cuDNN autotuning off before each, which the tool turns on;
              CE launches per tool exact and bulk;
 21. train_mesh  height-sharded training (``TPU.PARTITION gspmd``,
              ``TPU.MESH_SP``; ``make_gspmd_*``): (a) a NCCL world of one
              as gspmd (1, 1), the flagship SAC views and ABN frames
              steps against the one-process steps, cuDNN deterministic:
              losses bit-equal, state within twice two one-process runs'
              difference; (b) 4 spawned gloo ranks sharing the card, as
              (1, 2) (ranks 2 and 3 sit it out) and (2, 2): one f32 SAC
              step (2 source frames + 2 groups of 4 views, 512x1024) and
              one f32 ABN step (4 + 4 frames, 640x640 crops) of the
              full-width r101, and that ABN step of a shallow r101 (one
              block a stage), from the raw batch, without TF32, held in
              the parent against the unsharded global step: losses,
              parameters, BN buffers, teacher and running_conf within
              rtol 2e-4 / atol 2e-5 (the chaotic full-depth ABN step on
              its source loss alone, see phase 16); then 3 flagship bf16
              SAC steps
              (8 + 2 x 4) under REMAT block as (2, 2): finite,
              ``pseudo_cover`` > 0; every case ends with every rank's
              state equal.  Per rank and step: ms, peak GB, exchanges
              and bytes forward and backward by kind, BN collectives, CE
              launches by path.
 22. optimizers  optax's 26 optimizers by name (``MODEL.OPT``;
              ``train/optax_rules.py``) on phase 4's flagship model and
              batch: (a) one SAC step's gradients (each tensor at RMS 1,
              times 1, 0.5 and 2 at the 3 steps), 3 optimizer steps on the
              card and on the CPU from the same parameters (``noisy_sgd``:
              the same draws; the rules of ``OPTAX_LR`` at a larger base
              LR): every parameter tensor moved by at least 1e3 f32
              epsilons of its magnitude, each element within 1e-3 of its
              tensor's move plus 4 epsilons of itself, every state tensor
              within rtol 1e-4 / atol 1e-6 of its largest magnitude (the
              sign rules may differ on 1e-6 of the elements); (b) the
              optimizer step alone in CUDA-event ms beside SGD's and the
              state in GB, and for SGD, ``adamw`` and ``sm3`` (every name
              under ``--optimizers-only``) 4 flagship SAC steps, median ms
              of the last 2, CE launches 2 + 2 a step all bulk; (c) the state
              saved through ``Checkpointer`` and loaded into a fresh state:
              every field equal, and the next step bit-equal to the
              uninterrupted one's; then the train CLI with ``MODEL.OPT
              adafactor`` for 2 ABN steps on phase 10's synthetic root and
              ``--resume auto`` for 2 more: the resumed state equals the
              saved one (files under ``build/smoke_optax``, removed
              after; the root moves to ``build/smoke_bench`` for phase
              23);
 23. bench    the port's bench (``dasac_tpu_torch/tools/bench.py``, the
              counterpart of ``bench.py``), ``main`` in this process at the
              flagship (r101 bf16, 8 + 2 x 4 views at 512x1024): ``--mode
              step`` with ``--ce-impl pallas`` and with ``xla`` (3 warm-up,
              6 timed and 1 counted steps each), ``--mode e2e`` (3 timed
              steps fed by the PNG loaders) on phase 22's root, ``--mode
              infer`` (one 1024x2048 frame, 5 calls): one JSON line each
              with ``bench.py``'s keys and the card's; ``mfu`` and
              ``hbm_util`` in (0, 1.05]; 2 + 2 CE launches a step with
              pallas, all bulk, none with xla; the step's conv FLOPs within
              1% of a count by forward hooks (``hook_conv_flops``), the
              resize's products under 1% of them; and phase 14's r101
              batch-1 ``bench_infer`` record (``mfu``, ``hbm_util``);
 24. segformer SegFormer-B5 (``nn/segformer.py``) in bf16 through
              ``make_sac_step`` at the flagship's sizes, from one start:
              4 steps with the blocks' branches eager, each making exactly
              156 attention calls (52 blocks x teacher, source and target)
              over 24 x 316,669,952 query-key pairs
              (``segformer.ATTENTION``), finite losses and parameters, step
              ms and peak memory, one step profiled: every attention call
              on a fused SDPA backend (flash, memory-efficient or cuDNN)
              and none on the math one; one eager step again (two runs'
              difference); 4 steps from CUDA graphs (``nn/graphs.py``): the
              same counts, 2 + 2 CE launches a step all bulk, two passes of
              208 graphed branches (teacher, student), the first step's
              change of every parameter within 4x two eager runs'
              difference (or 2%) of eager's, step ms, peak memory and the
              ``attention``, ``mix_ffn`` and ``decode_head`` spans' ms;
              then 2 steps under ``remat block`` (eager), whose replays add
              104 calls;
Each phase prints one JSON line with the card's name and power limit.
Phases 10, 13, 14, 15, 17 and 18 call each entry point with cuDNN autotuning
off, as a new process starts, and check that the entry point turned it on.

Before the last line it prints one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``; the CUDA rows of the kernels
line carry the trainer's launches (``launches_train``), the VGG steps'
(``launches_vgg``), the trainer's from the dataset tools' packs
(``launches_dataset``) and phase 16's by part (``launches_ddp``: the NCCL
world's steps and CLI stages, each gloo rank's steps), phase 17's by
train stage (``launches_recipe``), phase 18's (``launches_infer_mesh``:
inference launches no CE kernel, so 0), phase 19's by part
(``launches_remat_opt``), phase 20's by tool (``launches_step_tools``) and
phase 21's (``launches_train_mesh``: the NCCL world's steps, each gloo
rank's cases, by path), phase 22's by timed name and CLI stage
(``launches_optimizers``) and phase 23's by run (``launches_bench``).

``python3 chip_smoke.py --infer-mesh-only`` runs phase 18 alone;
``--live-bn-only`` the live-BN kernels' part of phase 2, then phases 4, 6
and 9 with their live-BN launch counts;
``--remat-only``, ``--step-tools-only``, ``--train-mesh-only`` and
``--optimizers-only``, ``--bench-only`` and ``--segformer-only`` build the
CE kernels and run phase 19, 20, 21, 22, 23 or 24 alone (several flags:
those phases; phase 23 alone writes the bench's own corpus under
``build/smoke_bench``).

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
    """The card's published device-memory rate, bytes/s (``tools/bench.py``'s
    table: NVIDIA data sheets)."""
    from dasac_tpu_torch.tools.bench import hbm_peak_bw

    rate = hbm_peak_bw(name)
    if rate is None:
        raise RuntimeError("no memory rate known for %r" % name)
    return rate


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


# the live-BN kernels' shapes, the r101 ABN step's source rows in bf16
# channels_last: layer3's bn3 (with its residual), its bn1/bn2, the stem
LIVE_BN_CASES = (("layer3_bn3", (ABN_SRC[0], 1024, 80, 80), True),
                 ("layer3_bn1", (ABN_SRC[0], 256, 80, 80), False),
                 ("stem_bn1", (ABN_SRC[0], 64, 320, 320), False))


def live_bn_inputs(device, shape):
    """bf16 channels_last x, residual and upstream gradient of ``shape``,
    and f32 per-channel scale and shift, from ``SEED``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)

    def act(mul, add):
        t = torch.randn(shape, generator=gen, device=device) * mul + add
        return t.bfloat16().contiguous(memory_format=torch.channels_last)

    c = shape[1]
    return (act(2.0, 0.5), act(1.0, 0.0), act(1.0, 0.0),
            torch.rand(c, generator=gen, device=device) + 0.5,
            torch.randn(c, generator=gen, device=device) * 0.1)


def check_live_bn(live_bn, x, res, dy, scale, shift, residual):
    """The four live-BN kernels against their plain versions; returns
    kernel -> (max abs error, tolerance).  Tolerances
    (``tests/test_torch_live_bn.py``): the sums within 1e-5 of the sum of
    their terms' magnitudes (f32 sums of 1e5-1e6 terms in two orders);
    ``apply`` and ``sums_bwd`` within one bf16 ulp of the plain value
    (2^-7 relative) plus 2^-22 of the magnitude of the terms added (an FMA
    against a multiply and an add, rounded to bf16); ``apply_bwd``'s dx
    and dresidual equal, its sums as the sums.  Each error is reported
    against its tolerance, where the tolerance is the largest."""
    import torch

    c = x.shape[1]
    r = res if residual else None
    xf = x.float()
    out = {}

    def worst(err, tol, name):
        ratio = (err / tol).max().item() if tol.numel() else 0.0
        need(ratio <= 1.0, "live BN %s disagrees with its plain version: "
             "%.3g of its tolerance" % (name, ratio))
        out[name] = (err.max().item(), tol.max().item())

    mag = torch.cat([xf.abs().sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2,
                                                                    3))])
    worst((live_bn.sums(x) - live_bn.sums_plain(x)).abs(), 1e-5 * mag,
          "live_bn_sums")
    g = torch.randn(2 * c, device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(1))
    gs, gq = (v[:, None, None] for v in g.split(c))
    want = live_bn.sums_bwd_plain(x, g).float()
    worst((live_bn.sums_bwd(x, g).float() - want).abs(),
          want.abs() * 2.0 ** -7 + (gs.abs() + (2 * gq * xf).abs())
          * 2.0 ** -22, "live_bn_sums_bwd")
    y = live_bn.apply(x, scale, shift, r, True)
    want = live_bn.apply_plain(x, scale, shift, r, True)
    terms = (xf * scale[:, None, None]).abs() + shift.abs()[:, None, None]
    if residual:
        terms = terms + res.float().abs()
    worst((y.float() - want.float()).abs(),
          want.float().abs() * 2.0 ** -7 + terms * 2.0 ** -22,
          "live_bn_apply")
    dx, dres, sums = live_bn.apply_bwd(dy, x, want, scale, True, residual)
    dx0, dres0, sums0 = live_bn.apply_bwd_plain(dy, x, want, scale, True,
                                                residual)
    need(torch.equal(dx, dx0) and (dres is None or torch.equal(dres, dres0)),
         "live BN apply_bwd: dx or dresidual differ from the plain version")
    d = dy.float().abs()
    worst((sums - sums0).abs(), 1e-5 * torch.cat([
        d.sum(dim=(0, 2, 3)), (d * xf.abs()).sum(dim=(0, 2, 3))]),
          "live_bn_apply_bwd")
    torch.cuda.synchronize()
    return out


def check_live_bn_exact(live_bn, device, shape):
    """bf16 integers in [-3, 3]: every partial sum of x, x*x, the masked
    upstream gradient and it times x is an integer under 2^24, exact in f32
    in any order, so ``sums`` and ``apply_bwd``'s sums must equal their
    plain versions bit for bit (a row dropped or taken twice shows)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    x, dy = (torch.randint(-3, 4, shape, generator=gen, device=device)
             .bfloat16().contiguous(memory_format=torch.channels_last)
             for _ in range(2))
    need(torch.equal(live_bn.sums(x), live_bn.sums_plain(x)),
         "live BN sums of small integers differ from the plain version's "
         "at %s" % (shape,))
    scale = torch.ones(shape[1], device=device)
    y = live_bn.apply_plain(x, scale, scale - 1.0, None, True)
    need(torch.equal(live_bn.apply_bwd(dy, x, y, scale, True, False)[2],
                     live_bn.apply_bwd_plain(dy, x, y, scale, True,
                                             False)[2]),
         "live BN apply_bwd's sums of small integers differ from the plain "
         "version's at %s" % (shape,))


def run_live_bn(ce, ce_triton, device, card):
    """Live BN's kernels (``ops/live_bn.py``, ``csrc/live_bn.cu``) at the
    r101 ABN step's shapes: each against its plain version, then it and
    its plain version timed in turns, beside its bound (its bytes at the
    card's memory rate).  ``apply`` and ``apply_bwd`` run with the ReLU,
    and with the residual at bn3's shape.  Sums are checked to repeat bit
    for bit.  Returns the rows."""
    import torch

    from dasac_tpu_torch.ops import cuda_build, live_bn

    name = torch.cuda.get_device_name(device)
    rate = mem_rate(name)
    t0 = time.perf_counter()
    live_bn._library(device)
    log("build: %s in %.1f s" % (cuda_build.library_path(
        live_bn.SOURCE).name, time.perf_counter() - t0))
    for r in ptxas_summary(cuda_build.build_log(live_bn.SOURCE)):
        log("ptxas %s" % json.dumps(r))
    # ragged: 4551 rows, a multiple of no block's or grid's rows
    for shape in [s for _, s, _ in LIVE_BN_CASES] + [(3, 256, 37, 41)]:
        check_live_bn_exact(live_bn, device, shape)
    rows = []
    for case, shape, residual in LIVE_BN_CASES:
        x, res, dy, scale, shift = live_bn_inputs(device, shape)
        r = res if residual else None
        y = live_bn.apply(x, scale, shift, r, True)
        errs = check_live_bn(live_bn, x, res, dy, scale, shift, residual)
        need(torch.equal(live_bn.sums(x), live_bn.sums(x)),
             "live BN sums differ between two calls")
        g = torch.randn(2 * shape[1], device=device)
        elems = x.numel()
        # bytes moved: each bf16 tensor read or written once
        moved = {"live_bn_sums": 2, "live_bn_sums_bwd": 4,
                 "live_bn_apply": 6 if residual else 4,
                 "live_bn_apply_bwd": 10 if residual else 8}
        kernels = {
            "live_bn_sums": (lambda: live_bn.sums(x),
                             lambda: live_bn.sums_plain(x)),
            "live_bn_sums_bwd": (lambda: live_bn.sums_bwd(x, g),
                                 lambda: live_bn.sums_bwd_plain(x, g)),
            "live_bn_apply": (lambda: live_bn.apply(x, scale, shift, r, True),
                              lambda: live_bn.apply_plain(x, scale, shift,
                                                          r, True)),
            "live_bn_apply_bwd": (
                lambda: live_bn.apply_bwd(dy, x, y, scale, True, residual),
                lambda: live_bn.apply_bwd_plain(dy, x, y, scale, True,
                                                residual)),
        }
        for k, (fn, plain) in kernels.items():
            t = in_turns(dict(ms=fn, plain_ms=plain))
            bound = moved[k] * elems / rate * 1e3
            row = dict(phase="live_bn", kernel=k, case=case,
                       shape=list(shape), residual=residual, relu=True,
                       ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound,
                       bound_share=bound / t["ms"],
                       bytes=moved[k] * elems, max_abs_err=errs[k][0],
                       tol=errs[k][1], card=card)
            rows.append(row)
            log("kernel time  %-17s %-10s %.4f ms (%.0f%% of bound %.4f), "
                "plain %.4f, max_abs_err %.3e"
                % (k, case, row["ms"], 100 * row["bound_share"], bound,
                   row["plain_ms"], row["max_abs_err"]))
        del x, res, dy, y
        torch.cuda.empty_cache()
    log("live_bn: %s" % json.dumps(rows))
    return dict(live_bn.LAUNCHES)


def run_live_bn_paths(ce, ce_triton, device, card):
    """``--live-bn-only``: phase 2's live-BN part, then phases 4, 6 and 9,
    each of which checks its live-BN launches (none in the SAC step and in
    inference, 6 a layer in an ABN step).  Returns the ABN step's."""
    import torch

    run_live_bn(ce, ce_triton, device, card)
    torch.cuda.empty_cache()
    run_slice(ce, ce_triton, device, card)
    torch.cuda.empty_cache()
    state = run_abn(ce, ce_triton, device, card)[0]
    run_infer(state, device, card)
    return live_bn_want(state.model, N_STEPS)


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
    BETA1 = 0.5


def model_cfg(opt="SGD"):
    """``_ModelCfg`` with ``OPT`` = ``opt`` (``MODEL.OPT``)."""
    return type("_ModelCfg_" + opt, (_ModelCfg,), {"OPT": opt})


def agreement_inputs(arch="deeplabv2_resnet101", **model_kw):
    """Phase 3's small input: the step config, 2 groups of 3 target views
    and 2 source frames at 40x48 from ``SEED``, and the ``state_dict`` of
    ``arch`` (``model_kw`` go to ``build_model``) with He-scaled conv
    weights (confident, varied logits)."""
    import torch

    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.nn.layers import Conv2d
    from dasac_tpu_torch.train import steps

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
    with torch.no_grad():
        for m in ref_model.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    return scfg, views, src_x, src_y, ref_model.state_dict()


def agreement_runs(device, arch, model_kw, opt, debug):
    """Phase 3's two runs: 2 iterations of the SAC views step of ``arch``
    with the optimizer ``opt`` on the CPU and on ``device`` from
    :func:`agreement_inputs`; {device: (state, metrics per iteration)}."""
    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    scfg, views, src_x, src_y, ref_sd = agreement_inputs(arch, **model_kw)
    runs = {}
    for dev in ("cpu", device):
        model = build_model(arch, C, device="cpu", **model_kw)
        model.load_state_dict(ref_sd)
        state = create_train_state(
            model, optim.build_optimizer(model_cfg(opt), arch, model), C,
            device=dev)
        step = steps.make_sac_views_step(scfg, debug=debug)
        v = pipelines.TargetViews(*(a.to(dev) for a in views))
        mets = [step(state, src_x.to(dev), src_y.to(dev), v)
                for _ in range(2)]
        runs[dev] = (state, [{k: (x.cpu() if hasattr(x, "cpu") else
                                  {n: g.cpu() for n, g in x.items()})
                              for k, x in m.items()} for m in mets])
    return runs, ref_sd


def check_losses_and_labels(m_ref, m_dev):
    """Losses and running_conf within rtol 1e-3 / atol 1e-5 and
    pseudo-labels within 1% at each iteration; the worst label
    mismatch."""
    import torch

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
    return worst


def check_agreement(device, arch="deeplabv2_resnet101", label="agree",
                    card=None, **model_kw):
    """The SAC views step of ``arch`` (default a shallow full-width r101;
    ``model_kw`` go to ``build_model``) on a 40x48 input, 2 iterations on
    the CPU and on ``device`` from the same He-scaled weights and views:
    losses, running_conf, parameters and teacher within rtol 1e-3 / atol
    1e-5, pseudo-labels within 1%."""
    import torch

    if arch == "deeplabv2_resnet101" and not model_kw:
        model_kw = dict(layers=(1, 1, 1, 1))
    runs, _ = agreement_runs(device, arch, model_kw, "SGD", "light")
    (s_ref, m_ref), (s_dev, m_dev) = runs["cpu"], runs[device]
    worst = check_losses_and_labels(m_ref, m_dev)
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


def check_adam_agreement(device, card=None):
    """Phase 3's check with ``MODEL.OPT adam`` (shallow f32 r101): losses,
    running_conf and pseudo-labels as there; each iteration's gradients
    within a relative L2 error of 1e-3 of the CPU's; the card's
    parameters and Adam moments within rtol 1e-3 / atol 1e-5 of a CPU
    Adam fed the card's own gradients.  Not the CPU run's parameters:
    Adam's first steps move each weight by about ``lr * sign(g)``, so a
    gradient within rounding of 0 moves its weight by +-lr on one device
    and the other."""
    import torch

    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim

    arch, model_kw = "deeplabv2_resnet101", dict(layers=(1, 1, 1, 1))
    runs, ref_sd = agreement_runs(device, arch, model_kw, "adam", True)
    (_, m_ref), (s_dev, m_dev) = runs["cpu"], runs[device]
    worst_labels = check_losses_and_labels(m_ref, m_dev)
    worst_grad = 0.0
    for it, (a, b) in enumerate(zip(m_ref, m_dev)):
        for k, g in b["grads"].items():
            rel = _rel_l2(g, a["grads"][k])
            need(rel < 1e-3, "adam_agree iter %d: gradient of %s off the "
                 "CPU's by rel L2 %.3e" % (it, k, rel))
            worst_grad = max(worst_grad, rel)
    replay = build_model(arch, C, device="cpu", **model_kw)
    replay.load_state_dict(ref_sd)
    opt = optim.build_optimizer(model_cfg("adam"), arch, replay)
    params = dict(replay.named_parameters())
    for m in m_dev:
        for k, p in params.items():
            p.grad = m["grads"][k]
        opt.step()
    for k, p in s_dev.model.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), params[k].detach(),
                                   rtol=1e-3, atol=1e-5, msg=k)
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(
                s_dev.optimizer.state[p][key].cpu(),
                opt.state[params[k]][key], rtol=1e-3, atol=1e-5,
                msg="%s %s" % (key, k))
    out = dict(phase="adam_agree", card=card, iterations=2,
               grad_rel_l2_worst=worst_grad, label_mismatch=worst_labels)
    log("adam_agree: %s" % json.dumps(out))
    return out


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


def flagship_state(device, seed=SEED, group=None, dtype=None, remat="none",
                   opt="SGD", **model_kw):
    """Full-width, full-depth ``deeplabv2_resnet101`` in bf16 (or
    ``dtype``) with random weights from ``seed``, its optimizer (``opt``:
    ``MODEL.OPT``) and train state; ``group``: the process group of its
    BN layers' cross-replica statistics; ``remat``: ``TPU.REMAT``;
    ``model_kw`` go to ``build_model`` (``layers`` for a shallower
    trunk)."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim

    model = build_model("deeplabv2_resnet101", C,
                        dtype=dtype or torch.bfloat16,
                        remat=remat, device=device, group=group,
                        generator=torch.Generator().manual_seed(seed),
                        **model_kw)
    return create_train_state(model, optim.build_optimizer(
        model_cfg(opt), "deeplabv2_resnet101", model), C, device=device)


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
    from dasac_tpu_torch.ops import live_bn

    for counts in (ce.LAUNCHES, ce_triton.LAUNCHES, live_bn.LAUNCHES):
        for k in counts:
            counts[k] = 0
    for by_path in ce.PATH_LAUNCHES.values():
        for p in by_path:
            by_path[p] = 0


def live_bn_want(model, steps, live=True):
    """The live-BN launches (kernel -> launches) of ``steps`` ABN steps on
    ``model`` (``live``): each BN layer's ``sums`` and ``apply`` in the
    source forward and in the target forward, its ``apply_bwd`` and
    ``sums_bwd`` in the backward; none where BN is frozen."""
    from dasac_tpu_torch.nn.layers import SyncBatchNorm

    n = steps * live * sum(isinstance(m, SyncBatchNorm)
                           for m in model.modules())
    return {"live_bn_sums": 2 * n, "live_bn_sums_bwd": n,
            "live_bn_apply": 2 * n, "live_bn_apply_bwd": n}


def read_counts(ce, ce_triton, want, live_bn_want=None):
    """The launch counts since ``reset_counts``; fails unless they are
    ``want`` (kernel -> launches), every one on the bulk path, and no
    Triton launch, and, given ``live_bn_want``, unless the live-BN
    launches are those."""
    from dasac_tpu_torch.ops import live_bn

    launches = dict(ce.LAUNCHES)
    paths = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    triton_launches = dict(ce_triton.LAUNCHES)
    need(launches == want, "CE launches %s, want %s" % (launches, want))
    need(live_bn_want is None or live_bn.LAUNCHES == live_bn_want,
         "live-BN launches %s, want %s" % (live_bn.LAUNCHES, live_bn_want))
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
        ce, ce_triton, {"nll_fwd": 2 * N_STEPS, "nll_bwd": 2 * N_STEPS},
        live_bn_want(model, N_STEPS, live=False))
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
    live = live_bn_want(model, N_STEPS)
    need(live["live_bn_apply_bwd"] == 104 * N_STEPS,
         "the flagship r101 has %d BN layers, not 104"
         % (live["live_bn_apply_bwd"] // N_STEPS))
    launches, paths, triton_launches = read_counts(
        ce, ce_triton, {"nll_fwd": 2 * N_STEPS, "nll_bwd": N_STEPS}, live)
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
        ce_launches_by_path=paths, live_bn_launches=live,
        bn_layers_moved=moved,
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
    from dasac_tpu_torch.ops import live_bn

    cfg = abn_step_config()
    rng = np.random.RandomState(SEED + 3)
    live_before = dict(live_bn.LAUNCHES)
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
    need(live_bn.LAUNCHES == live_before, "inference launched live-BN "
         "kernels: %s after %s" % (live_bn.LAUNCHES, live_before))
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
            self.in_validation = False
            train_loaders = self.loaders.train_loaders

            def timed_loaders(epoch):
                src, tgt = train_loaders(epoch)
                if self.in_validation:   # target validation
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
            self.in_validation = True
            try:
                out = super().validation(epoch, split, max_batches,
                                         target_mode)
            finally:
                self.in_validation = False
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
                    device, card, bare_ms=None, check_resume=None,
                    phase="train", world=False):
    """One ``cli.main`` run, measured from outside the trainer; checks its
    losses, CE launches, events, snapshots and start epoch.  ``world``: the
    run joins a NCCL world of one as torchrun launches it (``argv`` holds
    ``--multiprocessing-distributed``; the environment is set here for the
    call), and its trainer must have run in it."""
    import torch

    from dasac_tpu_torch.train import cli, loop
    from dasac_tpu_torch.utils.sys_tools import find_free_port

    probe = dict(events=[], host_ms=[], wait_src=[], wait_tgt=[], val_ms={},
                 save_ms=[], val_wait=[], val_eval=[], val_panel=[],
                 epoch_starts=[])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(ce, ce_triton)
    original = loop.Trainer
    loop.Trainer = measured_trainer(probe, check_resume)
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(find_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0") if world else {}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    fresh_cudnn()
    t0 = time.perf_counter()
    try:
        trainer = cli.main(argv, device=None if device.type == "cuda"
                           else device)
    finally:
        loop.Trainer = original
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    wall_s = time.perf_counter() - t0
    need((trainer.group is not None, trainer.world) == (world, 1),
         "%s: the trainer ran in a world of %d (group %s)" % (
             stage, trainer.world, trainer.group))
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
    for writer, tags in events.items():
        for tag, recs in tags.items():
            steps = [st for st, _ in recs]
            need(len(steps) == len(set(steps)),
                 "%s: %s/%s written twice an epoch" % (stage, writer, tag))
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
        phase=phase, stage=stage, card=card, argv=argv, wall_s=wall_s,
        setup_s=probe["setup_s"], start_epoch=probe["start_epoch"],
        steps=n_steps, step_ms=steps, loader_wait_ms=waits,
        host_ms_in_step=probe["host_ms"], epoch_first_steps=sorted(set(
            probe["epoch_starts"])),
        step_ms_median=statistics.median(steps[1:]),
        steady_step_ms_median=statistics.median(steady) if steady else None,
        loader_wait_ms_median=statistics.median(waits[1:]),
        bare_step_ms_median=bare_ms, val_ms=probe["val_ms"],
        snapshot_save_ms=probe["save_ms"], max_memory_allocated=peak,
        epoch_losses={t: v for t, v in losses.items()
                      if not t.startswith("train_epoch/self_ce_class")},
        miou={w: tags["logits_up_all/mIoU"] for w, tags in events.items()
              if "logits_up_all/mIoU" in tags},
        ce_launches=launches, ce_launches_by_path=paths,
        triton_launches=triton_launches)
    log("%s %s: %s" % (phase, stage, json.dumps(out)))
    return trainer, out


TRAIN_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_train")


def run_train(ce, ce_triton, device, card, bare_ms=None, world=False):
    """Phase 10: the trainer CLI on a synthetic root of real frame sizes;
    ABN (2 epochs x 2 steps, one validation round), SAC from the ABN
    snapshot (epochs 2 and 3, 3 steps each, one validation round), and
    ``--resume auto`` of the SAC run (epoch 4).  Returns the CE launches of
    each stage.  The root stays under ``TRAIN_BASE``; the run's snapshots
    and logs go.  ``world`` (phase 16): the same stages on that root, each
    a torchrun-style launch of one NCCL rank; the root goes after."""
    import shutil

    import torch

    base = TRAIN_BASE
    root = os.path.join(base, "root")
    out = os.path.join(base, "ddp" if world else "")
    if not world:
        shutil.rmtree(base, ignore_errors=True)
    bare_ms = bare_ms or {}
    kw = dict(phase="ddp_cli" if world else "train", world=world)
    ok = False
    try:
        if not world:
            write_train_root(root, card)
        common = ["--snapshot-dir", os.path.join(out, "snap"), "--logdir",
                  os.path.join(out, "logs"), "--exp", "smoke",
                  *(["--multiprocessing-distributed"] if world else [])]
        # one process on one card, however many cards the host has (a
        # torchrun-style launch takes its world from the environment)
        sets = ["DATASET.ROOT", root, "TPU.CE_IMPL", "pallas",
                "LOG.ITER_VAL", "1", "LOG.ITER_TARGET", "1",
                "TPU.MESH_DEVICES", "1"]
        stages = {}
        abn, stages["abn"] = run_train_stage(
            ce, ce_triton, "abn",
            ["--cfg", TRAIN_CFG["abn"], *common, "--run", "abn", "--set",
             *sets, "MODEL.BASELINE", "True", "TRAIN.NUM_EPOCHS", "1",
             *TRAIN_SETS], 0, 4, device, card, bare_ms.get("abn"), **kw)
        abn_last = os.path.join(abn.args.snapshot_dir, "last.pth")
        del abn
        torch.cuda.empty_cache()
        sac, stages["sac"] = run_train_stage(
            ce, ce_triton, "sac",
            ["--cfg", TRAIN_CFG["sac"], *common, "--run", "sac",
             "--resume", abn_last, "--set", *sets, "TRAIN.NUM_EPOCHS", "3",
             *TRAIN_SETS], 2, 6, device, card, bare_ms.get("sac"), **kw)
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
            check_resume, **kw)
        del resumed, saved
        torch.cuda.empty_cache()
        ok = True
    finally:
        for sub in ("snap", "logs") if ok and not world else ("",):
            shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
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
    launches}} and {arch: (ABN step ms median, peak GB)}."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    torch.backends.cudnn.benchmark = True
    launches, abn_figures = {}, {}
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
            if kind == "abn":
                abn_figures[arch] = (statistics.median(
                    times[WARMUP_STEPS:]), peak / 1e9)
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
    return launches, abn_figures


# ---------------------------------------------------------------------------
# phase 13: the inference program through its CLI, and the offline tools
# ---------------------------------------------------------------------------

INFER_FRAMES = 8     # Cityscapes-val frames of the synthetic root
INFER_CFG = "configs/deeplabv2_resnet101_train.yaml"
INFER_RUNS = {"single": ["--batch", "1"],
              "multi_flip_stride8": ["--scales", "0.75", "1.0", "1.25",
                                     "--flip", "--fuse", "stride8",
                                     "--batch", "2"]}


def write_cityscapes_val(root, card, frames=INFER_FRAMES):
    """A Cityscapes-val layout of ``frames`` frames at 1024x2048,
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
        for i in range(frames):
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
        phase="infer_root", card=card, frames=frames, hw=list(INFER_HW),
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
    1 and 4, and r101 with 3 scales + flip fused at stride 8; each with its
    FLOPs and bytes, ``mfu`` and ``hbm_util`` in (0, 1.05].  Returns the
    records."""
    import torch

    from dasac_tpu_torch.tools import bench_infer

    out = []
    for flags in BENCH_RUNS:
        fresh_cudnn()
        rec = bench_infer.main([*flags, "--output", "argmax"], device=device)
        need(rec["value"] > 0 and rec["cudnn_benchmark"]
             and rec["device"] == torch.cuda.get_device_name(0),
             "bench_infer %s" % flags)
        need(rec["step_flops_tf"] > 0 and rec["hbm_gb_per_step"] > 0
             and 0 < rec["mfu"] <= 1.05 and 0 < rec["hbm_util"] <= 1.05,
             "bench_infer %s: mfu %s, hbm_util %s" % (
                 flags, rec.get("mfu"), rec.get("hbm_util")))
        out.append(rec)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the dataset program, from raw files to the trainer
# ---------------------------------------------------------------------------

# frames of each pool of the raw corpus (source train, target train, and
# each of the GTA and Cityscapes val pools); the source pool holds two ABN
# batches (TRAIN.BATCH_SIZE 12 of the ABN YAML), so that each epoch has a
# step after its first, and the target pool one ABN target batch
# (NUM_GROUPS 8); the val pools were cut from 4 frames to 2 for time
DATASET_SRC = (24, 1052, 1914)
DATASET_TGT = (8, 1024, 2048)
DATASET_VAL = 2
DATASET_SETS = []   # extra --set pairs after the stage's own (none here)
CITY = "zurich"


def write_raw_corpus(root):
    """``make_domain_gap_root``'s scenes (written first under
    ``<root>/staging``, removed after) rewritten in the raw layouts of the
    datasets: GTA5 (``gta5/images/{train,val}``, RGB, and
    ``gta5/labels/{train,val}``, palette PNGs of raw GTA ids) and
    Cityscapes (``leftImg8bit/{train,val}/<city>`` and
    ``gtFine/{train,val}/<city>/*_gtFine_labelIds.png``, gray labelIds).
    The RGB frames and their labels are written with Paeth rows (filter 4)
    and Average rows (filter 3), one frame each in turn, as the real
    datasets' are.  Returns {frame path: filter}."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from dasac_tpu_torch.data import lists, png, synth
    from dasac_tpu_torch.data.category import (color_table,
                                               trainid_to_cs_table)

    staging = os.path.join(root, "staging")
    t0 = time.perf_counter()
    synth.make_domain_gap_root(
        staging, n_train_src=DATASET_SRC[0], n_train_tgt=DATASET_TGT[0],
        n_val=DATASET_VAL, src_hw=DATASET_SRC[1:], tgt_hw=DATASET_TGT[1:],
        seed=SEED)
    gen_s = time.perf_counter() - t0
    t2c = trainid_to_cs_table()
    # a GTA-style palette: each raw id's Cityscapes colour
    palette = np.zeros((34, 3), np.uint8)
    palette[t2c[:C]] = color_table()[:C]
    pools = {"train_game_9K": ("gta5", "train"),
             "val_game_1K": ("gta5", "val"),
             "train_cityscapes": ("cityscapes", "train"),
             "val_cityscapes": ("cityscapes", "val")}
    filters, jobs = {}, []

    def rewrite(src_img, src_lbl, dst_img, dst_lbl, kind, filt):
        img = png.to_rgb(png.read(src_img))
        raw = t2c[png.to_mask(png.read(src_lbl))]
        for p in (dst_img, dst_lbl):
            os.makedirs(os.path.dirname(p), exist_ok=True)
        png.write(dst_img, img, filt)
        if kind == "gta5":
            png.write(dst_lbl, raw, filt, palette=palette)
        else:
            png.write(dst_lbl, raw, filt)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for split, (kind, sub) in pools.items():
            images, masks = lists.read_split(staging, split)
            for i, (si, sl) in enumerate(zip(images, masks)):
                filt = 4 if i % 2 == 0 else 3
                if kind == "gta5":
                    di = "gta5/images/%s/%05d.png" % (sub, i)
                    dl = "gta5/labels/%s/%05d.png" % (sub, i)
                else:
                    stem = "%s_%06d_000019" % (CITY, i)
                    di = "leftImg8bit/%s/%s/%s_leftImg8bit.png" % (
                        sub, CITY, stem)
                    dl = "gtFine/%s/%s/%s_gtFine_labelIds.png" % (
                        sub, CITY, stem)
                filters[os.path.join(root, di)] = filt
                jobs.append(pool.submit(
                    rewrite, si, sl, os.path.join(root, di),
                    os.path.join(root, dl), kind, filt))
    for j in jobs:
        j.result()
    rewrite_s = time.perf_counter() - t0
    shutil.rmtree(staging)
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
    return filters, dict(generate_s=gen_s, rewrite_s=rewrite_s,
                         raw_bytes=nbytes)


def prepare_root(root):
    """The dataset tools in this process, as a user runs them on the raw
    corpus: ``convert_train_ids`` (gta, cs), ``make_split_lists`` (the five
    splits of the GTA task; val2_cityscapes a subset of the
    Cityscapes train split, as the reference's is), ``check_dataset``
    (must report the root ready).  Returns each tool's seconds and
    results."""
    from dasac_tpu_torch.tools import (check_dataset, convert_train_ids,
                                       make_split_lists)

    out = {}
    t0 = time.perf_counter()
    for dataset, src, dst in (("gta", "gta5/labels", "gta5/labels_cs"),
                              ("cs", "gtFine", "labels_cs")):
        convert_train_ids.main(["--dataset", dataset, "--ann-data",
                                os.path.join(root, src), "--ann-out",
                                os.path.join(root, dst)])
    out["convert_s"] = time.perf_counter() - t0
    out["converted"] = sum(len(fs) for d in ("gta5/labels_cs", "labels_cs")
                           for _, _, fs in os.walk(os.path.join(root, d)))
    t0 = time.perf_counter()
    splits = {
        "train_game_9K": ["gta", "gta5/images/train", "gta5/labels_cs/train"],
        "val_game_1K": ["gta", "gta5/images/val", "gta5/labels_cs/val"],
        "train_cityscapes": ["cityscapes", "leftImg8bit/train",
                             "labels_cs/train"],
        "val_cityscapes": ["cityscapes", "leftImg8bit/val", "labels_cs/val"],
        "val2_cityscapes": ["cityscapes", "leftImg8bit/train",
                            "labels_cs/train", "--limit",
                            str(DATASET_VAL)]}
    for split, (dataset, images, labels, *rest) in splits.items():
        make_split_lists.main(
            ["--dataset", dataset, "--root", root, "--image-dir", images,
             "--label-dir", labels, "--out",
             os.path.join(root, split + ".txt"), *rest])
    out["lists_s"] = time.perf_counter() - t0
    out["list_lines"] = {}
    for split in splits:
        with open(os.path.join(root, split + ".txt")) as f:
            out["list_lines"][split] = len(f.read().splitlines())
    need(out["list_lines"] == {
        "train_game_9K": DATASET_SRC[0], "val_game_1K": DATASET_VAL,
        "train_cityscapes": DATASET_TGT[0], "val_cityscapes": DATASET_VAL,
        "val2_cityscapes": DATASET_VAL}, "split lists %s" % out["list_lines"])
    need(out["converted"] == sum(out["list_lines"].values())
         - DATASET_VAL, "%d labels converted" % out["converted"])
    t0 = time.perf_counter()
    report = os.path.join(root, "check.json")
    rc = check_dataset.main(["--root", root, "--task", "gta", "--json",
                             report])
    out["check_s"] = time.perf_counter() - t0
    with open(report) as f:
        rep = json.load(f)
    out["check"] = dict(rc=rc, failures=rep["failures"], mask_kinds={
        s: e.get("mask_kinds") for s, e in rep["splits"].items()})
    need(rc == 0 and not rep["failures"], "check_dataset: %s" % rep)
    return out


def decode_times(root, filters, crop=(512, 1024), reps=3):
    """The native decoder's ms a frame on Cityscapes-sized frames: one
    thread (median of ``reps`` calls), for a Paeth and an Average frame,
    resized to the SAC crop (as the SAC target groups are decoded) and at
    the frame's own size (the exact decode of the center-crop route); and
    one batch call over the target split on ``TPU.LOADER_THREADS``
    threads, resized to the crop."""
    from dasac_tpu_torch.core.config import cfg
    from dasac_tpu_torch.data import lists, native

    images, masks = lists.read_split(root, "train_cityscapes")
    threads = cfg.TPU.LOADER_THREADS
    one = {}
    for f in (4, 3):
        i = next(i for i, p in enumerate(images) if filters[p] == f)
        for hw, key in ((crop, "resize"), (DATASET_TGT[1:], "own_size")):
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                need(native.decode_pair(images[i], masks[i], hw) is not None,
                     "the native decoder refused %s" % images[i])
                ms.append((time.perf_counter() - t0) * 1e3)
            one["filter%d_%s" % (f, key)] = statistics.median(ms)
    t0 = time.perf_counter()
    _, _, status = native.decode_batch(images, masks, crop, threads=threads)
    batch_ms = (time.perf_counter() - t0) * 1e3
    need(not status.any(), "decode_batch status %s" % status.tolist())
    return dict(native_ms_one_thread=one, native_batch_ms=batch_ms,
                native_batch_frames=len(images),
                native_batch_ms_per_frame=batch_ms / len(images),
                threads=threads, host_cpus=os.cpu_count(), crop=list(crop))


def pack_root(root, filters):
    """``pack_dataset`` for the source and target train splits at their
    canonical sizes; then two packed target frames (a Paeth and an Average
    one) held against the Python path's decode of their files, which is
    timed."""
    from dasac_tpu_torch.data import lists, packed, png
    from dasac_tpu_torch.tools import pack_dataset

    splits = ("train_game_9K", "train_cityscapes")
    t0 = time.perf_counter()
    pack_dataset.main(["--root", root] + [a for s in splits
                                           for a in ("--split", s)])
    pack_s = time.perf_counter() - t0
    pdir = packed.default_dir(root)
    nbytes = sum(os.path.getsize(os.path.join(pdir, f))
                 for f in os.listdir(pdir))
    frames = DATASET_SRC[0] + DATASET_TGT[0]
    images, masks = lists.read_split(root, "train_cityscapes")
    ds = packed.PackedDataset(packed.find_pack(pdir, "train_cityscapes",
                                               DATASET_TGT[1:], "resize"))
    checks = []
    for f in (4, 3):
        i = next(i for i, p in enumerate(images) if filters[p] == f)
        img, mask = ds.load(i)
        t0 = time.perf_counter()
        ref_img = png.to_rgb(png.read(images[i]))
        python_ms = (time.perf_counter() - t0) * 1e3
        ref_mask = png.to_mask(png.read(masks[i]))
        d = np.abs(img.astype(np.int16) - ref_img)
        checks.append(dict(filter=f, python_decode_ms=python_ms,
                           masks_equal=bool(
            (mask == ref_mask).all()), max_abs_diff=int(d.max()),
            mean_abs_diff=float(d.mean())))
        need(checks[-1]["masks_equal"] and d.mean() <= 1.5,
             "packed frame %d against the Python decode: %s"
             % (i, checks[-1]))
    return dict(pack_s=pack_s, frames=frames, frames_per_s=frames / pack_s,
                pack_bytes=nbytes, check=checks)


def build_native():
    """The C++ PNG decoder (``native/dasac_io.cpp``) built by g++ from this
    checkout into ``build/native/`` and loaded; returns the seconds taken
    (the train, infer and dataset phases decode through it)."""
    from dasac_tpu_torch.data import native, native_build

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    logs = sorted(native_build.BUILD_DIR.glob("*.log"))
    log("native decoder: built in %.1f s: %s" % (
        build_s, logs[-1].read_text().splitlines()[0] if logs else "?"))
    return build_s


def run_dataset(ce, ce_triton, device, card, native_build_s=None):
    """Phase 15: a raw corpus at the real frame sizes; the dataset tools
    (convert, lists, check, pack); the decode times of each route; the
    trainer CLI from the packs with the native loader and center-cropped
    validation: ABN (2 epochs of 2 steps, one validation round: the
    trainer validates from its second epoch), then SAC from its
    ``last.pth`` (1 epoch of 3 steps).  Every decode of the loader must
    take the native route.  Returns the CE launches of each stage."""
    import shutil

    import torch

    from dasac_tpu_torch.data import native, packed

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_dataset")
    root = os.path.join(base, "root")
    shutil.rmtree(base, ignore_errors=True)
    out = dict(phase="dataset", card=card, native_build_s=native_build_s,
               frames=dict(
        source=list(DATASET_SRC), target=list(DATASET_TGT),
        val_per_pool=DATASET_VAL))
    decodes = {}

    def routes(stage, want_native):
        got = dict(native.PATH_DECODES)
        decodes[stage] = got
        need(got == {"native": want_native, "python": 0},
             "%s: decodes by route %s, want %d native" % (stage, got,
                                                          want_native))
        for k in native.PATH_DECODES:
            native.PATH_DECODES[k] = 0

    try:
        native.set_enabled(True)
        for k in native.PATH_DECODES:
            native.PATH_DECODES[k] = 0
        filters, out["corpus"] = write_raw_corpus(root)
        out["tools"] = prepare_root(root)
        routes("tools", 0)
        out["pack"] = pack_root(root, filters)
        routes("pack", DATASET_SRC[0] + DATASET_TGT[0])
        out["decode"] = decode_times(root, filters)
        for k in native.PATH_DECODES:
            native.PATH_DECODES[k] = 0
        common = ["--snapshot-dir", os.path.join(base, "snap"), "--logdir",
                  os.path.join(base, "logs"), "--exp", "dataset"]
        sets = ["DATASET.ROOT", root, "TPU.CE_IMPL", "pallas",
                "TPU.NATIVE_LOADER", "True", "TPU.PACKED_DIR", "auto",
                "DATASET.VAL_CROP", "True", "TPU.MESH_DEVICES", "1"]
        stages = {}
        abn, stages["abn"] = run_train_stage(
            ce, ce_triton, "dataset_abn",
            ["--cfg", TRAIN_CFG["abn"], *common, "--run", "abn", "--set",
             *sets, "MODEL.BASELINE", "True", "TRAIN.NUM_EPOCHS", "1",
             "LOG.ITER_VAL", "1", "LOG.ITER_TARGET", "1", *DATASET_SETS],
            0, 4, device, card, phase="dataset")
        need(all(isinstance(ds, packed.PackedDataset) for ds in (
            abn.loaders.source, abn.loaders.target)),
             "ABN: a train split not served from its pack")
        # one validation round: every frame of the four val splits
        routes("abn", 3 * DATASET_VAL + DATASET_TGT[0])
        abn_last = os.path.join(abn.args.snapshot_dir, "last.pth")
        del abn
        torch.cuda.empty_cache()
        sac, stages["sac"] = run_train_stage(
            ce, ce_triton, "dataset_sac",
            ["--cfg", TRAIN_CFG["sac"], *common, "--run", "sac",
             "--resume", abn_last, "--set", *sets, "TRAIN.NUM_EPOCHS", "2",
             "LOG.ITER_VAL", "100", "LOG.ITER_TARGET", "100",
             *DATASET_SETS], 2, 3, device, card, phase="dataset")
        # the target groups are decoded from PNGs at the crop size
        routes("sac", 3 * sac.cfg.TRAIN.NUM_GROUPS)
        del sac
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["decodes_by_route"] = decodes
    out["train"] = {st: dict(
        steps=o["steps"], step_ms=o["step_ms"],
        loader_wait_ms=o["loader_wait_ms"], val_ms={
            k: v["total"] for k, v in o["val_ms"].items()},
        val_loader_wait_ms={k: v["loader_wait"]
                            for k, v in o["val_ms"].items()},
        ce_launches=o["ce_launches"]) for st, o in stages.items()}
    log("dataset: %s" % json.dumps(out))
    return stages


# ---------------------------------------------------------------------------
# phase 16: data-parallel training
# ---------------------------------------------------------------------------

DDP_RANKS = 2        # ranks of the gloo world on the one card
DDP_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_ddp")


def _split(a, k, n):
    b = a.shape[0] // n
    return a[k * b:(k + 1) * b]


def ddp_sac_shard(device, k, n):
    """Shard ``k`` of ``n`` of the flagship SAC batch (source frames and
    target groups split along axis 0 in rank order), augmented with a
    generator of its own, as each rank draws its own augmentation:
    ``(src_frames, src_lbls, views)``."""
    import torch

    from dasac_tpu_torch.aug import pipelines
    from dasac_tpu_torch.train import steps

    scfg = sac_step_config()
    src_i, src_l, tgt_i, tgt_l = (_split(a, k, n) for a in sac_batch(device))
    gen = torch.Generator(device=device).manual_seed(SEED + 1 + k)
    src = pipelines.augment_source_batch(
        gen, src_i, src_l, crop_hw=scfg.crop_hw, scale_range=scfg.src_scale,
        hflip=scfg.src_hflip, jitter=scfg.src_jitter, blur=scfg.src_blur,
        mean=scfg.src_mean, std=scfg.src_std)
    return (*src, steps.augment_target(scfg, gen, tgt_i, tgt_l))


def ddp_abn_shard(device, k, n):
    """Shard ``k`` of ``n`` of the flagship ABN batch, augmented as the ABN
    step does with a generator of its own: ``(src_frames, src_lbls,
    tgt_frames, tgt_lbls)``."""
    import torch

    from dasac_tpu_torch.train import steps

    gen = torch.Generator(device=device).manual_seed(SEED + 1 + k)
    return steps.augment_abn(abn_step_config(), gen,
                             tuple(_split(a, k, n) for a in abn_batch(device)))


# (b)'s steps: the flagship SAC and ABN steps, and the ABN step on a
# shallow r101 (one block a stage, full width, f32, as the card-vs-CPU
# checks run it) at the flagship ABN batch.  A live-BN step through the
# full 104 BN layers is chaotic: one step's parameter update moves by
# about half its norm when only the order of the batch's two halves
# changes (the emulation against itself; ``run_ddp_gloo`` prints it), far
# less at one block a stage in f32, so the full-depth ABN step is held to
# the emulation on its forward and the shallow one on everything.
DDP_KINDS = ("sac", "abn", "abn_shallow")


def ddp_step(kind, group):
    """(frames step, its inputs' builder, CE launches a step) of ``kind``."""
    from dasac_tpu_torch.train import steps

    if kind == "sac":
        return (steps.make_sac_views_step(sac_step_config(), group=group),
                ddp_sac_shard, {"nll_fwd": 2, "nll_bwd": 2})
    return (steps.make_abn_frames_step(abn_step_config(), group=group),
            ddp_abn_shard, {"nll_fwd": 2, "nll_bwd": 1})


def ddp_state(kind, device, group=None):
    import torch

    return flagship_state(device, group=group, **(
        dict(layers=(1, 1, 1, 1), dtype=torch.float32)
        if kind == "abn_shallow" else {}))


def state_snapshot(state):
    """Every tensor of the state the steps change: the model's parameters
    and buffers, the teacher and running_conf."""
    out = {"model." + k: v.detach().clone()
           for k, v in state.model.state_dict().items()}
    out.update({"teacher." + k: v.clone() for k, v in
                {**state.teacher_params, **state.teacher_stats}.items()})
    out["running_conf"] = state.running_conf.clone()
    return out


def _max_abs_diff(a, b):
    return max((x.double() - b[k].to(x.device).double()).abs().max().item()
               for k, x in a.items())


def run_ddp_one_rank(ce, ce_triton, device, card):
    """(a) One flagship SAC and one ABN step in a NCCL world of one, so
    every collective runs (SUM over one rank, divided by 1), then the same
    state and inputs with no group, twice.  Returns the launches."""
    import torch

    from dasac_tpu_torch.core import dist
    from dasac_tpu_torch.utils.sys_tools import find_free_port

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(find_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    t0 = time.perf_counter()
    dist.init(dist.launch_from_env(env), device)
    setup_s = time.perf_counter() - t0
    # cuDNN's deterministic algorithms: the step's remaining run-to-run
    # noise is that of its atomic adds (the bilinear upsampling's backward)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out, launches = dict(phase="ddp_one_rank", card=card,
                         backend=torch.distributed.get_backend(),
                         setup_s=setup_s), {}
    try:
        for kind in ("sac", "abn"):
            inputs = ddp_step(kind, None)[1](device, 0, 1)
            runs = {}
            for name, group in (("group", dist.group()), ("plain", None),
                                ("plain_again", None)):
                state = flagship_state(device, group=group)
                step, _, per_step = ddp_step(kind, group)
                reset_counts(ce, ce_triton)
                calls0 = dict(dist.CALLS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, *inputs)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got, paths, _ = read_counts(ce, ce_triton, per_step)
                runs[name] = dict(
                    metrics={k: v.detach().clone() for k, v in m.items()},
                    state=state_snapshot(state), ms=ms,
                    calls={k: dist.CALLS[k] - calls0[k] for k in calls0})
                if name == "group":
                    launches[kind] = got
                del state, m
                torch.cuda.empty_cache()
            g, a, b = runs["group"], runs["plain"], runs["plain_again"]
            need(all(torch.equal(g["metrics"][k], a["metrics"][k])
                     for k in a["metrics"]),
                 "ddp_one_rank %s: the losses differ with a group" % kind)
            d_group = _max_abs_diff(g["state"], a["state"])
            d_floor = _max_abs_diff(b["state"], a["state"])
            need(d_group <= 2 * d_floor,
                 "ddp_one_rank %s: state differs by %r with a group, by %r "
                 "between two runs without" % (kind, d_group, d_floor))
            need(g["calls"]["mean"] >= 2 and not a["calls"]["mean"],
                 "ddp_one_rank %s: collectives %s / %s" % (
                     kind, g["calls"], a["calls"]))
            out[kind] = dict(
                step_ms={n: r["ms"] for n, r in runs.items()},
                max_abs_diff_group_vs_plain=d_group,
                max_abs_diff_plain_vs_plain=d_floor,
                collectives_a_step=g["calls"],
                losses={k: float(v) for k, v in a["metrics"].items()
                        if v.dim() == 0})
            del runs, g, a, b, inputs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy()
    log("ddp_one_rank: %s" % json.dumps(out))
    return launches


def ddp_rank(rank, addr, card, t_spawn, world, device):
    """(b) One rank of a gloo world whose ranks all share ``device`` (the
    one card; CUDA tensors through gloo): its shard of one flagship SAC
    step and one ABN step, from the same state on every rank.  Writes what
    it measured, and rank 0 its state after each step, under
    ``DDP_BASE``."""
    import torch

    from dasac_tpu_torch.core import dist
    from dasac_tpu_torch.ops import ce, ce_triton

    start_s = time.time() - t_spawn
    # this script's settings (``main``), which a new process does not have:
    # no TF32, and the emulation's cuDNN choices
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    t0 = time.perf_counter()
    dist.init(dist.Launch(addr, world, rank, rank), device, backend="gloo")
    out = dict(rank=rank, card=card, start_s=start_s,
               setup_s=time.perf_counter() - t0)
    g = dist.group()
    try:
        for kind in DDP_KINDS:
            step, shard, per_step = ddp_step(kind, g)
            state = ddp_state(kind, device, g)
            inputs = shard(device, rank, world)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ce, ce_triton)
            # step 1 (cold) is the one held against the emulation; step 2
            # is timed
            m = step(state, *inputs)
            equal = dist.assert_replicas_equal(
                dist.state_tensors(state, device, group=g), device, g)
            if rank == 0:
                torch.save(dict(
                    metrics={k: v.detach().cpu() for k, v in m.items()},
                    state={k: v.cpu() for k, v in
                           state_snapshot(state).items()}),
                    os.path.join(DDP_BASE, "%s_rank0.pt" % kind))
            calls0 = dict(dist.CALLS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, *inputs)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            calls = {k: dist.CALLS[k] - calls0[k] for k in calls0}
            launches, paths, _ = read_counts(
                ce, ce_triton, {k: 2 * v for k, v in per_step.items()})
            peak = torch.cuda.max_memory_allocated()
            # the gradient all-reduce alone, at the step's bytes
            grads = [p.grad for p in state.model.parameters()]
            ar_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce_mean_(grads, g)
                torch.cuda.synchronize()
                ar_ms.append((time.perf_counter() - t0) * 1e3)
            out[kind] = dict(
                step_ms=step_ms, max_memory_allocated=peak,
                grad_allreduce_bytes=sum(t.numel() * t.element_size()
                                         for t in grads),
                grad_allreduce_ms=ar_ms,
                bn_collectives_a_step=calls["bn"] + calls["bn_grad"],
                collectives_a_step=calls, ce_launches=launches,
                ce_launches_by_path=paths, replica_tensors_equal=equal,
                losses={k: float(v) for k, v in m.items() if v.dim() == 0})
            del state, inputs, m, grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy()
    log("ddp_rank: %s" % json.dumps(out))
    with open(os.path.join(DDP_BASE, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)


def emulate_sac(state, shards, scfg):
    """The SAC step of ``len(shards)`` ranks in one process, by hand: per
    shard the teacher forward and refine; the teacher probabilities' batch
    averages averaged over the shards; per shard the pseudo-labels and the
    two losses, each backward scaled by 1/n, so the gradients are the
    shards' average; one SGD step; the metrics averaged."""
    import torch
    from torch.func import functional_call

    from dasac_tpu_torch.sac import core, refine

    n = len(shards)
    model, opt = state.model, state.optimizer
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else \
        torch.float32
    teacher = {**state.teacher_params, **state.teacher_stats}
    student = {**state.student_params(), **state.student_stats()}
    names = list(teacher)
    with torch.no_grad():
        slow_init, rc, diff = core.maybe_update_teacher(
            [teacher[k] for k in names], [student[k].detach() for k in names],
            state.slow_init, state.running_conf,
            momentum=scfg.net_momentum, threshold_beta=scfg.threshold_beta,
            do_update=(state.step % scfg.net_momentum_iter == 0
                       or not state.slow_init))
        refined, avgs = [], []
        for _, _, views in shards:
            t_logits, _ = functional_call(
                model, teacher, (views.frames_clean,),
                dict(train=False, update_stats=False))
            r, diags = refine.refine(
                t_logits, views.affine, views.affine_inv, views.padding,
                group_size=scfg.group_size, pool=scfg.pool,
                pool_on=scfg.pool_on, compute_dtype=rd, res=scfg.refine_res)
            refined.append(r)
            probs = diags["teacher_probs"]
            avgs.append(probs.reshape(-1, probs.shape[-1]).float().mean(0))
        # update_running_conf over one row holding the shards' average
        rc = core.update_running_conf(rc, (sum(avgs) / n)[None],
                                      scfg.stat_momentum, scfg.threshold_beta)
    opt.zero_grad(set_to_none=True)
    rows = []
    for (src_frames, src_lbls, views), r in zip(shards, refined):
        with torch.no_grad():
            pseudo, conf, _ = core.pseudo_labels(
                r, views.padding, rc, upper=scfg.run_conf_upper,
                lower=scfg.run_conf_lower, threshold_beta=scfg.threshold_beta,
                discount=scfg.conf_discount, compute_dtype=rd_pl)
        _, up = model(src_frames, train=True, update_stats=False)
        ce_src = core.cross_entropy_mean(up, src_lbls, impl=scfg.ce_impl)
        (ce_src / n).backward()
        del up
        _, up = model(views.frames_aug, train=True, update_stats=False)
        self_ce, per_class = core.focal_ce(
            up, pseudo, conf, rc, p=scfg.focal_p, use_conf=scfg.use_conf_loss,
            impl=scfg.ce_impl)
        (scfg.lr_target * self_ce / n).backward()
        del up
        rows.append(dict(src_loss_ce=ce_src.detach(),
                         self_ce=self_ce.detach(),
                         pseudo_cover=(pseudo != core.IGNORE).float().mean(),
                         self_ce_per_class=per_class))
    opt.step()
    state.running_conf, state.slow_init = rc, slow_init
    state.step += 1
    metrics = {k: sum(r[k] for r in rows) / n for k in rows[0]}
    metrics["teacher_diff"] = diff
    return metrics


def emulate_abn(state, shards, scfg):
    """The ABN step of ``len(shards)`` ranks in one process: one forward of
    the un-split batch (its live BN statistics are the cross-replica
    ones), the loss the mean of the shards' CE means, one SGD step, then
    the un-split target pass."""
    import torch

    from dasac_tpu_torch.sac import core

    n = len(shards)
    model, opt = state.model, state.optimizer

    def mean_of_shard_means(up, labels):
        b = up.shape[0] // n
        return sum(core.cross_entropy_mean(up[k * b:(k + 1) * b], lbl,
                                           impl=scfg.ce_impl)
                   for k, lbl in enumerate(labels)) / n

    opt.zero_grad(set_to_none=True)
    _, up = model(torch.cat([s[0] for s in shards]), train=True,
                  update_stats=True)
    ce_src = mean_of_shard_means(up, [s[1] for s in shards])
    ce_src.backward()
    del up
    opt.step()
    with torch.no_grad():
        _, up = model(torch.cat([s[2] for s in shards]), train=True,
                      update_stats=True)
        ce_tgt = mean_of_shard_means(up, [s[3] for s in shards])
    state.step += 1
    return {"src_loss_ce": ce_src.detach(), "loss_ce": ce_tgt}


def emulate_ddp(kind, device, shards):
    """The emulated step of ``kind`` from the ranks' state on ``shards``:
    {"before": parameters, "metrics", "state": ``state_snapshot``}."""
    state = ddp_state(kind, device)
    before = {k: p.detach().clone() for k, p in
              state.model.named_parameters()}
    if kind == "sac":
        m = emulate_sac(state, shards, sac_step_config())
    else:
        m = emulate_abn(state, shards, abn_step_config())
    return dict(before=before, metrics=m, state=state_snapshot(state))


def _update_rel_err(got, ref, device):
    """|| update(got) - update(ref) || / || update(ref) || over every
    parameter, an update being the parameters after less before."""
    num = den = 0.0
    for k, b in ref["before"].items():
        d_ref = (ref["state"]["model." + k] - b).double()
        d_got = (got["state"]["model." + k].to(device) - b).double()
        num += float(((d_got - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    return math.sqrt(num / max(den, 1e-30))


def compare_ddp(got, ref, device):
    """Rank 0's step against the emulation's: what lies outside rtol 1e-3
    / atol 1e-5 (name, max abs diff), the update's relative error, the
    largest difference and both sides' losses."""
    import torch

    need(set(got["state"]) == set(ref["state"]), "state keys")
    pairs = ([(k, got["metrics"][k].float(), v.float().cpu())
              for k, v in ref["metrics"].items()]
             + [(k, got["state"][k], v.cpu())
                for k, v in ref["state"].items()])
    off = [(k, _max_abs_diff({k: x}, {k: y})) for k, x, y in pairs
           if not torch.allclose(x.to(y.dtype), y, rtol=1e-3, atol=1e-5)]
    return dict(
        update_rel_err=_update_rel_err(got, ref, device),
        outside_tolerance=off[:20], n_outside_tolerance=len(off),
        max_abs_diff=_max_abs_diff(
            {k: v for k, v in got["state"].items()
             if v.is_floating_point()}, ref["state"]),
        losses_ranks={k: float(v) for k, v in got["metrics"].items()
                      if v.dim() == 0},
        losses_emulated={k: float(v) for k, v in ref["metrics"].items()
                         if v.dim() == 0})


def run_ddp_gloo(device, card):
    """(b) ``DDP_RANKS`` spawned ranks on the one card over gloo
    (``ddp_rank``), then each step emulated in this process from the same
    state and shards (``emulate_sac``, ``emulate_abn``).  SAC and the
    shallow ABN step: rank 0's losses, parameters, BN buffers, teacher and
    running_conf within rtol 1e-3 / atol 1e-5 of the emulation's, and the
    parameter update (after less before) within a relative norm error of
    5e-2 over the whole model.  The full-depth ABN step: its source loss
    (the forward) within rtol 1e-3; the rest is printed beside the
    emulation's own difference when the batch's halves are swapped (see
    ``DDP_KINDS``).  Returns each rank's measurements."""
    import shutil

    import torch

    from dasac_tpu_torch.utils.sys_tools import find_free_port

    shutil.rmtree(DDP_BASE, ignore_errors=True)
    os.makedirs(DDP_BASE)
    torch.cuda.empty_cache()
    addr = "127.0.0.1:%d" % find_free_port()
    # the ranks' cuDNN settings, for the emulation
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.time()
        torch.multiprocessing.spawn(
            ddp_rank, args=(addr, card, t0, DDP_RANKS, str(device)),
            nprocs=DDP_RANKS, join=True)
        spawn_s = time.time() - t0
        ranks = []
        for r in range(DDP_RANKS):
            with open(os.path.join(DDP_BASE, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        out = dict(phase="ddp_gloo", card=card, ranks=DDP_RANKS,
                   backend="gloo", spawn_and_steps_s=spawn_s)
        for kind in DDP_KINDS:
            _, shard, _ = ddp_step(kind, None)
            shards = [shard(device, k, DDP_RANKS) for k in range(DDP_RANKS)]
            got = torch.load(os.path.join(DDP_BASE, "%s_rank0.pt" % kind),
                             weights_only=True)
            ref = emulate_ddp(kind, device, shards)
            o = out[kind] = compare_ddp(got, ref, device)
            if kind == "abn":
                # the noise floor: the emulation with the halves swapped
                floor = emulate_ddp(kind, device, shards[::-1])
                o["update_rel_err_swapped_emulation"] = _update_rel_err(
                    floor, ref, device)
                o["loss_ce_swapped_emulation"] = float(
                    floor["metrics"]["loss_ce"])
                del floor
            log("ddp_gloo %s: %s" % (kind, json.dumps(o)))
            if kind == "abn":
                need(not [k for k, _ in o["outside_tolerance"]
                          if k == "src_loss_ce"],
                     "abn: the forward differs: %s" % o["outside_tolerance"])
            else:
                need(not o["outside_tolerance"],
                     "%s: rank 0 and the emulation differ beyond rtol 1e-3 "
                     "/ atol 1e-5: %s" % (kind, o["outside_tolerance"][:5]))
                need(o["update_rel_err"] < 5e-2, "%s: update rel err %.4f"
                     % (kind, o["update_rel_err"]))
            del shards, got, ref
            torch.cuda.empty_cache()
            torch.cuda.empty_cache()
        log("ddp_gloo: %s" % json.dumps(out))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(DDP_BASE, ignore_errors=True)
    return ranks


def run_ddp(ce, ce_triton, device, card):
    """Phase 16: (a) the NCCL world of one: bare steps (``run_ddp_one_rank``)
    and phase 10's CLI stages on its root (``run_train(world=True)``); (b)
    two gloo ranks on the card (``run_ddp_gloo``).  Returns the CE launches
    by part."""
    import shutil

    try:
        one = run_ddp_one_rank(ce, ce_triton, device, card)
        cli = run_train(ce, ce_triton, device, card, world=True)
        ranks = run_ddp_gloo(device, card)
    finally:
        shutil.rmtree(TRAIN_BASE, ignore_errors=True)
    return dict(nccl_steps=one,
                nccl_cli={st: o["ce_launches"] for st, o in cli.items()},
                gloo_ranks=[{kind: r[kind]["ce_launches"]
                             for kind in DDP_KINDS} for r in ranks])


# ---------------------------------------------------------------------------

RECIPE_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_recipe")
# the recipe cut to the smoke: 16 GTA-sized source frames (two batches: the
# trainer prints an epoch's first step once the second is launched, and
# the gate reads those lines), 4 Cityscapes-sized target frames and 2
# frames a val split at native sizes; ABN epochs 0..1, SAC and the control
# epoch 2; the gate reported, not enforced (two epochs cannot converge)
RECIPE_N = {"--n-src": 16, "--n-tgt": 4, "--n-val": 2}
RECIPE_ARGS = [a for k, v in RECIPE_N.items() for a in (k, str(v))] + [
    "--epochs1", "1", "--epochs2", "1", "--gate-ce", "inf"]
# CE launches a step: ABN and the control 2 + 1 (source and target CE,
# the source backward); target-only SAC 1 + 1 (the self-supervised CE)
RECIPE_PER_STEP = {"abn": (2, 1), "sac": (1, 1), "control": (2, 1)}


def run_recipe(ce, ce_triton, device, card):
    """Phase 17: ``tools.recipe`` end to end in this process, on a cut
    corpus at native sizes, r101 at full width; returns the CE launches of
    each train stage."""
    import shutil

    import torch

    from dasac_tpu_torch.data import png, sampler
    from dasac_tpu_torch.tools import recipe

    work = RECIPE_BASE
    prior = 0.25  # DATASET.SAMPLE_UNIFORM_PRIOR of the config
    out = os.path.join(work, "records.jsonl")
    shutil.rmtree(work, ignore_errors=True)
    try:
        fresh_cudnn()
        reset_counts(ce, ce_triton)
        t0 = time.perf_counter()
        records = recipe.main(["--work", work, "--out", out] + RECIPE_ARGS,
                              device=device.type)
        wall = time.perf_counter() - t0
        launches = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
        triton_launches = dict(ce_triton.LAUNCHES)
        need(torch.backends.cudnn.benchmark == (device.type == "cuda"),
             "the recipe's entry points did not set cuDNN autotuning")
        with open(out) as f:
            need([json.loads(line) for line in f]
                 == json.loads(json.dumps(records)),
                 "the records file differs from the records returned")
        need([r["stage"] for r in records]
             == ["abn", "gate", "export", "weights", "sac", "control"]
             + ["eval"] * 7 + ["summary"],
             "recipe stages %s" % [r["stage"] for r in records])
        by = {(r["stage"], r.get("model"), r.get("domain")): r
              for r in records}
        stages = {st: by[(st, None, None)] for st in RECIPE_PER_STEP}

        # train stages: steps, finite step times, every CE launch bulk,
        # as many as the steps make, none outside them, no Triton
        total = {k: 0 for k in ce.PATH_LAUNCHES}
        for st, (fwd, bwd) in RECIPE_PER_STEP.items():
            r = stages[st]
            by_path = r["ce_launches_by_path"]
            want = {"nll_fwd": fwd * r["steps"], "nll_bwd": bwd * r["steps"]}
            need(r["steps"] > 0 and math.isfinite(r["step_ms"]),
                 "%s: %s steps, %s ms" % (st, r["steps"], r["step_ms"]))
            need(by_path == {k: {"bulk": n, "strided": 0}
                             for k, n in want.items()},
                 "%s: CE launches %s, want %s all bulk" % (st, by_path, want))
            for k in total:
                total[k] += by_path[k]["bulk"]
        need(launches == {k: {"bulk": n, "strided": 0}
                          for k, n in total.items()},
             "CE launches outside the train stages: %s vs %s"
             % (launches, total))
        need(not any(triton_launches.values()),
             "the Triton yardstick ran in the recipe: %s" % triton_launches)

        # SAC ran target-only with the IS weights; the weights read back
        # with class densities moved from uniform
        sac = stages["sac"]
        weights = os.path.join(work, "cs_weights.data")
        need(sac["target_only"] is True and sac["sample_weights"] == weights,
             "SAC stage: target_only %s, weights %s"
             % (sac["target_only"], sac["sample_weights"]))
        with open(os.path.join(work, "stage4_sac.log")) as f:
            src_ce = [float(v) for v in
                      re.findall(r"src_loss_ce ([0-9.eE+-]+)", f.read())]
        need(src_ce and not any(src_ce),
             "target-only SAC logged a source CE: %s" % src_ce)
        masks = sorted(f for f in os.listdir(os.path.join(work, "masks_tgt"))
                       if f.endswith(".png"))
        need(masks == ["tgt_%03d.png" % i for i in range(RECIPE_N["--n-tgt"])]
             and by[("export", None, None)]["masks"] == len(masks),
             "exported masks %s" % masks)
        w = sampler.load_sample_weights(weights)
        need(sorted(w) == masks, "IS weights cover %s" % sorted(w))
        shifted = recipe.shifted_classes(sampler.ImportanceSampler(
            len(masks), C, mask_names=masks, weights=w, prior_weight=prior))
        # the classes whose share of pixels differs between the exported
        # masks, counted here: the densities can move only for those (a
        # collapsed two-epoch ABN that predicts one class everywhere
        # gives uniform weights, and the line says so)
        counts = np.stack([np.bincount(
            png.read(os.path.join(work, "masks_tgt", m)).pixels.reshape(-1),
            minlength=256)[:C] for m in masks]).astype(np.float64)
        share = counts / np.maximum(counts.sum(0), 1)
        want = [c for c in range(C) if counts[:, c].any() and (1 - prior)
                * np.abs(share[:, c] - 1 / len(masks)).max() > 1e-3]
        need(shifted == want == sac["is_shifted_classes"],
             "IS class densities moved from uniform: %s, the SAC stage's "
             "sampler %s, from the masks' pixel counts %s"
             % (shifted, sac["is_shifted_classes"], want))

        mious = {"_".join(k): dict(miou=r["miou"], jax_miou=r.get(
            "jax_miou")) for k, r in by.items() if "miou" in r}
        need(len(mious) == 8 and all(
            math.isfinite(v["miou"]) and 0.0 <= v["miou"] <= 1.0
            for v in mious.values()), "mIoUs %s" % mious)
        gate = by[("gate", "abn", "source")]
        need(math.isfinite(gate["src_ce_tail"]), "gate CE %s"
             % gate["src_ce_tail"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps(dict(
        phase="recipe", card=card, wall_s=wall,
        corpus={k.lstrip("-"): v for k, v in RECIPE_N.items()},
        gate=dict(enforced=False, gate_ce=gate["gate_ce"],
                  src_ce_tail=gate["src_ce_tail"],
                  note="reported, not enforced: two ABN epochs cannot "
                       "converge; the gate guards device time"),
        stages={st: {k: r[k] for k in ("wall_s", "steps", "step_ms",
                                       "peak_gb", "ce_launches_by_path",
                                       "start_epoch")}
                for st, r in stages.items()},
        export_s=by[("export", None, None)]["wall_s"],
        is_shifted_classes=shifted,
        mask_classes=[c for c in range(C) if counts[:, c].any()],
        miou=mious,
        summary_wall_s=records[-1]["wall_s"])))
    return {st: {k: by_path["bulk"] for k, by_path in
                 stages[st]["ce_launches_by_path"].items()}
            for st in stages}


# ---------------------------------------------------------------------------
# phase 18: inference over a world of ranks (height sharding)
# ---------------------------------------------------------------------------

MESH_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "smoke_infer_mesh")
MESH_FRAMES = 4      # frames of (a)'s synthetic Cityscapes-val root
MESH_RANKS = 4       # (b)'s gloo ranks on the one card
# 1052 rows (GTA's canonical height) tile 2 and 4 ranks; 1050 rows do not,
# and edge-pad to 1052 with 4 ranks a frame, as dasac_tpu pads
MESH_PAD_HW = (1050, 1914)
MESH_SETTINGS = {"single": dict(scales=(1.0,), fuse="full"),
                 "multi_flip_stride8": dict(scales=(0.75, 1.0, 1.25),
                                            flip=True, fuse="stride8")}
# (b)'s cases: (dtype, setting, layout); "pair": each pair of ranks on its
# own frame (the 2 x 2 combined mesh, spatial=2: two 2-rank frames),
# "world": all 4 ranks on one frame (spatial=-1); "pad": the 1050-row frame
# over the 4 ranks.  f32 without TF32: probabilities within 1e-4, labels
# equal on >= 99.99% of pixels; bf16: labels on >= 99.9% (runs of the
# same case gave 99.932% to 99.998%: cuDNN's bf16 algorithms differ by a
# strip's shape, and these random weights leave many near-ties; PERF.md)
MESH_CASES = [(dt, st, lay) for dt in ("float32", "bfloat16")
              for st in MESH_SETTINGS for lay in ("pair", "world")] + [
    ("float32", "single", "pad")]
MESH_TOL = {"float32": dict(prob_abs=1e-4, label_share=0.9999),
            "bfloat16": dict(prob_abs=None, label_share=0.999)}


def mesh_frames():
    """(two 1024x2048 frames, the 1050x1914 frame), uint8 from
    ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    two = rng.randint(0, 256, (2, *INFER_HW, 3), dtype=np.uint8)
    return two, rng.randint(0, 256, (1, *MESH_PAD_HW, 3), dtype=np.uint8)


def mesh_case_input(layout, d):
    """The frame (numpy ``[1, H, W, 3]``) data index ``d`` works on."""
    from dasac_tpu_torch.infer import engine

    two, pad = mesh_frames()
    if layout == "pad":
        return engine.pad_to_tile(pad, MESH_RANKS)
    return two[d:d + 1]


def _calls_since(calls0):
    from dasac_tpu_torch.core import dist

    return {k: dist.CALLS[k] - v for k, v in calls0.items()
            if k.startswith("exchange")}


def run_infer_mesh_one_rank(ce, ce_triton, device, card):
    """(a) A NCCL world of one in this process: ``run_inference`` over a
    synthetic 4-frame Cityscapes-val root with the world's group and with
    none (labels and confusion bit-equal), then ``bench_infer --mode
    batch`` and ``--mode spatial --sp 1`` through the world."""
    import glob
    import shutil

    import torch

    from dasac_tpu_torch.core import dist
    from dasac_tpu_torch.data import png
    from dasac_tpu_torch.infer import engine
    from dasac_tpu_torch.tools import bench_infer
    from dasac_tpu_torch.utils.sys_tools import find_free_port

    root = os.path.join(MESH_BASE, "root")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(find_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    out = dict(phase="infer_mesh_one_rank", card=card)
    write_cityscapes_val(root, card, MESH_FRAMES)
    t0 = time.perf_counter()
    dist.init(dist.launch_from_env(env), device)
    out["setup_s"] = time.perf_counter() - t0
    out["backend"] = torch.distributed.get_backend()
    try:
        state = flagship_state(device)
        cfg = abn_step_config()
        ds = engine.InferDataset(root, "val_cityscapes",
                                 cityscapes_names=True)
        fresh_cudnn()
        runs = {}
        for name, group in (("group", dist.group()), ("plain", None)):
            calls0 = dict(dist.CALLS)
            reset_counts(ce, ce_triton)
            t0 = time.perf_counter()
            conf = engine.run_inference(
                state.model, ds, os.path.join(MESH_BASE, name),
                mean=cfg.mean, std=cfg.std, verbose=False, device=device,
                group=group)
            wall = time.perf_counter() - t0
            got = read_counts(ce, ce_triton, {"nll_fwd": 0, "nll_bwd": 0})[0]
            if name == "group":
                launches = got
            files = sorted(glob.glob(os.path.join(MESH_BASE, name, "*.png")))
            need(len(files) == MESH_FRAMES, "%s: %d exports" % (name,
                                                               len(files)))
            runs[name] = dict(conf=conf, wall_s=wall, labels=[
                png.read(f).pixels for f in files],
                calls=_calls_since(calls0))
        g, p = runs["group"], runs["plain"]
        need(np.array_equal(g["conf"], p["conf"]) and all(
            np.array_equal(a, b) for a, b in zip(g["labels"], p["labels"])),
            "infer_mesh: run_inference in a world of one differs from the "
            "run with no group")
        need(not g["calls"]["exchange"], "a world of one exchanged rows")
        out["run_inference_wall_s"] = {k: r["wall_s"] for k, r in
                                       runs.items()}
        out["labels_bit_equal"] = True
        del state
        torch.cuda.empty_cache()
        bench = {}
        for mode, flags in (("batch", ["--mode", "batch"]),
                            ("spatial_sp1", ["--mode", "spatial", "--sp",
                                             "1"])):
            fresh_cudnn()
            rec = bench_infer.main([*flags, "--output", "argmax", "--iters",
                                    "5"], device=device)
            need(rec["value"] > 0 and rec["world"] == 1
                 and rec["devices"] == 1 and rec["cudnn_benchmark"],
                 "bench_infer %s: %s" % (mode, rec))
            bench[mode] = {k: rec[k] for k in (
                "latency_ms_per_frame", "mesh", "devices", "world",
                "transport", "exchanges_per_forward", "peak_allocated_gb")}
            torch.cuda.empty_cache()
        out["bench_infer"] = bench
    finally:
        dist.destroy()
        shutil.rmtree(MESH_BASE, ignore_errors=True)
    log("infer_mesh_one_rank: %s" % json.dumps(out))
    return launches


def mesh_rank(rank, addr, card, t_spawn, device):
    """(b) One of ``MESH_RANKS`` gloo ranks sharing the card: every case of
    ``MESH_CASES``, its rows of the probabilities (f32) or labels (bf16)
    written under ``MESH_BASE`` for the parent to hold against the
    unsharded forward, with its ms per frame, exchanges and bytes a
    forward by layer kind, and peak memory."""
    import torch

    from dasac_tpu_torch.core import dist, mesh
    from dasac_tpu_torch.infer import engine
    from dasac_tpu_torch.nn.spatial import Sharded

    start_s = time.time() - t_spawn
    # this script's settings (``main``), which a new process does not have
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.benchmark = False
    device = torch.device(device)
    device = torch.device(device.type, device.index or 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    dist.init(dist.Launch(addr, MESH_RANKS, rank, rank), device,
              backend="gloo")
    # every rank creates every group: the pairs of the 2 x 2 mesh
    pair = mesh.sp_group(mesh.infer_mesh(MESH_RANKS, None, 2), rank)
    groups = {"pair": pair, "world": dist.group(), "pad": dist.group()}
    out = dict(rank=rank, card=card, start_s=start_s,
               setup_s=time.perf_counter() - t0,
               transport=dist.transport(pair), cases={})
    cfg = abn_step_config()
    try:
        models = {}
        for dt, setting, layout in MESH_CASES:
            dtype = getattr(torch, dt)
            if dt not in models:
                models.clear()
                torch.cuda.empty_cache()
                models[dt] = flagship_state(device, dtype=dtype).model
            sharded = Sharded(groups[layout])
            d = rank // 2 if layout == "pair" else 0
            frame = torch.from_numpy(mesh_case_input(layout, d)).to(device)
            fn = engine.make_infer_fn(
                models[dt], cfg.mean, cfg.std, device=device,
                sharded=sharded, **MESH_SETTINGS[setting])
            fn(frame)   # warm-up: cuDNN's choices, the allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier(device, groups[layout])
            calls0 = dict(dist.CALLS)
            t0 = time.perf_counter()
            probs = fn(frame)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            calls = _calls_since(calls0)
            lo, hi = sharded.own(frame.shape[1])
            key = "%s_%s_%s" % (dt, setting, layout)
            torch.save(dict(
                rows=(lo, hi),
                labels=probs.argmax(-1).to(torch.uint8).cpu(),
                probs=probs.cpu() if dt == "float32" else None),
                os.path.join(MESH_BASE, "%s_rank%d.pt" % (key, rank)))
            out["cases"][key] = dict(
                ms_per_frame=ms, rows=[lo, hi], exchanges=calls,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            del probs, fn
    finally:
        dist.destroy()
    log("infer_mesh_rank: %s" % json.dumps(out))
    with open(os.path.join(MESH_BASE, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)


def run_infer_mesh_gloo(device, card):
    """(b) ``MESH_RANKS`` spawned ranks on the card over gloo
    (``mesh_rank``), then every case's unsharded forward in this process
    on the same frames (the padded frame on its padded canvas), held
    against the ranks' rows assembled."""
    import shutil

    import torch

    from dasac_tpu_torch.infer import engine
    from dasac_tpu_torch.utils.sys_tools import find_free_port

    shutil.rmtree(MESH_BASE, ignore_errors=True)
    os.makedirs(MESH_BASE)
    torch.backends.cudnn.benchmark = False
    cfg = abn_step_config()
    out = dict(phase="infer_mesh_gloo", card=card, ranks=MESH_RANKS,
               backend="gloo", cases={})
    try:
        t0 = time.time()
        torch.multiprocessing.spawn(
            mesh_rank, args=("127.0.0.1:%d" % find_free_port(), card, t0,
                             str(device)),
            nprocs=MESH_RANKS, join=True)
        out["spawn_and_cases_s"] = time.time() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(MESH_BASE, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        models = {}
        for dt, setting, layout in MESH_CASES:
            if dt not in models:
                models.clear()
                torch.cuda.empty_cache()
                models[dt] = flagship_state(device,
                                            dtype=getattr(torch, dt)).model
            key = "%s_%s_%s" % (dt, setting, layout)
            fn = engine.make_infer_fn(models[dt], cfg.mean, cfg.std,
                                      device=device, **MESH_SETTINGS[setting])
            parts = [torch.load(os.path.join(MESH_BASE, "%s_rank%d.pt"
                                             % (key, r)), weights_only=True)
                     for r in range(MESH_RANKS)]
            frames = [list(range(0, 2)), list(range(2, 4))] \
                if layout == "pair" else [list(range(MESH_RANKS))]
            res = dict(card=card,
                       ms_per_frame=[ranks[r]["cases"][key]["ms_per_frame"]
                                     for r in range(MESH_RANKS)],
                       peak_gb=[ranks[r]["cases"][key]["peak_gb"]
                                for r in range(MESH_RANKS)],
                       exchanges=[ranks[r]["cases"][key]["exchanges"]
                                  for r in range(MESH_RANKS)])
            agree, prob_err = [], 0.0
            for d, members in enumerate(frames):
                frame = torch.from_numpy(mesh_case_input(layout, d)).to(
                    device)
                ref = fn(frame)
                if d == 0:   # the same program in one process, warm,
                    # and its labels against its own first call's
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    again = fn(frame)
                    torch.cuda.synchronize()
                    res["unsharded_ms"] = (time.perf_counter() - t0) * 1e3
                    res["unsharded_repeat_label_agreement"] = float(
                        (again.argmax(-1) == ref.argmax(-1)).float().mean())
                    del again
                rows = [tuple(parts[r]["rows"]) for r in members]
                need(rows[0][0] == 0 and rows[-1][1] == frame.shape[1]
                     and all(a[1] == b[0] for a, b in zip(rows, rows[1:])),
                     "%s: the ranks' rows %s do not tile the frame"
                     % (key, rows))
                labels = torch.cat([parts[r]["labels"] for r in members],
                                   1).to(device)
                if layout == "pad":   # the frame's rows of the canvas
                    ref, labels = (ref[:, :MESH_PAD_HW[0]],
                                   labels[:, :MESH_PAD_HW[0]])
                agree.append(float((labels == ref.argmax(-1).to(
                    torch.uint8)).float().mean()))
                if dt == "float32":
                    probs = torch.cat([parts[r]["probs"] for r in members],
                                      1).to(device)
                    if layout == "pad":
                        probs = probs[:, :MESH_PAD_HW[0]]
                    prob_err = max(prob_err, float(
                        (probs - ref).abs().max()))
                del ref, labels
            tol = MESH_TOL[dt]
            res.update(label_agreement=agree, tol=tol,
                       prob_max_abs_err=prob_err if dt == "float32"
                       else None)
            out["cases"][key] = res
            log("infer_mesh_gloo %s: %s" % (key, json.dumps(res)))
            need(min(agree) >= tol["label_share"],
                 "%s: labels agree on %s of pixels, want >= %s"
                 % (key, agree, tol["label_share"]))
            need(tol["prob_abs"] is None or prob_err <= tol["prob_abs"],
                 "%s: probabilities differ by %r > %r"
                 % (key, prob_err, tol["prob_abs"]))
            need(all(e["exchange"] > 0 and e["exchange_bytes"] > 0
                     for e in res["exchanges"]),
                 "%s: a rank exchanged no rows" % key)
            del parts, fn
            torch.cuda.empty_cache()
        out["transport"] = sorted({r["transport"] for r in ranks})
        out["rank_setup_s"] = [r["setup_s"] for r in ranks]
        out["rank_start_s"] = [r["start_s"] for r in ranks]
        log("infer_mesh_gloo: %s" % json.dumps(out))
    finally:
        shutil.rmtree(MESH_BASE, ignore_errors=True)
    return out


def run_infer_mesh(ce, ce_triton, device, card):
    """Phase 18: (a) the NCCL world of one (``run_infer_mesh_one_rank``);
    (b) ``MESH_RANKS`` gloo ranks on the card (``run_infer_mesh_gloo``).
    Returns the CE launches of (a)'s ``run_inference`` runs (none:
    inference runs no CE kernel, and ``read_counts`` fails on any)."""
    launches = run_infer_mesh_one_rank(ce, ce_triton, device, card)
    run_infer_mesh_gloo(device, card)
    return launches


# ---------------------------------------------------------------------------
# phase 19: remat (TPU.REMAT) for the three archs, and MODEL.OPT adam
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "block", "convs")
REMAT_ABN_STEPS = 6  # ABN steps timed a mode, the first 2 warm-up
REMAT_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_remat")


def run_steps(step, state, batch, gen, n, label):
    """``n`` calls of ``step`` with the peak memory reset before: (step ms
    per call, peak GB, scalar metrics per call, all finite)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    for i in range(n):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        row = {k: float(v) for k, v in m.items() if v.dim() == 0}
        for k, v in row.items():
            need(math.isfinite(v), "%s step %d: %s = %r" % (label, i, k, v))
        rows.append(row)
    return times, torch.cuda.max_memory_allocated() / 1e9, rows


def _rel_l2(got, ref):
    return float((got.float() - ref.float()).norm()
                 / (ref.float().norm() + 1e-30))


def remat_sac(ce, ce_triton, device, card):
    """(a) The flagship SAC step (phase 4's batch and weights) under each
    remat mode: the first step through the views step with its gradients
    (loss within rtol 1e-3 of none's, each parameter's gradient within a
    relative L2 error of 2e-2, tests/test_remat_modes.py's bound: cuDNN
    may pick other algorithms in the replay), then ``N_STEPS`` steps
    timed; launches 2 + 2 a step, all bulk, the same in every mode."""
    import torch

    from dasac_tpu_torch.train import steps

    scfg = sac_step_config()
    batch = sac_batch(device)
    ref, out, launches = None, {}, {}
    for mode in REMAT_MODES:
        state = flagship_state(device, remat=mode)
        gen = torch.Generator(device=device).manual_seed(SEED)
        reset_counts(ce, ce_triton)
        first = steps.make_sac_views_step(scfg, debug=True)(
            state, *steps.augment_sac(scfg, gen, batch), gen)
        loss = {k: float(first[k]) for k in ("src_loss_ce", "self_ce")}
        grads = {k: g.cpu() for k, g in first["grads"].items()}
        del first
        if ref is None:
            ref = (loss, grads)
            worst = 0.0
        else:
            for k, v in loss.items():
                need(math.isclose(v, ref[0][k], rel_tol=1e-3, abs_tol=1e-6),
                     "remat %s first-step %s %r vs none %r"
                     % (mode, k, v, ref[0][k]))
            rel = {k: _rel_l2(g, ref[1][k]) for k, g in grads.items()}
            worst_k = max(rel, key=rel.get)
            worst = rel[worst_k]
            need(worst < 2e-2, "remat %s: gradient of %s off none's by "
                 "rel L2 %.3e" % (mode, worst_k, worst))
        del grads
        step = steps.make_sac_step(scfg, device=device)
        times, peak, rows = run_steps(step, state, batch, gen, N_STEPS,
                                      "remat sac " + mode)
        got, paths, _ = read_counts(ce, ce_triton, {
            "nll_fwd": 2 * (N_STEPS + 1), "nll_bwd": 2 * (N_STEPS + 1)})
        launches[mode] = got
        out[mode] = dict(
            step_ms=times,
            step_ms_median=statistics.median(times[WARMUP_STEPS:]),
            peak_gb=peak, first_step=loss, grad_rel_l2_worst=worst,
            losses=rows, ce_launches=got, ce_launches_by_path=paths)
        log("remat_sac %s: %s" % (mode, json.dumps(dict(out[mode],
                                                        card=card))))
        del state, step
        torch.cuda.empty_cache()
    need(all(v == launches["none"] for v in launches.values()),
         "CE launches differ between remat modes: %s" % launches)
    return out, launches


def _device_kernels(prof):
    """{kernel name: launches} of the device kernels ``prof`` traced."""
    import torch

    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def remat_drift(ce, ce_triton, device, card):
    """(b0) Why the bf16 ABN source half's gradients under block can
    differ from none's: cuDNN keeps its chosen plans per thread, and the
    replay runs in autograd's thread, not the forward's; an autotuned
    choice (timed) can differ between the two threads, a heuristic one
    does not.  The flagship model's source half (one live-BN forward and
    its backward) under none and block, cuDNN deterministic, with
    autotuning off (on the source half's frames, before any plan exists
    for them) and then on (a frame fewer: fresh shapes, timed in both
    threads): each convolution's replayed output
    held bit for bit against its forward output (a checksum from a forward
    hook; the replay is a conv's second call, early stop off), the
    allocator's out-of-memory events in the backward (a cuDNN workspace
    that does not fit makes cuDNN take its next plan), the device kernels
    of the forward
    and of the backward under the profiler (block's backward less none's
    are the replay's; a replay kernel the forward did not launch is
    another algorithm), and the gradients' worst relative L2 difference.
    Reported here; ``remat_abn`` asserts the bound with autotuning off,
    on the heuristic plans chosen here.  Launches 1 + 1 a run, all
    bulk."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from dasac_tpu_torch.nn.layers import Conv2d
    from dasac_tpu_torch.sac import core as sac_core
    from dasac_tpu_torch.train import steps

    scfg = abn_step_config()
    batch = abn_batch(device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out, bench0 = {}, torch.backends.cudnn.benchmark
    reset_counts(ce, ce_triton)
    try:
        torch.backends.cudnn.deterministic = True
        # heuristic plans first, on the source half's own shapes (the
        # plans ``remat_abn`` then reuses), then autotuned ones on a frame
        # fewer (shapes no plan was chosen for yet in either thread)
        for bench, frames in ((False, ABN_SRC[0]), (True, ABN_SRC[0] - 1)):
            torch.backends.cudnn.benchmark = bench
            grads, kernels, replay = {}, {}, {}
            for mode in ("none", "block"):
                state = flagship_state(device, remat=mode)
                seen = {}

                def hook(mod, inp, y, seen=seen):
                    # a checksum of each call's output: the forward's and
                    # the replay's, compared bit for bit below
                    seen.setdefault(mod, []).append(
                        y.detach().contiguous().view(torch.int16)
                        .to(torch.int64).mul_(7919).sum().item())

                convs = {m: k for k, m in state.model.named_modules()
                         if isinstance(m, Conv2d)}
                handles = [m.register_forward_hook(hook) for m in convs]
                src, lbl = (a[:frames] for a in steps.augment_abn(
                    scfg, torch.Generator(device=device).manual_seed(
                        SEED + 1), batch)[:2])
                with profile(activities=acts) as prof:
                    _, up = state.model(src, train=True, update_stats=True)
                    loss = sac_core.cross_entropy_mean(up, lbl,
                                                       impl="kernel")
                    torch.cuda.synchronize()
                fwd = _device_kernels(prof)
                ooms0 = torch.cuda.memory_stats().get("num_ooms", 0)
                free_gb = torch.cuda.mem_get_info()[0] / 1e9
                # the whole replay runs (no early stop), so every replayed
                # conv's hook fires
                with profile(activities=acts) as prof, \
                        set_checkpoint_early_stop(False):
                    loss.backward()
                    torch.cuda.synchronize()
                kernels[mode] = (fwd, _device_kernels(prof))
                for h in handles:
                    h.remove()
                if mode == "block":
                    pairs = {convs[m]: v for m, v in seen.items()
                             if len(v) == 2}
                    diff = sorted(k for k, v in pairs.items()
                                  if v[0] != v[1])
                    replay.update(
                        convs=len(convs), replayed=len(pairs),
                        replay_differs=diff,
                        free_gb_before_backward=free_gb,
                        allocator_ooms_in_backward=torch.cuda.memory_stats()
                        .get("num_ooms", 0) - ooms0)
                grads[mode] = {k: p.grad.detach().cpu() for k, p in
                               state.model.named_parameters()}
                del state, src, lbl, up, loss, seen, convs, prof
                torch.cuda.empty_cache()
            fwd_names = set(kernels["block"][0])
            replay_only = (set(kernels["block"][1])
                           - set(kernels["none"][1]))
            rel = {k: _rel_l2(g, grads["none"][k])
                   for k, g in grads["block"].items()}
            worst_k = max(rel, key=rel.get)
            out["autotuned" if bench else "heuristic"] = dict(
                replay, frames=frames, grad_rel_l2_worst=rel[worst_k],
                grad_rel_l2_worst_param=worst_k,
                forward_kernel_names=len(fwd_names),
                replay_kernel_names=len(replay_only),
                replay_kernels_not_in_forward=sorted(replay_only
                                                     - fwd_names),
                forward_kernels_none_vs_block_equal=(
                    kernels["none"][0] == kernels["block"][0]))
            del grads
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = bench0
    launches = read_counts(ce, ce_triton, {"nll_fwd": 4, "nll_bwd": 4})[0]
    log("remat_drift: %s" % json.dumps(dict(out, card=card)))
    return out, {"all": launches}

def remat_abn(ce, ce_triton, device, card):
    """(b) The ABN step under none and block, cuDNN deterministic.  On
    the flagship model (phase 6's state and frames, bf16): the step's
    source half alone (one live-BN forward and its backward, no update)
    leaves block's BN buffers equal to none's (rtol 1e-3 / atol 1e-6; the
    same forward arithmetic) and every ``num_batches_tracked`` at 1, so
    the replay in the backward updated nothing; with cuDNN autotuning
    off (the replay's convolutions then run the forward's algorithms, see
    ``remat_drift``) every gradient within a relative L2 error of 2e-2 of
    none's (tests/test_remat_modes.py's bound); then ``REMAT_ABN_STEPS``
    steps timed.  On a shallow r101 in f32 (every
    replayed op rounds as the first time) at the same frames: 2 whole
    steps from the same state leave every running statistic within rtol
    1e-3 / atol 1e-6 of none's and ``num_batches_tracked`` at 4 in both.
    Launches 2 + 1 a step and 1 + 1 for the source half, all bulk."""
    import torch

    from dasac_tpu_torch.sac import core as sac_core
    from dasac_tpu_torch.train import steps

    scfg = abn_step_config()
    batch = abn_batch(device)

    def buffers(model):
        return {k: v.detach().cpu().clone()
                for k, v in model.named_buffers()}

    def same_buffers(got, want, tracked, what):
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                need(int(got[k]) == int(v) == tracked, "%s %s: %d under "
                     "block, %d under none, want %d" % (what, k, int(got[k]),
                                                        int(v), tracked))
            else:
                torch.testing.assert_close(got[k], v, rtol=1e-3, atol=1e-6,
                                           msg="%s %s" % (what, k))

    out, launches, half, grads, two = {}, {}, {}, {}, {}
    for mode in ("none", "block"):
        state = flagship_state(device, remat=mode)
        step = steps.make_abn_step(scfg, device=device)
        reset_counts(ce, ce_triton)
        # autotuning off: the replay runs in autograd's thread, whose cuDNN
        # plan cache is its own; heuristic plans are the same in both
        # threads, timed ones may not be (``remat_drift``)
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        try:
            src, lbl = steps.augment_abn(scfg, torch.Generator(
                device=device).manual_seed(SEED + 1), batch)[:2]
            _, up = state.model(src, train=True, update_stats=True)
            sac_core.cross_entropy_mean(up, lbl, impl="kernel").backward()
            del src, lbl, up
        finally:
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = bench
        half[mode] = buffers(state.model)
        grads[mode] = {k: p.grad.detach().cpu() for k, p in
                       state.model.named_parameters()}
        gen = torch.Generator(device=device).manual_seed(SEED)
        times, peak, rows = run_steps(step, state, batch, gen,
                                      REMAT_ABN_STEPS, "remat abn " + mode)
        got, paths, _ = read_counts(ce, ce_triton, {
            "nll_fwd": 1 + 2 * REMAT_ABN_STEPS,
            "nll_bwd": 1 + REMAT_ABN_STEPS})
        launches[mode] = got
        out[mode] = dict(
            step_ms=times,
            step_ms_median=statistics.median(times[WARMUP_STEPS:]),
            peak_gb=peak, losses=rows, ce_launches=got,
            ce_launches_by_path=paths)
        del state, step
        torch.cuda.empty_cache()

        shallow = flagship_state(device, remat=mode, dtype=torch.float32,
                                 layers=(1, 1, 1, 1))
        step = steps.make_abn_step(scfg, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        reset_counts(ce, ce_triton)
        torch.backends.cudnn.deterministic = True
        try:
            for _ in range(2):
                step(shallow, batch, gen)
        finally:
            torch.backends.cudnn.deterministic = False
        launches[mode + "_shallow_f32"] = read_counts(
            ce, ce_triton, {"nll_fwd": 4, "nll_bwd": 2})[0]
        two[mode] = buffers(shallow.model)
        del shallow, step
        torch.cuda.empty_cache()
    same_buffers(half["block"], half["none"], 1, "source half")
    same_buffers(two["block"], two["none"], 4, "shallow f32, 2 steps")
    rel = {k: _rel_l2(g, grads["none"][k]) for k, g in grads["block"].items()}
    worst_k = max(rel, key=rel.get)
    out["source_half_grad_rel_l2_worst"] = rel[worst_k]
    out["source_half_grad_rel_l2_worst_param"] = worst_k
    need(rel[worst_k] < 2e-2, "remat abn source half: gradient of %s off "
         "none's by rel L2 %.3e (tests/test_remat_modes.py's bound 2e-2)"
         % (worst_k, rel[worst_k]))
    out["shallow_f32_two_steps_max_abs_diff"] = max(
        float((two["block"][k] - v).abs().max())
        for k, v in two["none"].items() if v.is_floating_point())
    log("remat_abn: %s" % json.dumps(dict(out, card=card)))
    return out, launches


def remat_vgg(ce, ce_triton, device, card, none_figures=None):
    """(c) The ABN step of each VGG arch (phase 12's: its base YAML,
    640x640 crops) under block and convs, ``REMAT_ABN_STEPS`` steps:
    step ms and peak GB beside phase 12's none figures
    (``none_figures``: {arch: (step ms, peak GB)}, None when phase 12
    did not run); launches 2 + 1 a step, all bulk."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim, steps

    out, launches = {}, {}
    for arch in VGG_ARCHS:
        cfg, scfg = yaml_config(VGG_CFG[arch][1])
        src = (cfg.TRAIN.BATCH_SIZE, *ABN_SRC[1:])
        tgt = (cfg.TRAIN.NUM_GROUPS, *ABN_TGT[1:])
        batch = abn_batch(device, src, tgt)
        out[arch] = {"none_phase12": (none_figures or {}).get(arch)}
        for mode in REMAT_MODES[1:]:
            model = build_model(arch, C, dtype=torch.bfloat16, remat=mode,
                                device=device,
                                generator=torch.Generator().manual_seed(SEED))
            state = create_train_state(
                model, optim.build_optimizer(cfg.MODEL, arch, model), C,
                device=device)
            step = steps.make_abn_step(scfg, device=device)
            gen = torch.Generator(device=device).manual_seed(SEED)
            reset_counts(ce, ce_triton)
            times, peak, rows = run_steps(step, state, batch, gen,
                                          REMAT_ABN_STEPS,
                                          "remat %s %s" % (arch, mode))
            got, paths, _ = read_counts(ce, ce_triton, {
                "nll_fwd": 2 * REMAT_ABN_STEPS, "nll_bwd": REMAT_ABN_STEPS})
            launches["%s_%s" % (arch, mode)] = got
            out[arch][mode] = dict(
                step_ms=times,
                step_ms_median=statistics.median(times[WARMUP_STEPS:]),
                peak_gb=peak, losses=rows, ce_launches=got,
                ce_launches_by_path=paths)
            del state, model, step
            torch.cuda.empty_cache()
        log("remat_vgg %s: %s" % (arch, json.dumps(dict(out[arch],
                                                        card=card))))
    return out, launches


def remat_adam(ce, ce_triton, device, card):
    """(d) The flagship SAC step with ``MODEL.OPT adam`` for ``N_STEPS``
    steps (finite losses, launches 2 + 2 a step, all bulk); the state
    saved through ``Checkpointer`` and loaded into a fresh state: Adam's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` equal to the bit; then the
    SAC views step with Adam, card against CPU on phase 3's small
    input."""
    import shutil

    import torch

    from dasac_tpu_torch.train import steps
    from dasac_tpu_torch.train.checkpoints import Checkpointer

    state = flagship_state(device, opt="adam")
    need(isinstance(state.optimizer, torch.optim.Adam), "not Adam")
    step = steps.make_sac_step(sac_step_config(), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    reset_counts(ce, ce_triton)
    times, peak, rows = run_steps(step, state, sac_batch(device), gen,
                                  N_STEPS, "adam")
    got, paths, _ = read_counts(ce, ce_triton, {"nll_fwd": 2 * N_STEPS,
                                                "nll_bwd": 2 * N_STEPS})
    try:
        path = Checkpointer(REMAT_BASE).save_latest(state, 0.0, 1)
        fresh = flagship_state(device, seed=SEED + 1, opt="adam")
        Checkpointer(REMAT_BASE).load(path, fresh)
    finally:
        shutil.rmtree(REMAT_BASE, ignore_errors=True)
    n = 0
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            need(torch.equal(a[key], b[key]), "Adam %s not restored" % key)
        need(int(b["step"]) == N_STEPS, "Adam step %s" % b["step"])
        n += 1
    out = dict(step_ms=times,
               step_ms_median=statistics.median(times[WARMUP_STEPS:]),
               peak_gb=peak, losses=rows, ce_launches=got,
               ce_launches_by_path=paths, moments_restored=n)
    log("remat_adam: %s" % json.dumps(dict(out, card=card)))
    del state, fresh, step
    torch.cuda.empty_cache()
    check_adam_agreement(device, card)
    return out, {"adam": got}


def run_remat_opt(ce, ce_triton, device, card, vgg_none=None):
    """Phase 19: (a) ``remat_sac``, (b0) ``remat_drift``, (b) ``remat_abn``,
    (c) ``remat_vgg``, (d) ``remat_adam``.  Returns the CE launches by part."""
    import torch

    torch.backends.cudnn.benchmark = True
    launches, part_s = {}, {}
    for part, args in ((remat_sac, ()), (remat_drift, ()), (remat_abn, ()),
                       (remat_vgg, (vgg_none,)), (remat_adam, ())):
        t0 = time.perf_counter()
        name = part.__name__
        launches.update({
            k if name == "remat_adam" else "%s_%s" % (name, k): v
            for k, v in part(ce, ce_triton, device, card, *args)[1].items()})
        part_s[name] = time.perf_counter() - t0
    log("remat_opt part_s: %s" % json.dumps(part_s))
    return launches


# ---------------------------------------------------------------------------
# phase 20: the step tools
# ---------------------------------------------------------------------------

# --warmup, --steps, --every of compare_refine_res in the smoke (the tool's
# own defaults, 300 each, take ~6 min; cut for the smoke's time limit)
CRR_ARGS = ["--warmup", "6", "--steps", "6", "--every", "3"]
# profile_step's timed steps in the smoke (its default is 5; cut
# for the smoke's time limit)
PROFILE_ITERS = 2


def run_step_tools(ce, ce_triton, device, card):
    """Phase 20: each step tool's ``main`` at its flagship defaults
    (``tools/flagship.py``: r101 bf16, 8 + 2 x 4 frames at 512x1024), with
    cuDNN autotuning off before (the tool turns it on) and the launch
    counts set to 0 before and read after each: ``profile_step`` under
    each remat mode, a warm-up and ``PROFILE_ITERS`` timed steps (2 + 2
    a step), ``conv_roofline`` (no CE), ``op_traffic`` under
    none and convs (2 + 2 in each of its 2 steps) and
    ``compare_refine_res`` cut to ``CRR_ARGS`` (2 + 2 in each of its
    warm-up and arm steps).  Returns the launches by tool."""
    import torch

    from dasac_tpu_torch.tools import (compare_refine_res, conv_roofline,
                                       op_traffic, profile_step)

    launches, tool_s = {}, {}

    def run(name, fn, per_kernel):
        fresh_cudnn()
        reset_counts(ce, ce_triton)
        t0 = time.perf_counter()
        out = fn()
        tool_s[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches[name] = read_counts(ce, ce_triton, {
            "nll_fwd": per_kernel, "nll_bwd": per_kernel})[0]
        need(torch.backends.cudnn.benchmark or device.type != "cuda",
             "%s left cuDNN autotuning off" % name)
        torch.cuda.empty_cache()
        return out

    iters = PROFILE_ITERS
    for mode in REMAT_MODES:
        res = run("profile_step_" + mode, lambda: profile_step.main(
            ["--remat", mode, "--iters", str(iters)], device=device),
            2 * (iters + 1))
        need(set(res) == set(profile_step.STAGES)
             and all(math.isfinite(v) and v > 0 for v in res.values()),
             "profile_step %s: %s" % (mode, res))
        log("step_tools profile_step: %s" % json.dumps(dict(
            remat=mode, stages_ms=res, card=card)))
    roof = run("conv_roofline", lambda: conv_roofline.main([], device=device),
               0)
    need(len(roof["rows"]) == len(conv_roofline.flagship_convs())
         and all(0 < r["share_of_peak"] < 1 for r in roof["rows"]),
         "conv_roofline rows: %s" % roof["rows"])
    log("step_tools conv_roofline: %s" % json.dumps(dict(roof, card=card)))
    for mode in ("none", "convs"):
        tr = run("op_traffic_" + mode, lambda: op_traffic.main(
            ["--remat", mode], device=device), 4)
        need(len(tr["top"]) == 15 and tr["total_written_gb"] > 0,
             "op_traffic %s" % mode)
        log("step_tools op_traffic: %s" % json.dumps(tr))
    warm, arm = int(CRR_ARGS[1]), int(CRR_ARGS[3])
    crr = run("compare_refine_res", lambda: compare_refine_res.main(
        CRR_ARGS, device=device), 2 * (warm + 2 * arm))
    rows = crr["trajectories"]
    need(rows["full"][0]["src_loss_ce"] == rows["stride8"][0]["src_loss_ce"],
         "compare_refine_res: src_loss_ce differs at the first step")
    log("step_tools compare_refine_res: %s" % json.dumps(dict(
        worst_abs_delta=crr["worst_abs_delta"], first=dict(
            full=rows["full"][0], stride8=rows["stride8"][0]),
        last=dict(full=rows["full"][-1], stride8=rows["stride8"][-1]),
        args=CRR_ARGS, card=card)))
    log("step_tools tool_s: %s" % json.dumps(tool_s))
    return launches


# ---------------------------------------------------------------------------
# phase 21: height-sharded training (TPU.PARTITION gspmd, TPU.MESH_SP)
# ---------------------------------------------------------------------------

TMESH_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_train_mesh")
TMESH_RANKS = 4      # (b)'s gloo ranks on the one card
TMESH_LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}
# (b)'s f32 steps, cut so that 4 ranks and then the unsharded reference
# fit on the card: SAC 2 source frames + 2 groups of SAC_GROUP_SIZE views
# at 512x1024 (groups must split over the data axis), ABN 4 + 4 frames
TMESH_SAC_SRC = 2
TMESH_ABN = ((4, 1052, 1914), (4, 1024, 2048))
TMESH_BF16_STEPS = 3  # flagship bf16 SAC steps under REMAT block, (2, 2)
TMESH_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_gspmd.py's bound
# (b)'s f32 cases a layout: (name, step, model keywords).  The full-depth
# ABN step is chaotic (``DDP_KINDS``): it is held on its forward, the
# shallow r101's (one block a stage, full width) on everything
TMESH_CASES = (("sac", "sac", {}), ("abn", "abn", {}),
               ("abn_shallow", "abn", dict(layers=(1, 1, 1, 1))))


def tmesh_batch(kind, device):
    """(b)'s raw global batch of ``kind``: the flagship SAC batch cut to
    ``TMESH_SAC_SRC`` source frames, or the ABN batch at ``TMESH_ABN``."""
    if kind == "sac":
        src_i, src_l, tgt_i, tgt_l = sac_batch(device)
        return src_i[:TMESH_SAC_SRC], src_l[:TMESH_SAC_SRC], tgt_i, tgt_l
    return abn_batch(device, *TMESH_ABN)


def tmesh_step(kind, device, groups=None, f32=True):
    """The train step of ``kind`` over ``groups`` (a gspmd world) or, with
    none, the one-process global step.  SAC keeps pixels above a
    confidence of 0.01 (phase 3's setting: these random weights' near-
    uniform probabilities stay under the flagship's 0.2, and phase 4's
    ``pseudo_cover`` is 0), so that the self-training loss has labels;
    f32 SAC refines in f32 (nothing rounded to bf16 between the two)."""
    from dasac_tpu_torch.train import steps

    if kind == "sac":
        scfg = sac_step_config()._replace(run_conf_lower=0.01)
        if f32:
            scfg = scfg._replace(refine_dtype="float32")
        if groups is None:
            return steps.make_sac_step(scfg, device)
        return steps.make_gspmd_sac_step(scfg, groups, device)
    if groups is None:
        return steps.make_abn_step(abn_step_config(), device)
    return steps.make_gspmd_abn_step(abn_step_config(), groups, device)


def _path_counts(ce):
    return {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}


def _paths_since(ce, paths0):
    return {k: {p: ce.PATH_LAUNCHES[k][p] - paths0[k][p] for p in v}
            for k, v in paths0.items()}


def _step_calls(calls0):
    """A step's collectives: exchanges and bytes forward (replays
    included) and backward by kind, BN reductions forward and backward,
    the other sums."""
    from dasac_tpu_torch.core import dist

    d = {k: dist.CALLS[k] - v for k, v in calls0.items()}
    return dict(
        exchange_fwd={k: (d["exchange_" + k], d["exchange_bytes_" + k])
                      for k in dist.EXCHANGE_KINDS},
        exchange_bwd={k: (d["exchange_bwd_" + k],
                          d["exchange_bwd_bytes_" + k])
                      for k in dist.EXCHANGE_KINDS},
        bn=d["bn"], bn_grad=d["bn_grad"], sums=d["sum"])


def run_train_mesh_one_rank(ce, ce_triton, device, card):
    """(a) The flagship SAC views step and ABN frames step in a NCCL world
    of one built as gspmd ``(1, 1)`` (``make_gspmd_*``: every collective
    runs over the one rank), then the same state and inputs through the
    one-process step, twice; cuDNN deterministic.  The losses are
    bit-equal (the per-class diagnostic is not held: its CUDA
    ``scatter_add_`` adds in any order), and the state differs from the
    one-process one by no more than twice what two one-process runs
    differ by (0 when they agree bit for bit).  Returns the launches, 2 + 2 and 2 + 1 a step, bulk."""
    import torch

    from dasac_tpu_torch.core import dist
    from dasac_tpu_torch.core.mesh import TrainLayout, train_groups
    from dasac_tpu_torch.train import steps
    from dasac_tpu_torch.utils.sys_tools import find_free_port

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(find_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    dist.init(dist.launch_from_env(env), device)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out, launches = dict(phase="train_mesh_one_rank", card=card,
                         backend=torch.distributed.get_backend()), {}
    try:
        groups = train_groups(TrainLayout(1, 1, True), 0, dist.group())
        for kind in ("sac", "abn"):
            inputs = ddp_step(kind, None)[1](device, 0, 1)
            per_step = ({"nll_fwd": 2, "nll_bwd": 2} if kind == "sac"
                        else {"nll_fwd": 2, "nll_bwd": 1})
            runs = {}
            for name in ("gspmd", "plain", "plain_again"):
                g = groups if name == "gspmd" else None
                state = flagship_state(device, group=g and g.world)
                if kind == "sac":
                    step = (steps.make_gspmd_sac_views_step(
                        sac_step_config(), g) if g else
                        steps.make_sac_views_step(sac_step_config()))
                else:
                    step = (steps.make_gspmd_abn_frames_step(
                        abn_step_config(), g) if g else
                        steps.make_abn_frames_step(abn_step_config()))
                reset_counts(ce, ce_triton)
                calls0 = dict(dist.CALLS)
                m = step(state, *inputs)
                torch.cuda.synchronize()
                got = read_counts(ce, ce_triton, per_step)[0]
                runs[name] = dict(
                    metrics={k: v.detach().clone() for k, v in m.items()},
                    state=state_snapshot(state),
                    calls={k: dist.CALLS[k] - calls0[k] for k in calls0})
                if name == "gspmd":
                    launches[kind] = got
                del state, m, step
                torch.cuda.empty_cache()
            g, a, b = runs["gspmd"], runs["plain"], runs["plain_again"]
            # the per-class diagnostic's scatter_add_ adds in any order
            need(all(torch.equal(g["metrics"][k], a["metrics"][k])
                     for k in a["metrics"] if k != "self_ce_per_class"),
                 "train_mesh_one_rank %s: the losses differ: %s vs %s" % (
                     kind, g["metrics"], a["metrics"]))
            d_gspmd = _max_abs_diff(g["state"], a["state"])
            d_floor = _max_abs_diff(b["state"], a["state"])
            need(d_gspmd <= 2 * d_floor,
                 "train_mesh_one_rank %s: state differs by %r under gspmd, "
                 "by %r between two one-process runs" % (kind, d_gspmd,
                                                          d_floor))
            need(g["calls"]["sum"] >= 2 and not a["calls"]["sum"],
                 "train_mesh_one_rank %s: collectives %s / %s" % (
                     kind, g["calls"], a["calls"]))
            out[kind] = dict(max_abs_diff_gspmd_vs_plain=d_gspmd,
                             max_abs_diff_plain_vs_plain=d_floor,
                             collectives_a_step={
                                 k: v for k, v in g["calls"].items() if v})
            del runs, g, a, b, inputs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy()
    log("train_mesh_one_rank: %s" % json.dumps(out))
    return launches


def tmesh_rank(rank, addr, card, t_spawn, device):
    """(b) One of ``TMESH_RANKS`` gloo ranks sharing the card: for each
    layout of ``TMESH_LAYOUTS`` (the ranks past it sit it out) one f32 SAC
    and one f32 ABN step of the full-width r101 from the raw batch (its
    data slice; the draws the global batch's), rank 0 writing its state
    and metrics under ``TMESH_BASE``; then ``TMESH_BF16_STEPS`` flagship
    bf16 SAC steps under REMAT block as (2, 2).  Every case ends with
    every rank's state equal.  Writes what it measured: step ms, peak GB,
    a step's collectives, CE launches by path."""
    import torch
    import torch.distributed as tdist

    from dasac_tpu_torch.core import dist
    from dasac_tpu_torch.core.mesh import TrainLayout, train_groups
    from dasac_tpu_torch.ops import ce

    start_s = time.time() - t_spawn
    # this script's settings (``main``), which a new process does not have
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.benchmark = False
    device = torch.device(device)
    device = torch.device(device.type, device.index or 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.perf_counter()
    dist.init(dist.Launch(addr, TMESH_RANKS, rank, rank), device,
              backend="gloo")
    out = dict(rank=rank, card=card, start_s=start_s,
               setup_s=time.perf_counter() - t0, cases={})
    try:
        # every rank builds every group, in the same order
        worlds = {}
        for name, (n_data, n_sp) in TMESH_LAYOUTS.items():
            n = n_data * n_sp
            world = (dist.group() if n == TMESH_RANKS
                     else tdist.new_group(list(range(n))))
            groups = train_groups(TrainLayout(n_data, n_sp, True), rank,
                                  world)
            worlds[name] = groups if rank < n else None
        cases = [(case, kind, kw, name, 1, torch.float32, "none")
                 for name in TMESH_LAYOUTS for case, kind, kw in TMESH_CASES]
        cases.append(("sac", "sac", {}, "2x2", TMESH_BF16_STEPS,
                      torch.bfloat16, "block"))
        for case, kind, kw, name, n_steps, dtype, remat in cases:
            groups = worlds[name]
            if groups is None:
                continue
            f32 = dtype == torch.float32
            key = "%s_%s_%s" % (case, name, "f32" if f32 else "bf16_block")
            state = flagship_state(device, group=groups.world, dtype=dtype,
                                   remat=remat, **kw)
            step = tmesh_step(kind, device, groups, f32)
            batch = tuple(a[groups.d * (a.shape[0] // groups.n_data):
                            (groups.d + 1) * (a.shape[0] // groups.n_data)]
                          for a in (tmesh_batch(kind, device) if f32
                                    else sac_batch(device)))
            gen = torch.Generator(device=device).manual_seed(SEED)
            rows = []
            for i in range(n_steps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dist.barrier(device, groups.world)
                calls0, paths0 = dict(dist.CALLS), _path_counts(ce)
                t0 = time.perf_counter()
                m = step(state, batch, gen)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rows.append(dict(
                    step_ms=ms, peak_gb=torch.cuda.max_memory_allocated()
                    / 1e9, collectives=_step_calls(calls0),
                    ce_launches_by_path=_paths_since(ce, paths0),
                    metrics={k: float(v) for k, v in m.items()
                             if v.dim() == 0}))
                for k, v in rows[-1]["metrics"].items():
                    need(math.isfinite(v), "%s step %d: %s = %r"
                         % (key, i, k, v))
            if kind == "sac":
                need(rows[-1]["metrics"]["pseudo_cover"] > 0,
                     "%s: no pseudo-labels" % key)
            equal = dist.assert_replicas_equal(
                dist.state_tensors(state, device, group=groups.world),
                device, groups.world)
            if rank == 0 and f32:
                torch.save(dict(
                    metrics={k: v.detach().cpu() for k, v in m.items()},
                    state={k: v.cpu() for k, v in
                           state_snapshot(state).items()}),
                    os.path.join(TMESH_BASE, "%s_rank0.pt" % key))
            out["cases"][key] = dict(
                coords=[groups.d, groups.s], steps=rows,
                replica_tensors_equal=equal)
            del state, step, batch, m
            torch.cuda.empty_cache()
    finally:
        dist.destroy()
    log("train_mesh_rank: %s" % json.dumps(out))
    with open(os.path.join(TMESH_BASE, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)


def run_train_mesh_gloo(device, card):
    """(b) ``TMESH_RANKS`` spawned gloo ranks on the card (``tmesh_rank``),
    then in this process the unsharded one-process global step of each f32
    case from the same state, batch and generator: rank 0's losses,
    parameters, BN buffers, teacher and running_conf within
    ``TMESH_TOL``; the full-depth ABN step its source loss (the forward),
    the rest printed.  Returns each rank's measurements."""
    import shutil

    import torch

    from dasac_tpu_torch.utils.sys_tools import find_free_port

    shutil.rmtree(TMESH_BASE, ignore_errors=True)
    os.makedirs(TMESH_BASE)
    torch.cuda.empty_cache()
    addr = "127.0.0.1:%d" % find_free_port()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False   # as the ranks run
    try:
        t0 = time.time()
        torch.multiprocessing.spawn(
            tmesh_rank, args=(addr, card, t0, str(device)),
            nprocs=TMESH_RANKS, join=True)
        spawn_s = time.time() - t0
        ranks = []
        for r in range(TMESH_RANKS):
            with open(os.path.join(TMESH_BASE, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        out = dict(phase="train_mesh_gloo", card=card, ranks=TMESH_RANKS,
                   backend="gloo", spawn_and_steps_s=spawn_s, cases={})
        for case, kind, kw in TMESH_CASES:
            state = flagship_state(device, dtype=torch.float32, **kw)
            gen = torch.Generator(device=device).manual_seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            m = tmesh_step(kind, device)(state, tmesh_batch(kind, device),
                                         gen)
            torch.cuda.synchronize()
            ref = dict(metrics={k: v.detach() for k, v in m.items()},
                       state=state_snapshot(state))
            ref_ms = (time.perf_counter() - t1) * 1e3
            ref_gb = torch.cuda.max_memory_allocated() / 1e9
            del state, m
            layouts = []
            for name in TMESH_LAYOUTS:
                key = "%s_%s_f32" % (case, name)
                got = torch.load(os.path.join(TMESH_BASE,
                                              "%s_rank0.pt" % key),
                                 weights_only=True)
                bad = []
                for what in ("metrics", "state"):
                    for k, v in ref[what].items():
                        g = got[what][k].to(device)
                        if not torch.allclose(g.double(), v.double(),
                                              **TMESH_TOL):
                            bad.append((what + "." + k, float(
                                (g.double() - v.double()).abs().max())))
                err = max(float((got["state"][k].to(device).double()
                                 - v.double()).abs().max())
                          for k, v in ref["state"].items()
                          if v.is_floating_point())
                o = out["cases"][key] = dict(
                    outside_tolerance=bad[:8], state_max_abs_diff=err,
                    unsharded_step_ms=ref_ms, unsharded_peak_gb=ref_gb,
                    losses={k: float(v) for k, v in got["metrics"].items()
                            if v.dim() == 0},
                    losses_unsharded={k: float(v) for k, v in
                                      ref["metrics"].items()
                                      if v.dim() == 0})
                log("train_mesh_gloo %s: %s" % (key, json.dumps(o)))
                if case == "abn":
                    bad = [b for b in bad if b[0] == "metrics.src_loss_ce"]
                need(not bad, "%s: rank 0 and the unsharded global step "
                     "differ beyond rtol %g / atol %g: %s" % (
                         key, TMESH_TOL["rtol"], TMESH_TOL["atol"], bad[:5]))
                layouts.append(got["state"])
            # two layouts against each other: as far apart as each is from
            # the unsharded step when the step is chaotic, not closer
            out["cases"]["%s_layouts_state_max_abs_diff" % case] = \
                _max_abs_diff(*layouts)
            del ref, layouts
            torch.cuda.empty_cache()
        log("train_mesh_gloo: %s" % json.dumps(out))
    finally:
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(TMESH_BASE, ignore_errors=True)
    return ranks


def run_train_mesh(ce, ce_triton, device, card):
    """Phase 21: (a) the NCCL world of one (``run_train_mesh_one_rank``);
    (b) ``TMESH_RANKS`` gloo ranks on the card (``run_train_mesh_gloo``).
    Returns the CE launches: (a)'s by step, (b)'s by rank and case, each
    by path (strips may leave the bulk path)."""
    one = run_train_mesh_one_rank(ce, ce_triton, device, card)
    ranks = run_train_mesh_gloo(device, card)
    summary = {}
    for r in ranks:
        for key, case in r["cases"].items():
            step = case["steps"][-1]
            summary["rank%d_%s" % (r["rank"], key)] = dict(
                step_ms=step["step_ms"], peak_gb=step["peak_gb"],
                **step["collectives"])
    log("train_mesh per rank and step: %s" % json.dumps(dict(
        summary, card=card)))
    # a case's last step, by kernel and by path
    by_path = {"rank%d" % r["rank"]: {
        key: c["steps"][-1]["ce_launches_by_path"]
        for key, c in r["cases"].items()} for r in ranks}
    gloo = {rank: {key: {k: sum(v.values()) for k, v in paths.items()}
                   for key, paths in cases.items()}
            for rank, cases in by_path.items()}
    for rank, cases in gloo.items():
        for key, got in cases.items():
            need(all(got.values()), "train_mesh %s %s: a CE kernel did not "
                 "launch: %s" % (rank, key, got))
    return dict(nccl_one=one, gloo_ranks=gloo, gloo_by_path=by_path)


# ---------------------------------------------------------------------------
# phase 22: optax's optimizers by name
# ---------------------------------------------------------------------------

OPTAX_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "smoke_optax")
OPTAX_STEPS = 3        # optimizer steps, card against CPU
# (a)'s step t takes OPTAX_GRAD_SCALE[t] times the one SAC step's
# gradients (exact in f32): with equal gradients adan's differences of
# successive gradients would be f32 rounding noise
OPTAX_GRAD_SCALE = (1.0, 0.5, 2.0)
OPTAX_SAC_STEPS = 4    # flagship SAC steps a timed name; the last 2 timed
# the names whose SAC step is timed: the baseline, a rule over lists and
# the rule that loops over tensors (its step differs from SGD's by the
# optimizer's ms, within the step's noise of ~20 ms otherwise);
# ``--optimizers-only`` times every name
OPTAX_TIMED = ("SGD", "adamw", "sm3")
# (a): a parameter's error, card against CPU, within OPTAX_DISP_RTOL of
# its tensor's largest displacement in the CPU's run plus OPTAX_ULPS f32
# epsilons of its own magnitude (the roundings of p + u); every tensor
# moves by at least OPTAX_MOVED epsilons of its largest magnitude, so that
# the bound is a fraction of the move (at most 0.5%)
OPTAX_DISP_RTOL = 1e-3
OPTAX_ULPS = 4
OPTAX_MOVED = 1e3
# state tensors: rtol, and atol scaled by the tensor's largest magnitude
OPTAX_TOL = dict(rtol=1e-4, atol=1e-6)
OPTAX_SIGN_SHARE = 1e-6  # share of elements a sign rule may flip
# (a)'s base LRs other than the bench's 2.5e-4, for the rules whose 3
# steps at it move some r101 tensor by fewer than 5 * OPTAX_MOVED
# epsilons (lars: its trust coefficient is 1e-3; adadelta: its first steps
# are sqrt(eps) / rms(g); novograd: g / ||g|| over the whole tensor; the
# others by 1e3 to 5e3)
OPTAX_LR = {"adadelta": 0.25, "adafactor": 2.5e-3, "adagrad": 2.5e-3,
            "fromage": 2.5e-3, "lamb": 2.5e-3, "lars": 0.25,
            "novograd": 2.5e-2, "rprop": 2.5e-3, "sm3": 2.5e-3}
R101 = "deeplabv2_resnet101"
F32_EPS = float(np.finfo(np.float32).eps)


def _beyond(got, ref, rtol, atol):
    """(max abs error, share of elements beyond ``atol + rtol |ref|``)."""
    got, ref = got.float(), ref.float()
    if not ref.numel():
        return 0.0, 0.0
    err = (got - ref).abs()
    return (float(err.max()),
            float((err > atol + rtol * ref.abs()).float().mean()))


def agree_cfg(name):
    """``_ModelCfg`` with ``OPT`` = ``name`` at (a)'s base LR."""
    return type("_Agree_" + name, (model_cfg(name),),
                {"LR": OPTAX_LR.get(name, _ModelCfg.LR)})


def optax_agree(name, models, start, grads, device):
    """(a) ``OPTAX_STEPS`` steps of ``name`` on the card (``models``:
    {device: model, "cpu": model}; ``start``, ``grads``: {device: {name:
    tensor}}), from the same parameters and gradients on both (step t's
    scaled by ``OPTAX_GRAD_SCALE[t]``), at the base LR of ``OPTAX_LR``.
    Returns the card's optimizer and ``check()``, which takes the CPU's
    steps and holds the card's parameters (their displacements) and every
    state tensor, copied to the host here, against the CPU's; it may run
    on another thread meanwhile."""
    import torch

    from dasac_tpu_torch.train import optax_rules, optim

    def set_grads(dev, t):
        for k, p in models[dev].named_parameters():
            p.grad = grads[dev][k] * OPTAX_GRAD_SCALE[t]

    opts = {}
    for dev, model in models.items():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(start[dev][k])
        opts[dev] = optim.build_optimizer(agree_cfg(name), R101, model,
                                          seed=SEED)
    card, cpu = opts[device], opts["cpu"]
    noises = []
    for t in range(OPTAX_STEPS):
        set_grads(device, t)
        noise = None
        if name == "noisy_sgd":
            noise = card.sample_noise_draws(
                torch.Generator(device=device).manual_seed(SEED + t))
            noises.append([[d.cpu() for d in g] for g in noise])
        card.step(noise=noise)
    got = {k: (p.detach().to("cpu", copy=True),
               {f: v.to("cpu", copy=True) for f, v in card.state[p].items()})
           for k, p in models[device].named_parameters()}

    def check():
        for t in range(OPTAX_STEPS):
            set_grads("cpu", t)
            cpu.step(noise=noises[t] if noises else None)
        share_max = (OPTAX_SIGN_SHARE if name in optax_rules.SIGN_RULES
                     else 0.0)
        worst = dict(param_err=0.0, param_share=0.0, moved_min=None,
                     state_err=0.0, state_share=0.0)
        for k, q in models["cpu"].named_parameters():
            p, a = got[k]
            ref = q.detach()
            moved = float((ref - start["cpu"][k]).abs().max())
            eps = F32_EPS * max(float(ref.abs().max()),
                                float(start["cpu"][k].abs().max()))
            need(moved > 0 and moved >= OPTAX_MOVED * eps,
                 "optimizers %s: parameter %s "
                 "moved by %.3g, under %g f32 epsilons of its magnitude"
                 % (name, k, moved, OPTAX_MOVED))
            err = (p - ref).abs()
            bound = (OPTAX_DISP_RTOL * moved
                     + OPTAX_ULPS * F32_EPS * ref.abs())
            sh = float((err > bound).float().mean())
            need(sh <= share_max, "optimizers %s: parameter %s off the "
                 "CPU's on %.3g of its elements (max %.3g of a %.3g move)"
                 % (name, k, sh, float(err.max()), moved))
            worst["param_err"] = max(worst["param_err"],
                                     float(err.max()) / moved)
            worst["param_share"] = max(worst["param_share"], sh)
            worst["moved_min"] = min(worst["moved_min"] or np.inf,
                                     moved / eps)
            b = cpu.state[q]
            need(set(a) == set(b), "optimizers %s: state fields %s vs %s"
                 % (name, sorted(a), sorted(b)))
            for field, want in b.items():
                if field == "step":
                    need(torch.equal(a[field], want)
                         and int(want) == OPTAX_STEPS,
                         "optimizers %s: step %s vs %s"
                         % (name, a[field], want))
                    continue
                scale = float(want.abs().max()) if want.numel() else 0.0
                e, sh = _beyond(a[field], want, OPTAX_TOL["rtol"],
                                OPTAX_TOL["atol"] * max(scale, 1e-30))
                need(sh <= share_max, "optimizers %s: %s of %s off the "
                     "CPU's on %.3g of its elements (max %.3g of %.3g)"
                     % (name, field, k, sh, e, scale))
                worst["state_err"] = max(worst["state_err"],
                                         e / max(scale, 1e-30))
                worst["state_share"] = max(worst["state_share"], sh)
        return worst

    return card, check


def optax_opt_ms(opt):
    """(b) the optimizer step alone (``median_ms``: CUDA events, and the
    host clock to a synchronize; the gradients it is given stay) and its
    state in GB."""
    _, _, times = median_ms(opt.step)
    state_bytes = sum(t.numel() * t.element_size()
                      for st in opt.state.values() for k, t in st.items()
                      if k != "step")
    return dict(opt_ms=statistics.median(times["device_ms"]),
                opt_host_ms=statistics.median(times["host_ms"]),
                state_gb=state_bytes / 1e9)


def optax_time(ce, ce_triton, name, model, step, batch, init_sd, device):
    """(b) ``OPTAX_SAC_STEPS`` flagship SAC steps with the optimizer
    ``name`` from the weights ``init_sd``.  Returns (train state, figures,
    CE launches)."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.train import optim

    model.load_state_dict(init_sd)
    for p in model.parameters():
        p.grad = None
    opt = optim.build_optimizer(model_cfg(name), R101, model, seed=SEED)
    state = create_train_state(model, opt, C, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    reset_counts(ce, ce_triton)
    times, peak, rows = run_steps(step, state, batch, gen, OPTAX_SAC_STEPS,
                                  "optimizers " + name)
    got, paths, _ = read_counts(ce, ce_triton,
                                {"nll_fwd": 2 * OPTAX_SAC_STEPS,
                                 "nll_bwd": 2 * OPTAX_SAC_STEPS})
    out = dict(step_ms=times, step_ms_median=statistics.median(
        times[-2:]), peak_gb=peak, losses=rows[-1], ce_launches=got,
        ce_launches_by_path=paths)
    return state, out, got


def optax_round_trip(name, model, opt, fresh_model, device):
    """(c) the state of ``model`` and its optimizer ``opt`` (after (a))
    through ``Checkpointer`` into a fresh state of ``fresh_model`` (its
    optimizer at (a)'s LRs, which a snapshot does not carry): every
    optimizer field equal, then one more step on both from the same
    gradients, bit-equal."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.train import optim
    from dasac_tpu_torch.train.checkpoints import Checkpointer

    state = create_train_state(model, opt, C, device=device)
    t0 = time.perf_counter()
    path = Checkpointer(OPTAX_BASE).save_latest(state, 0.0, 1)
    save_s = time.perf_counter() - t0
    fresh = create_train_state(
        fresh_model, optim.build_optimizer(agree_cfg(name), R101,
                                           fresh_model, seed=SEED),
        C, device=device)
    t0 = time.perf_counter()
    Checkpointer(OPTAX_BASE).load(path, fresh)
    load_s = time.perf_counter() - t0
    os.remove(path)
    pairs = list(zip(state.model.parameters(), fresh.model.parameters()))
    for p, q in pairs:
        need(torch.equal(p, q), "optimizers %s: parameter not restored"
             % name)
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        need(set(a) == set(b) and all(torch.equal(a[f], b[f]) for f in a),
             "optimizers %s: state not restored" % name)
        q.grad = p.grad.clone()
    state.optimizer.step()
    fresh.optimizer.step()
    for p, q in pairs:
        need(torch.equal(p, q), "optimizers %s: the step after the round "
             "trip differs" % name)
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        need(all(torch.equal(a[f], b[f]) for f in a),
             "optimizers %s: the state after the round trip differs" % name)
    return dict(save_s=save_s, load_s=load_s,
                snapshot_fields=len(state.optimizer.state[pairs[0][0]]))


def optax_cli(ce, ce_triton, device, card):
    """The train CLI with ``MODEL.OPT adafactor``: 2 ABN steps on phase
    10's synthetic root, then ``--resume auto`` for 2 more; the resumed
    state is the saved one, adafactor's factored moments included."""
    import torch

    from dasac_tpu_torch.train.optax_rules import OptaxRule

    root = os.path.join(OPTAX_BASE, "root")
    write_train_root(root, card)
    common = ["--snapshot-dir", os.path.join(OPTAX_BASE, "snap"),
              "--logdir", os.path.join(OPTAX_BASE, "logs"), "--exp", "smoke",
              "--run", "adafactor"]
    sets = ["DATASET.ROOT", root, "TPU.CE_IMPL", "pallas",
            "TPU.MESH_DEVICES", "1", "MODEL.OPT", "adafactor",
            "MODEL.BASELINE", "True"]
    stages = {}
    first, stages["adafactor"] = run_train_stage(
        ce, ce_triton, "adafactor",
        ["--cfg", TRAIN_CFG["abn"], *common, "--set", *sets,
         "TRAIN.NUM_EPOCHS", "0", *TRAIN_SETS], 0, 2, device, card,
        phase="optimizers_cli")
    last = os.path.join(first.args.snapshot_dir, "last.pth")
    del first
    torch.cuda.empty_cache()
    saved = torch.load(last, map_location="cpu", weights_only=True)
    factored = []

    def check_resume(trainer):
        """Student and every adafactor field as saved."""
        state = trainer.state
        opt = state.optimizer
        need(isinstance(opt, OptaxRule) and opt.name == "adafactor",
             "resume: the optimizer is %r" % (opt,))
        for k, v in state.model.state_dict().items():
            need(torch.equal(v.cpu(), saved["model"][
                "module.backbone." + k]), "resume: student %s" % k)
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            want = saved["opt"]["state"][i]
            need(set(opt.state[p]) == set(want),
                 "resume: adafactor fields of parameter %d" % i)
            for f, t in want.items():
                need(torch.equal(opt.state[p][f].cpu(), t),
                     "resume: adafactor %s of parameter %d" % (f, i))
            factored.append("v_row" in want)

    resumed, stages["adafactor_resume"] = run_train_stage(
        ce, ce_triton, "adafactor_resume",
        ["--cfg", TRAIN_CFG["abn"], *common, "--resume", "auto", "--set",
         *sets, "TRAIN.NUM_EPOCHS", "1", *TRAIN_SETS], 1, 2, device, card,
        check_resume=check_resume, phase="optimizers_cli")
    need(any(factored), "adafactor factored no parameter")
    del resumed, saved
    torch.cuda.empty_cache()
    return stages, sum(factored)


def run_optimizers(ce, ce_triton, device, card, keep_root=None):
    """Phase 22: for SGD (the baseline, timed only) and each of optax's 26
    names, (a) ``optax_agree`` (its CPU half on a thread while (c)
    ``optax_round_trip`` runs), then (b) ``optax_opt_ms`` on (a)'s
    optimizer and, for the names of ``OPTAX_TIMED`` (None: all),
    ``optax_time``, alone; then ``optax_cli``.  ``keep_root``: where its
    synthetic root (phase 10's sizes) moves afterwards, for phase 23.
    Returns the CE launches by timed name and CLI stage."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optax_rules, optim, steps

    torch.backends.cudnn.benchmark = True
    shutil.rmtree(OPTAX_BASE, ignore_errors=True)
    os.makedirs(OPTAX_BASE)
    try:
        state = flagship_state(device)
        model = state.model
        init_sd = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        step = steps.make_sac_step(sac_step_config(), device=device)
        batch = sac_batch(device)
        # one SAC step's gradients, at the parameters it started from
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        reset_counts(ce, ce_triton)
        step(state, batch, torch.Generator(device=device).manual_seed(SEED))
        read_counts(ce, ce_triton, {"nll_fwd": 2, "nll_bwd": 2})
        # each tensor scaled to RMS 1 (a tensor without gradient stays 0),
        # so that every rule moves every tensor by far more than f32's
        # rounding of it, whatever the scale of the loss's gradients
        grads = {}
        for k, p in model.named_parameters():
            g = (p.grad.detach().float() if p.grad is not None
                 else torch.zeros_like(p))
            rms = g.pow(2).mean().sqrt()
            grads[k] = torch.where(rms > 0, g / rms, g)
        del state
        cpu_model = build_model(R101, C, device="cpu")
        fresh_model = build_model(
            R101, C, dtype=torch.bfloat16, device=device,
            generator=torch.Generator().manual_seed(SEED + 1))
        start = {device: start, "cpu": {k: v.cpu()
                                        for k, v in start.items()}}
        grads = {device: grads, "cpu": {k: v.cpu()
                                        for k, v in grads.items()}}
        rows, launches, part_s = {}, {}, {}
        with ThreadPoolExecutor(1) as pool:
            for name in ("SGD",) + optax_rules.NAMES:
                row, t0 = {}, time.perf_counter()
                if name == "SGD":
                    with torch.no_grad():
                        for k, p in model.named_parameters():
                            p.grad = grads[device][k].clone()
                    opt = optim.build_optimizer(model_cfg(name), R101, model)
                else:
                    # the CPU's steps and the comparison run beside (c)
                    opt, check = optax_agree(
                        name, {device: model, "cpu": cpu_model}, start, grads,
                        device)
                    agree = pool.submit(check)
                    row["round_trip"] = optax_round_trip(name, model, opt,
                                                         fresh_model, device)
                    row["agree"] = agree.result()
                t1 = time.perf_counter()
                row.update(optax_opt_ms(opt))
                del opt
                if OPTAX_TIMED is None or name in OPTAX_TIMED:
                    state, timed, launches[name] = optax_time(
                        ce, ce_triton, name, model, step, batch, init_sd,
                        device)
                    row.update(timed)
                    del state
                torch.cuda.empty_cache()
                part_s[name] = dict(agree_round_trip=t1 - t0,
                                    time=time.perf_counter() - t1)
                row["sgd_opt_ms"] = rows["SGD"]["opt_ms"] if rows else None
                rows[name] = row
                log("optimizers %s: %s" % (name, json.dumps(dict(row,
                                                                 card=card))))
        del model, fresh_model, cpu_model, init_sd, start, grads
        torch.cuda.empty_cache()
        cli, n_factored = optax_cli(ce, ce_triton, device, card)
        if keep_root is not None:
            shutil.rmtree(keep_root, ignore_errors=True)
            os.makedirs(os.path.dirname(keep_root), exist_ok=True)
            os.replace(os.path.join(OPTAX_BASE, "root"), keep_root)
    finally:
        shutil.rmtree(OPTAX_BASE, ignore_errors=True)
    table = {n: dict(step_ms_median=r.get("step_ms_median"),
                     opt_ms=r["opt_ms"], opt_host_ms=r["opt_host_ms"],
                     state_gb=r["state_gb"],
                     agree_param_err=r.get("agree", {}).get("param_err"),
                     agree_moved_min=r.get("agree", {}).get("moved_min"))
             for n, r in rows.items()}
    log("optimizers: %s" % json.dumps(dict(
        card=card, names=len(rows) - 1, table=table, part_s=part_s,
        cli_factored_params=n_factored,
        cli={st: o["ce_launches"] for st, o in cli.items()})))
    launches.update({"cli_" + st: o["ce_launches"] for st, o in cli.items()})
    return launches


# ---------------------------------------------------------------------------
# phase 24: SegFormer-B5's SAC step

SEGFORMER_STEPS = 4
# attention calls a SAC step: 52 blocks in the teacher, source and target
# forwards; query-key pairs a frame: 3x32768x512 + 12x8192x512 +
# 200x2048x512 + 24x512x512 at 512x1024, over 8 + 8 + 8 frames
SEGFORMER_CALLS = 3 * 52
SEGFORMER_PAIRS = 24 * (3 * 32768 * 512 + 12 * 8192 * 512
                        + 200 * 2048 * 512 + 24 * 512 * 512)
SDPA_FUSED = ("aten::_scaled_dot_product_flash_attention",
              "aten::_scaled_dot_product_efficient_attention",
              "aten::_scaled_dot_product_cudnn_attention")
SDPA_MATH = "aten::_scaled_dot_product_attention_math"


def segformer_state(device, remat="none"):
    """SegFormer-B5 in bf16 under ``remat``, random weights from ``SEED``,
    its SGD and train state."""
    import torch

    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.train import optim

    model = build_model("segformer_b5", C, dtype=torch.bfloat16, remat=remat,
                        device=device,
                        generator=torch.Generator().manual_seed(SEED))
    return create_train_state(model, optim.build_optimizer(
        model_cfg(), "segformer_b5", model), C, device=device)


def _attention_step(step, state, batch, gen):
    """One step; returns (ms, metrics, attention calls, pairs)."""
    import torch

    from dasac_tpu_torch.nn import segformer

    calls0, pairs0 = (segformer.ATTENTION["calls"],
                      segformer.ATTENTION["pairs"])
    t0 = time.perf_counter()
    m = step(state, batch, gen)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3, m,
            segformer.ATTENTION["calls"] - calls0,
            segformer.ATTENTION["pairs"] - pairs0)


def _segformer_steps(device, graphed, n, remat="none"):
    """``n`` SAC steps of a fresh SegFormer-B5 state (weights from
    ``SEED``, the same batch and generator seed every time), its blocks'
    branches from CUDA graphs or eager (``graphs.Passes(0)``); returns
    (step ms, losses, attention calls and pairs a step, the parameters'
    change over the first step on the host, peak bytes, state, step)."""
    import torch

    from dasac_tpu_torch.nn import graphs
    from dasac_tpu_torch.train import steps

    torch.cuda.reset_peak_memory_stats()
    state = segformer_state(device, remat)
    if not graphed:
        state.model.backbone.graph_passes = graphs.Passes(0)
    step = steps.make_sac_step(sac_step_config(), device=device)
    batch = sac_batch(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    p0 = {k: p.detach().clone() for k, p in
          state.model.named_parameters()}
    times, losses, counts, d1 = [], [], [], None
    for i in range(n):
        ms, m, calls, pairs = _attention_step(step, state, batch, gen)
        times.append(ms)
        row = {k: float(m[k]) for k in ("src_loss_ce", "self_ce",
                                        "teacher_diff", "pseudo_cover")}
        need(all(math.isfinite(v) for v in row.values()),
             "segformer step %d: %s" % (i, row))
        losses.append(row)
        counts.append((calls, pairs))
        if i == 0:
            d1 = {k: (p.detach() - p0[k]).float().cpu() for k, p in
                  state.model.named_parameters()}
            del p0
        log("segformer %s step %d: %.1f ms %s" % (
            "graphs" if graphed else "eager", i, ms, json.dumps(row)))
    nonfinite = [k for k, p in state.model.named_parameters()
                 if not torch.isfinite(p).all()]
    need(not nonfinite, "segformer: non-finite params %s" % nonfinite[:4])
    return (times, losses, counts, d1, torch.cuda.max_memory_allocated(),
            state, step, batch, gen)


def _rel_change_gap(a, b):
    """||a - b|| / ||b|| over every leaf of two parameter changes."""
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in b)
    den = sum(float(b[k].double().pow(2).sum()) for k in b)
    return math.sqrt(num / max(den, 1e-300))


def _free_segformer():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_segformer(ce, ce_triton, device, card):
    """Phase 24; returns the CE launches of its graphed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dasac_tpu_torch.utils import spans

    torch.backends.cudnn.benchmark = True
    out = dict(card=card, steps=SEGFORMER_STEPS,
               attention_calls=SEGFORMER_CALLS,
               attention_pairs=SEGFORMER_PAIRS)
    # eager: the step of the branches' own operators; one step profiled
    # for the attention's backend
    times, losses, counts, d_eager, peak, state, step, batch, gen = (
        _segformer_steps(device, False, SEGFORMER_STEPS))
    need(all(c == (SEGFORMER_CALLS, SEGFORMER_PAIRS) for c in counts),
         "segformer eager: attention calls and pairs a step %s, want %d "
         "over %d" % (counts, SEGFORMER_CALLS, SEGFORMER_PAIRS))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _attention_step(step, state, batch, gen)
    ops = {}
    for e in prof.events():
        if e.name in SDPA_FUSED or e.name == SDPA_MATH:
            ops[e.name] = ops.get(e.name, 0) + 1
    need(sum(ops.get(n, 0) for n in SDPA_FUSED) == SEGFORMER_CALLS
         and SDPA_MATH not in ops,
         "segformer: SDPA forwards by backend %s, want %d fused and no math"
         % (ops, SEGFORMER_CALLS))
    out["eager"] = dict(step_ms=times,
                        step_ms_median=statistics.median(times[1:]),
                        losses=losses, max_memory_allocated=peak,
                        sdpa_ops=ops)
    del state, step
    _free_segformer()
    # eager again, one step: the floor of two runs' difference
    _, _, _, d_again, _, state, step, _, _ = _segformer_steps(device, False,
                                                             1)
    del state, step
    _free_segformer()
    eager_gap = _rel_change_gap(d_again, d_eager)
    del d_again

    # graphed: the same steps from the same start
    reset_counts(ce, ce_triton)
    times, glosses, counts, d_graph, peak, state, step, batch, gen = (
        _segformer_steps(device, True, SEGFORMER_STEPS))
    launches, paths, _ = read_counts(
        ce, ce_triton, {"nll_fwd": 2 * SEGFORMER_STEPS,
                        "nll_bwd": 2 * SEGFORMER_STEPS})
    need(all(c == (SEGFORMER_CALLS, SEGFORMER_PAIRS) for c in counts),
         "segformer graphs: attention calls and pairs a step %s, want %d "
         "over %d" % (counts, SEGFORMER_CALLS, SEGFORMER_PAIRS))
    passes = state.model.backbone.graph_passes.passes
    branches = sum(len(p.branches) for p in passes.values())
    need(len(passes) == 2 and branches == 4 * 52,
         "segformer graphs: %d passes, %d branches graphed, want 2 (teacher,"
         " student) and 208" % (len(passes), branches))
    graph_gap = _rel_change_gap(d_graph, d_eager)
    loss_gap = max(abs(a["src_loss_ce"] - b["src_loss_ce"])
                   / abs(b["src_loss_ce"]) for a, b in zip(glosses, losses))
    need(graph_gap <= max(4 * eager_gap, 0.02),
         "segformer graphs: the first step's change differs from eager's by"
         " %.3g, two eager runs by %.3g" % (graph_gap, eager_gap))
    spans.reset()
    with spans.recording():
        _attention_step(step, state, batch, gen)
    totals = spans.totals()
    spans.reset()
    out["graphs"] = dict(
        step_ms=times, step_ms_median=statistics.median(times[1:]),
        img_s=FLAGSHIP[0] / (statistics.median(times[1:]) / 1e3),
        losses=glosses, max_memory_allocated=peak,
        change_gap_to_eager=graph_gap, eager_change_gap=eager_gap,
        src_loss_gap=loss_gap,
        span_stream_ms={k: totals[k].stream_ms for k in (
            "attention", "mix_ffn", "decode_head")},
        span_host_ms={k: totals[k].host_ms for k in (
            "attention", "mix_ffn", "decode_head")},
        ce_launches=launches, ce_launches_by_path=paths)
    del state, step
    _free_segformer()

    # remat block: eager, its replays add 104 calls a step
    times, _, counts, _, peak, state, step, _, _ = _segformer_steps(
        device, True, 2, remat="block")
    need(all(c[0] == SEGFORMER_CALLS + 2 * 52 for c in counts),
         "segformer remat block: %s attention calls a step, want %d"
         % ([c[0] for c in counts], SEGFORMER_CALLS + 2 * 52))
    out["remat_block"] = dict(step_ms=times[1], max_memory_allocated=peak)
    del state, step
    _free_segformer()
    log("segformer: %s" % json.dumps(out))
    return launches


# ---------------------------------------------------------------------------
# phase 23: the port's bench (tools/bench.py)
# ---------------------------------------------------------------------------

BENCH_BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_bench")
BENCH_ROOT = os.path.join(BENCH_BASE, "root")   # phase 22's root, kept
BENCH_MODES = {
    "step_pallas": ["--mode", "step", "--ce-impl", "pallas", "--iters", "6"],
    "step_xla": ["--mode", "step", "--ce-impl", "xla", "--iters", "6"],
    "e2e": ["--mode", "e2e", "--iters", "3"],
    "infer": ["--mode", "infer", "--iters", "5"]}
# bench.py's JSON keys by mode, and the port's own: the card, the CE route,
# its launches over the timed steps, the FLOPs by op
_BENCH_COMMON = {"metric", "unit", "remat", "vs_baseline_note", "value",
                 "vs_baseline", "card", "ce_impl"}
BENCH_KEYS = {
    "step": _BENCH_COMMON | {"step_ms", "step_flops_tf", "mfu", "step_hbm_gb",
                             "hbm_util", "ce_launches",
                             "step_flops_tf_by_op"},
    "e2e": _BENCH_COMMON | {
        "h2d_mb_s", "end_to_end_images_per_sec", "end_to_end_step_ms",
        "input_images_per_sec_decode", "input_images_per_sec_packed",
        "host_cpus", "host_load1_pre_input", "host_load1_post_input",
        "end_to_end_ce_launches"},
    "infer": {"metric", "value", "unit", "ms_per_frame", "vs_baseline",
              "card"}}


def hook_conv_flops(args):
    """An independent count of the convolution FLOPs of one SAC step at
    ``args``' sizes: a forward of one frame through ``args.arch`` on the
    meta device (no card time), each conv's 2 Ho Wo Cin Cout kh kw from a
    forward hook, then a student conv 3x over the source frames and the
    views (forward, weight and input gradients; 2x where its input needs
    no gradient: the stem's) and a teacher conv 1x over the views."""
    import torch

    from dasac_tpu_torch.nn.factory import build_model
    from dasac_tpu_torch.nn.layers import Conv2d

    model = build_model(args.arch, C, dtype=torch.bfloat16,
                        device="cpu").to("meta")
    per_frame = []

    def hook(mod, inputs, out):
        _, cout, ho, wo = out.shape
        per_frame.append((2 * ho * wo * mod.weight.shape[1] * cout
                          * mod.kernel ** 2, inputs[0].requires_grad))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv2d)]
    model(torch.zeros(1, *args.hw, 3, device="meta"))
    for h in hooks:
        h.remove()
    views = args.groups * args.group_size
    return sum(f * ((args.batch + views) * (2 + grad_in) + views)
               for f, grad_in in per_frame)


def run_bench(ce, ce_triton, device, card, root=None, bench_infer_rec=None):
    """Phase 23: ``tools.bench.main`` in this process at the flagship
    (``BENCH_MODES``), each with cuDNN autotuning off before (the bench
    turns it on) and the launch counts set to 0 before and read after:
    ``--mode step`` with each CE route (pallas: 2 + 2 a step over its 3
    warm-up, 6 timed and 1 counted steps, all bulk; xla: none), ``--mode
    e2e`` on ``root`` (phase 22's real-size root when it holds the two
    training splits, else the bench's corpus under ``BENCH_BASE``), ``--mode
    infer``; each prints one JSON line with ``bench.py``'s keys and the
    port's.  ``mfu`` and ``hbm_util`` in (0, 1.05]; the step's conv FLOPs
    within 1% of ``hook_conv_flops`` (the resize's products a share under
    1%), beside ``conv_roofline``'s table of 37.6 TFLOP.  Then
    ``bench_infer``'s r101 batch-1 record (phase 14's, else run here).
    Returns the CE launches by run."""
    import contextlib
    import io
    import shutil

    import torch

    from dasac_tpu_torch.tools import bench, bench_infer, conv_roofline

    have = root is not None and all(
        os.path.isfile(os.path.join(root, split + ".txt"))
        for split in (bench.SRC_SPLIT, bench.TGT_SPLIT))
    launches, recs, run_s = {}, {}, {}
    try:
        if not have:
            root = bench.corpus(os.path.join(BENCH_BASE, "corpus"))
        for name, argv in BENCH_MODES.items():
            mode = argv[1]
            fresh_cudnn()
            reset_counts(ce, ce_triton)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rec = bench.main(argv, device=device, root=root)
            torch.cuda.synchronize()
            run_s[name] = time.perf_counter() - t0
            printed = buf.getvalue()
            sys.stdout.write(printed)
            lines = [ln for ln in printed.splitlines() if ln.startswith("{")]
            need(len(lines) == 1 and json.loads(lines[0]) == json.loads(
                json.dumps(rec)), "bench %s: one JSON line, got %d"
                 % (name, len(lines)))
            need(set(rec) == BENCH_KEYS[mode],
                 "bench %s keys: %s" % (name, sorted(set(rec) ^ BENCH_KEYS[
                     mode])))
            need(rec["value"] > 0 and (torch.backends.cudnn.benchmark
                                       or device.type != "cuda"),
                 "bench %s: value %s, cuDNN autotuning %s" % (
                     name, rec["value"], torch.backends.cudnn.benchmark))
            pallas = "pallas" in argv
            iters = int(argv[argv.index("--iters") + 1])
            per = 2 * (3 + iters + 1) if pallas else 0
            launches[name] = read_counts(ce, ce_triton, {
                "nll_fwd": per, "nll_bwd": per})[0]
            if mode == "step":
                need(rec["ce_launches"] == {
                    k: {"bulk": 2 * iters if pallas else 0, "strided": 0}
                    for k in ("nll_fwd", "nll_bwd")},
                     "bench %s: timed launches %s" % (name,
                                                      rec["ce_launches"]))
                for key in ("mfu", "hbm_util"):
                    need(0 < rec[key] <= 1.05, "bench %s: %s = %s" % (
                        name, key, rec[key]))
            recs[name] = rec
            torch.cuda.empty_cache()
        want = hook_conv_flops(bench.parse_args(BENCH_MODES["step_pallas"]))
        by_op = {k: v * 1e12 for k, v in recs["step_pallas"][
            "step_flops_tf_by_op"].items()}
        need(abs(by_op["conv"] - want) <= 0.01 * want
             and 0 < by_op["matmul"] < 0.01 * by_op["conv"],
             "bench step FLOPs by op %s against %.4g by hooks"
             % (by_op, want))
        table = sum(3 * 2 * 16 * h * w * k * k * ci * co * mult * 9 / 8
                    for _, (h, w), ci, co, k, _, mult
                    in conv_roofline.flagship_convs())
        if bench_infer_rec is None:
            fresh_cudnn()
            bench_infer_rec = bench_infer.main(
                ["--batch", "1", "--output", "argmax"], device=device)
            torch.cuda.empty_cache()
        need(0 < bench_infer_rec["mfu"] <= 1.05
             and 0 < bench_infer_rec["hbm_util"] <= 1.05,
             "bench_infer r101 batch 1: mfu %s, hbm_util %s" % (
                 bench_infer_rec.get("mfu"), bench_infer_rec.get("hbm_util")))
    finally:
        shutil.rmtree(BENCH_BASE, ignore_errors=True)
    log("bench: %s" % json.dumps(dict(
        card=card, root="phase 22's" if have else "the bench's corpus",
        step_ms={k: recs[k]["step_ms"] for k in ("step_pallas", "step_xla")},
        img_s={k: recs[k]["value"] for k in recs},
        mfu={k: recs[k]["mfu"] for k in ("step_pallas", "step_xla")},
        hbm_util={k: recs[k]["hbm_util"] for k in ("step_pallas",
                                                    "step_xla")},
        step_flops_tf=recs["step_pallas"]["step_flops_tf"],
        conv_tf_hooks=want / 1e12, conv_tf_roofline_table=table / 1e12,
        step_hbm_gb={k: recs[k]["step_hbm_gb"] for k in ("step_pallas",
                                                         "step_xla")},
        e2e_img_s=recs["e2e"]["end_to_end_images_per_sec"],
        h2d_mb_s=recs["e2e"]["h2d_mb_s"],
        input_img_s=dict(decode=recs["e2e"]["input_images_per_sec_decode"],
                         packed=recs["e2e"]["input_images_per_sec_packed"]),
        infer_ms_per_frame=recs["infer"]["ms_per_frame"],
        bench_infer_r101_b1={k: bench_infer_rec.get(k) for k in (
            "latency_ms_per_frame", "step_flops_tf", "mfu",
            "hbm_gb_per_step", "hbm_util")},
        run_s=run_s)))
    return launches


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
    parser.add_argument(
        "--infer-mesh-only", action="store_true",
        help="instead of the phases, run phase 18 (inference over a world "
             "of ranks) alone")
    parser.add_argument(
        "--train-mesh-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 21 "
             "(height-sharded training) alone")
    parser.add_argument(
        "--remat-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 19 "
             "(remat and Adam) alone")
    parser.add_argument(
        "--step-tools-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 20 "
             "(the step tools) alone")
    parser.add_argument(
        "--optimizers-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 22 "
             "(optax's optimizers by name) alone")
    parser.add_argument(
        "--live-bn-only", action="store_true",
        help="instead of the phases, run the live-BN kernels' part of "
             "phase 2, then phases 4, 6 and 9 with their live-BN launch "
             "counts")
    parser.add_argument(
        "--bench-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 23 "
             "(the port's bench) alone")
    parser.add_argument(
        "--segformer-only", action="store_true",
        help="instead of the phases, build the CE kernels and run phase 24 "
             "(SegFormer-B5's SAC step) alone")
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
    if args.infer_mesh_only:
        run_infer_mesh(ce, ce_triton, device, card)
        log("infer_mesh: %.1f s" % (time.perf_counter() - t_start))
        return 0
    if (args.live_bn_only or args.remat_only or args.step_tools_only
            or args.train_mesh_only or args.optimizers_only
            or args.bench_only or args.segformer_only):
        global OPTAX_TIMED
        OPTAX_TIMED = None  # phase 22 alone times every name's SAC step
        build_cuda(ce)
        for flag, phase in ((args.live_bn_only, run_live_bn_paths),
                            (args.remat_only, run_remat_opt),
                            (args.step_tools_only, run_step_tools),
                            (args.train_mesh_only, run_train_mesh),
                            (args.optimizers_only, run_optimizers),
                            (args.bench_only, run_bench),
                            (args.segformer_only, run_segformer)):
            if flag:
                t0 = time.perf_counter()
                log("%s launches: %s" % (phase.__name__, json.dumps(
                    phase(ce, ce_triton, device, card))))
                log("%s: %.1f s" % (phase.__name__,
                                    time.perf_counter() - t0))
        return 0

    phase_s, lap_t = {}, [t_start]

    def lap(phase):
        """Seconds since the previous lap, kept for the summary line."""
        now = time.perf_counter()
        phase_s[phase] = now - lap_t[0]
        lap_t[0] = now

    ptxas = build_cuda(ce)
    native_build_s = build_native()
    paths_before = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    checks = check_kernels(ce, device)
    need(all(ce.PATH_LAUNCHES[k]["bulk"]
             == paths_before[k]["bulk"] + len(kernel_cases())
             for k in ce.PATH_LAUNCHES),
         "kernel checks off the bulk path: %s" % ce.PATH_LAUNCHES)
    triton_checks = check_kernels(ce_triton, device)
    timing = time_kernels(ce, ce_triton, device, name)
    torch.cuda.empty_cache()
    run_live_bn(ce, ce_triton, device, card)
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
    vgg, vgg_abn = run_vgg(ce, ce_triton, device, card)
    lap("vgg")
    run_infer_cli(ce, ce_triton, snapshot, device, card)
    lap("infer_cli")
    bench_infer_recs = run_bench_infer(device)
    lap("bench_infer")
    dataset = run_dataset(ce, ce_triton, device, card, native_build_s)
    lap("dataset")
    ddp = run_ddp(ce, ce_triton, device, card)
    lap("ddp")
    recipe_launches = run_recipe(ce, ce_triton, device, card)
    lap("recipe")
    mesh_launches = run_infer_mesh(ce, ce_triton, device, card)
    lap("infer_mesh")
    remat_launches = run_remat_opt(ce, ce_triton, device, card, vgg_abn)
    lap("remat_opt")
    tools_launches = run_step_tools(ce, ce_triton, device, card)
    lap("step_tools")
    tmesh_launches = run_train_mesh(ce, ce_triton, device, card)
    lap("train_mesh")
    optax_launches = run_optimizers(ce, ce_triton, device, card,
                                    keep_root=BENCH_ROOT)
    lap("optimizers")
    bench_launches = run_bench(ce, ce_triton, device, card, root=BENCH_ROOT,
                               bench_infer_rec=bench_infer_recs[0])
    lap("bench")
    segformer_launches = run_segformer(ce, ce_triton, device, card)
    lap("segformer")

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
            # the trainer from the dataset tools' packs (phase 15)
            by_stage = {st: o["ce_launches" if route == "cuda"
                              else "triton_launches"][k]
                        for st, o in dataset.items()}
            row.update(launches_dataset=sum(by_stage.values()),
                       launches_dataset_by_stage=by_stage)
            # data parallel (phase 16): NCCL world of one, its CLI stages,
            # each gloo rank
            row["launches_ddp"] = dict(
                nccl_steps={kind: (got[k] if route == "cuda" else 0)
                            for kind, got in ddp["nccl_steps"].items()},
                nccl_cli={st: (got[k] if route == "cuda" else 0)
                          for st, got in ddp["nccl_cli"].items()},
                gloo_ranks=[{kind: (got[k] if route == "cuda" else 0)
                             for kind, got in r.items()}
                            for r in ddp["gloo_ranks"]])
            # the recipe's train stages (phase 17)
            row["launches_recipe"] = {
                st: (got[k] if route == "cuda" else 0)
                for st, got in recipe_launches.items()}
            # inference over a world (phase 18): none
            row["launches_infer_mesh"] = (mesh_launches[k]
                                          if route == "cuda" else 0)
            # remat and Adam (phase 19) and the step tools (phase 20), by
            # part
            for key, by_part in (("launches_remat_opt", remat_launches),
                                 ("launches_step_tools", tools_launches)):
                row[key] = {part: (got[k] if route == "cuda" else 0)
                            for part, got in by_part.items()}
            # height-sharded training (phase 21): the NCCL world of one
            # by step, each gloo rank's last step of each case by path
            cuda = route == "cuda"
            row["launches_train_mesh"] = dict(
                nccl_one={kind: (got[k] if cuda else 0) for kind, got in
                          tmesh_launches["nccl_one"].items()},
                gloo_ranks={rank: {key: (got[k] if cuda else 0)
                                   for key, got in cases.items()}
                            for rank, cases in
                            tmesh_launches["gloo_ranks"].items()},
                gloo_by_path={rank: {key: (paths[k] if cuda else None)
                                     for key, paths in cases.items()}
                              for rank, cases in
                              tmesh_launches["gloo_by_path"].items()})
            # optax's optimizers by name (phase 22): the flagship SAC
            # steps of each timed name (OPTAX_TIMED), and the adafactor
            # CLI stages
            row["launches_optimizers"] = {
                part: (got[k] if cuda else 0)
                for part, got in optax_launches.items()}
            # the bench (phase 23), by run
            row["launches_bench"] = {run: (got[k] if cuda else 0)
                                     for run, got in bench_launches.items()}
            # SegFormer-B5's SAC steps (phase 24)
            row["launches_segformer"] = (segformer_launches[k] if cuda
                                         else 0)
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
