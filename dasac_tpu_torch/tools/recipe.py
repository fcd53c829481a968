"""The three-stage recipe on one device (counterpart of
``tools/recipe_chip.py``; reference README.md:145-166), with the protocol
``results/recipe_r5.jsonl`` records.

On a domain-gapped synthetic corpus at native GTA/Cityscapes sizes
(``data/synth.make_domain_gap_root``), packed to memmaps once
(``tools/pack_dataset``, ``TPU.PACKED_DIR auto``):

  stage 1   ABN baseline (``MODEL.BASELINE True``) from scratch (no
            ImageNet ``.pth`` exists, so the trainer prints "Backbone model
            not found"), then the gate: the mean ``src_loss_ce`` over the
            last 10 logged lines of its log must not exceed ``--gate-ce``
            before SAC and the control may run (SAC's student keeps the
            snapshot's BN statistics frozen, and an unconverged live-BN
            snapshot's statistics poison it); the renormed source-val mIoU
            is recorded beside it
  stage 2   the inference CLI's mask export on ``train_cityscapes``
  stage 3   ``compute_is_weights`` on those masks
  stage 4   SAC from the ABN ``last.pth`` with ``DATASET.SAMPLE_WEIGHTS``,
            ``MODEL.NET_MOMENTUM_ITER --ema-iter``, and, as the r5 record
            ran it (the committed JAX script does not pass them),
            ``TRAIN.TARGET_ONLY`` (``--target-only``) and ``MODEL.LR
            --lr-sac``: the source branch through the frozen blended BN
            statistics explodes on this corpus
  control   ABN continued from the same snapshot for the same extra epochs
  eval      single-scale inference of ABN, control and SAC on
            ``val_cityscapes`` (target) and ``val_game_1K`` (source, with
            the renormed statistics the train step gave the source frames),
            and of the SAC snapshot's EMA teacher on the target

Every stage runs in this process through the port's entry points
(``train.cli.main``, ``infer.cli.main``, ``compute_is_weights.count``),
its output teed into a log under ``--work``; between stages the global
config is reset, the stage's trainer dropped and the device's cache
emptied, so that two r101 stages never hold memory at once.  Every train
stage runs the CE kernels (``TPU.CE_IMPL pallas``; the r5 run used the
plain formula, the same math) and must log finite losses.  ``--stages``
picks stages by letter (``1,2,3,4,c,eval``) to resume a run whose work
directory is still there; the corpus and its packs are reused when their
stamp and headers match.

Each measurement appends one JSON line to ``--out``: the keys of
``results/recipe_r5.jsonl``, plus ``card`` (name and power limit), the
JAX figure of the same stage, model and domain (``jax_miou``), and per
train stage its steps, steady step ms (median over the steps that are not
an epoch's first), peak device GB and CE launches by kernel and path.

    python -m dasac_tpu_torch.tools.recipe            # the r5 protocol
    python -m dasac_tpu_torch.tools.recipe --stages eval

From Python, ``main(argv, device="cpu")`` runs on the CPU and returns the
records it wrote; with ``device=None`` it runs on the GPU and raises
before anything else when there is none.
"""

import argparse
import contextlib
import gc
import json
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

from dasac_tpu_torch.aug.pipelines import renorm_stats
from dasac_tpu_torch.core import config
from dasac_tpu_torch.core.device import card_name, resolve_device
from dasac_tpu_torch.data import lists, native, packed, png
from dasac_tpu_torch.data.synth import make_domain_gap_root
from dasac_tpu_torch.infer import cli as infer_cli
from dasac_tpu_torch.ops import ce
from dasac_tpu_torch.tools import compute_is_weights, pack_dataset
from dasac_tpu_torch.train import cli as train_cli
from dasac_tpu_torch.train.metrics import mean_iou

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CFG = os.path.join(REPO, "configs", "deeplabv2_resnet101_train.yaml")
JAX_RECORD = os.path.join(REPO, "results", "recipe_r5.jsonl")
STAGES = "1,2,3,4,c,eval"


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_logged(log_path, fn, device):
    """``fn()`` with everything it prints also appended to ``log_path``;
    returns (its result, wall s, peak device GB or None off the card)."""
    print("[recipe] -> {}".format(log_path))
    sys.stdout.flush()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with open(log_path, "a") as f, contextlib.redirect_stdout(
            _Tee(sys.stdout, f)):
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    return out, wall, peak


def release(device):
    """Between stages: the config back to its defaults, the last stage's
    objects collected and the device's cached blocks returned."""
    config.reset_cfg()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def corpus(work, args):
    root = os.path.join(work, "data")
    params = dict(n_train_src=args.n_src, n_train_tgt=args.n_tgt,
                  n_val=args.n_val, seed=0,
                  src_hw=tuple(args.src_hw), tgt_hw=tuple(args.tgt_hw))
    marker = os.path.join(root, ".complete")
    stamp = json.dumps(params, sort_keys=True)
    if os.path.isfile(marker):
        with open(marker) as f:
            if f.read() == stamp:
                return root
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_domain_gap_root(root, **params)
    with open(marker, "w") as f:
        f.write(stamp)
    print("[recipe] corpus generated in %.1f s" % (time.perf_counter() - t0))
    return root


def trailing_src_ce(log_path, n=10):
    """Mean src_loss_ce over the last ``n`` logged lines."""
    with open(log_path) as f:
        vals = [float(m.group(1)) for m in
                re.finditer(r"src_loss_ce ([0-9.eE+-]+)", f.read())]
    if not vals:
        raise RuntimeError("no src_loss_ce entries in " + log_path)
    return sum(vals[-n:]) / len(vals[-n:])


def assert_finite_losses(log_path):
    """Raise when a logged loss line of ``log_path`` holds nan or inf."""
    with open(log_path) as f:
        bad = [ln for ln in f
               if ln.startswith("Loss") and ("nan" in ln or "inf" in ln)]
    if bad:
        raise RuntimeError("non-finite training loss in %s:\n%s" % (
            log_path, "".join(bad[:5])))


def pack_corpus(root, cfg_path):
    """Pack the train splits to memmaps: the source split at its canonical
    size, the target split at both its native size (the ABN loader) and
    CROP_SIZE (the SAC group loader decodes at the crop).  Sizes whose pack
    exists are skipped.  The decoder is the one the config's trainer uses
    (``TPU.NATIVE_LOADER``)."""
    config.reset_cfg()
    config.cfg_from_file(cfg_path)
    c = config.cfg
    task, tgt = c.TRAIN.TASK, c.TRAIN.TARGET
    crop = tuple(c.DATASET.CROP_SIZE)
    native.set_enabled(c.TPU.NATIVE_LOADER)
    config.reset_cfg()
    pdir = packed.default_dir(root)

    def probe(split):
        imgs, _ = lists.read_split(root, split)
        return png.png_size(imgs[0])

    src_hw = lists.canonical_size(task)
    if probe(task)[0] < src_hw[0] // 2:
        src_hw = probe(task)
    for split, hw in ((task, src_hw), (tgt, probe(tgt)), (tgt, crop)):
        if packed.find_pack(pdir, split, hw, "resize"):
            continue
        run_logged(os.path.join(root, "pack.log"),
                   lambda: pack_dataset.pack_split(root, split, size=hw),
                   torch.device("cpu"))


def source_norm_override(cfg_path):
    """MEAN/STD overrides so that source-split evals see the normalization
    the train step gave source frames (``DATASET.RENORM_SOURCE``; the
    inference CLI applies plain ``DATASET.MEAN/STD``).  Target-split evals
    take plain statistics on both sides."""
    config.reset_cfg()
    config.cfg_from_file(cfg_path)
    d = config.cfg.DATASET
    if not d.RENORM_SOURCE:
        config.reset_cfg()
        return []
    m, s = renorm_stats(d.MEAN, d.STD, d.SOURCE_MEAN, d.SOURCE_STD,
                        d.TARGET_MEAN, d.TARGET_STD)
    config.reset_cfg()

    def fmt(v):
        return "[%s]" % ",".join("%.6f" % float(x) for x in v)

    return ["DATASET.MEAN", fmt(m), "DATASET.STD", fmt(s)]


def _launches():
    return {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}


def _launch_delta(before):
    return {k: {p: n - before[k][p] for p, n in by_path.items()}
            for k, by_path in ce.PATH_LAUNCHES.items()}


def shifted_classes(importance, tol=1e-3):
    """Classes whose sampling density over the target frames differs from
    uniform by more than ``tol`` somewhere (``ImportanceSampler``'s
    per-class cumulative weights)."""
    cum = importance._cum
    dens = np.diff(np.concatenate([np.zeros((cum.shape[0], 1)), cum], 1), 1)
    dens = dens / dens.sum(1, keepdims=True)
    uniform = 1.0 / dens.shape[1]
    return [c for c in range(dens.shape[0])
            if np.abs(dens[c] - uniform).max() > tol]


def train_stage(work, root, run, epochs, extra, log, device, cfg_path,
                seed=0):
    """One ``train.cli.main`` run; returns what the record keeps of it."""
    snap = os.path.join(work, "snap_" + run)
    argv = ["--cfg", cfg_path, "--snapshot-dir", snap,
            "--logdir", os.path.join(work, "logs"), "--exp", "recipe",
            "--run", run, "--workers", "2", "--seed", str(seed),
            "--set", "DATASET.ROOT", root, "TPU.PACKED_DIR", "auto",
            "TRAIN.NUM_EPOCHS", str(epochs),
            "LOG.ITER_VAL", "100000", "LOG.ITER_TARGET", "100000",
            "TPU.CE_IMPL", "pallas"] + extra
    open(log, "w").close()
    before = _launches()
    trainer, wall, peak = run_logged(
        log, lambda: train_cli.main(argv, device), device)
    launches = _launch_delta(before)
    steps = trainer.step_ms
    steady = [ms for _, i, ms in steps if i > 0]
    imp = trainer.loaders.importance
    info = dict(
        seed=seed, wall_s=wall, steps=len(steps),
        step_ms=statistics.median(steady) if steady else None,
        peak_gb=peak, ce_launches_by_path=launches,
        start_epoch=trainer.start_epoch,
        target_only=trainer.scfg.target_only,
        sample_weights=trainer.cfg.DATASET.SAMPLE_WEIGHTS or None,
        is_shifted_classes=None if imp is None else shifted_classes(imp))
    del trainer, imp
    release(device)
    assert_finite_losses(log)
    ckpt = os.path.join(snap, "default", "recipe", run, "last.pth")
    if not os.path.isfile(ckpt):
        raise RuntimeError("no snapshot at " + ckpt)
    return info


def evaluate(work, root, ckpt, split, tag, device, cfg_path, teacher=False):
    """Single-scale inference of ``ckpt`` on ``split``: its mIoU over the
    config's kept classes, from the confusion the CLI returns."""
    log = os.path.join(work, "eval_%s_%s.log" % (tag, split))
    open(log, "w").close()
    extra = source_norm_override(cfg_path) if "_game_" in split else []
    argv = (["--cfg", cfg_path, "--resume", ckpt, "--infer-list", split,
             "--mask-output-dir", os.path.join(work, "masks_eval", tag, split),
             "--workers", "2"] + (["--teacher"] if teacher else []) +
            ["--set", "DATASET.ROOT", root] + extra)

    def run():
        conf = infer_cli.main(argv, device)
        if conf is None:
            raise RuntimeError("no masks for %s" % split)
        return mean_iou(conf, config.cfg.VAL.IGNORE_CLASS)

    miou, _, _ = run_logged(log, run, device)
    release(device)
    return miou


def jax_figures(path=JAX_RECORD):
    """(stage, model, domain) -> the last JAX record with an mIoU for it."""
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if "miou" in r:
                out[(r["stage"], r.get("model"), r.get("domain"))] = r
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(REPO, "build", "recipe"),
                    help="corpus, packs, logs, snapshots and masks")
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "recipe_torch.jsonl"))
    ap.add_argument("--cfg", default=CFG,
                    help="training config (tiny_cpu.yaml for a CPU run)")
    ap.add_argument("--n-src", type=int, default=48)
    ap.add_argument("--n-tgt", type=int, default=24)
    ap.add_argument("--n-val", type=int, default=6)
    ap.add_argument("--src-hw", type=int, nargs=2, default=[1052, 1914])
    ap.add_argument("--tgt-hw", type=int, nargs=2, default=[1024, 2048])
    ap.add_argument("--epochs1", type=int, default=120,
                    help="ABN baseline epochs beyond the first (the trainer "
                         "runs epochs 0..N: 6 steps an epoch at 48/8)")
    ap.add_argument("--epochs2", type=int, default=18,
                    help="additional SAC / control epochs")
    ap.add_argument("--lr-abn", type=float, default=5e-4,
                    help="LR of the from-scratch ABN and control stages")
    ap.add_argument("--lr-sac", type=float, default=5e-5,
                    help="MODEL.LR of the SAC stage (at the flagship 2.5e-4 "
                         "the target-only student diverged in the r5 run)")
    ap.add_argument("--target-only", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="TRAIN.TARGET_ONLY for the SAC stage: no source "
                         "branch through the snapshot's frozen BN "
                         "statistics")
    ap.add_argument("--gate-ce", type=float, default=0.5,
                    help="maximum mean source train CE over the last 10 "
                         "logged lines of the ABN stage before the SAC and "
                         "control stages may run ('inf' reports it only)")
    ap.add_argument("--ema-iter", type=int, default=10,
                    help="MODEL.NET_MOMENTUM_ITER for the SAC stage (the "
                         "flagship 100 assumes ~90k steps)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the train stages' --seed (weights, augmentation, "
                         "sampling); the corpus keeps seed 0")
    ap.add_argument("--stages", default=STAGES,
                    help="comma list of stages to run (resume-friendly)")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the recipe's stages; returns the records written, in order."""
    device = resolve_device(device)
    args = parse_args(argv if argv is not None else sys.argv[1:])
    cfg_path = os.path.abspath(args.cfg)
    card = card_name() if device.type == "cuda" else device.type
    jax = jax_figures()
    records = []
    t_run = time.perf_counter()

    def record(**kv):
        kv.update(card=card, ts=time.time())
        with open(args.out, "a") as f:
            f.write(json.dumps(kv) + "\n")
        records.append(kv)
        print("[recipe] " + json.dumps(kv))
        sys.stdout.flush()

    def jax_miou(stage, model, domain):
        return jax.get((stage, model, domain), {}).get("miou")

    os.makedirs(args.work, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    stages = set(args.stages.split(","))
    root = corpus(args.work, args)
    log1 = os.path.join(args.work, "stage1_abn.log")
    abn_ckpt = os.path.join(args.work, "snap_abn", "default", "recipe",
                            "abn", "last.pth")
    weights = os.path.join(args.work, "cs_weights.data")
    masks = os.path.join(args.work, "masks_tgt")

    pack_corpus(root, cfg_path)

    if "1" in stages:
        info = train_stage(args.work, root, "abn", args.epochs1,
                           ["MODEL.BASELINE", "True",
                            "MODEL.LR", str(args.lr_abn)], log1, device,
                           cfg_path, args.seed)
        record(stage="abn", epochs=args.epochs1, lr=args.lr_abn, **info)
        ce_tail = trailing_src_ce(log1)
        miou_src = evaluate(args.work, root, abn_ckpt, "val_game_1K",
                            "abn_gate", device, cfg_path)
        ref = jax.get(("gate", "abn", "source"), {})
        record(stage="gate", model="abn", domain="source",
               split="val_game_1K", miou=miou_src, src_ce_tail=ce_tail,
               gate_ce=args.gate_ce, passed=ce_tail <= args.gate_ce,
               jax_miou=ref.get("miou"), jax_split=ref.get("split"),
               jax_src_ce_tail=ref.get("src_ce_tail"))
        if ce_tail > args.gate_ce:
            raise RuntimeError(
                "stage-1 ABN snapshot failed the convergence gate: trailing "
                "source CE %.4f > %.2f; raise --epochs1 or tune --lr-abn "
                "before spending device time on SAC/control"
                % (ce_tail, args.gate_ce))

    if "2" in stages:
        argv = ["--cfg", cfg_path, "--resume", abn_ckpt,
                "--infer-list", "train_cityscapes", "--mask-output-dir",
                masks, "--workers", "2", "--set", "DATASET.ROOT", root]
        _, wall, _ = run_logged(os.path.join(args.work, "stage2_export.log"),
                                lambda: infer_cli.main(argv, device), device)
        release(device)
        n = len([f for f in os.listdir(masks) if f.endswith(".png")])
        record(stage="export", split="train_cityscapes", masks=n,
               wall_s=wall)

    if "3" in stages:
        if os.path.isfile(weights):
            os.remove(weights)
        stats, wall, _ = run_logged(
            os.path.join(args.work, "stage3_weights.log"),
            lambda: compute_is_weights.count(masks, out=weights), device)
        record(stage="weights", images=len(stats), wall_s=wall)

    if "4" in stages:
        info = train_stage(
            args.work, root, "sac", args.epochs1 + args.epochs2,
            ["DATASET.SAMPLE_WEIGHTS", weights,
             "MODEL.NET_MOMENTUM_ITER", str(args.ema_iter),
             "TRAIN.TARGET_ONLY", str(args.target_only),
             "MODEL.LR", str(args.lr_sac), "--resume", abn_ckpt],
            os.path.join(args.work, "stage4_sac.log"), device, cfg_path,
            args.seed)
        record(stage="sac", epochs=args.epochs2, ema_iter=args.ema_iter,
               lr=args.lr_sac, **info)

    if "c" in stages:
        info = train_stage(
            args.work, root, "ctrl", args.epochs1 + args.epochs2,
            ["MODEL.BASELINE", "True", "MODEL.LR", str(args.lr_abn),
             "--resume", abn_ckpt],
            os.path.join(args.work, "control_abn.log"), device, cfg_path,
            args.seed)
        record(stage="control", epochs=args.epochs2, lr=args.lr_abn, **info)

    if "eval" in stages:
        sac_ckpt = os.path.join(args.work, "snap_sac", "default", "recipe",
                                "sac", "last.pth")
        ctrl_ckpt = os.path.join(args.work, "snap_ctrl", "default", "recipe",
                                 "ctrl", "last.pth")
        res = {}
        for tag, ckpt in (("abn", abn_ckpt), ("control", ctrl_ckpt),
                          ("sac", sac_ckpt)):
            if not os.path.isfile(ckpt):
                continue
            for split, dom in (("val_cityscapes", "target"),
                               ("val_game_1K", "source")):
                miou = evaluate(args.work, root, ckpt, split, tag, device,
                                cfg_path)
                res["%s_%s" % (tag, dom)] = miou
                record(stage="eval", model=tag, domain=dom, split=split,
                       miou=miou, jax_miou=jax_miou("eval", tag, dom))
        if os.path.isfile(sac_ckpt):
            miou = evaluate(args.work, root, sac_ckpt, "val_cityscapes",
                            "sac_teacher", device, cfg_path, teacher=True)
            res["sac_teacher_target"] = miou
            record(stage="eval", model="sac_teacher", domain="target",
                   split="val_cityscapes", miou=miou,
                   jax_miou=jax_miou("eval", "sac_teacher", "target"))
        if "sac_target" in res and "control_target" in res:
            gains = dict(gain_vs_control=res["sac_target"]
                         - res["control_target"])
            if "abn_target" in res:
                gains["gain_vs_abn"] = res["sac_target"] - res["abn_target"]
            if "sac_teacher_target" in res:
                gains["teacher_gain_vs_control"] = (
                    res["sac_teacher_target"] - res["control_target"])
            record(stage="summary", wall_s=time.perf_counter() - t_run,
                   **gains, **res)
    return records


if __name__ == "__main__":
    main()
