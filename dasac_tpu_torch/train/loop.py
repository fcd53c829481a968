"""Trainer: epoch loop, validation cadence, best-3 and rolling snapshots on
one GPU (counterpart of ``dasac_tpu/train/loop.py``; reference
train.py:48-533).

The host feeds uint8 batches from the prefetch loaders and reads each
step's metrics back only after it has launched the next step: on CUDA,
``float()`` on step i-1's tensors then waits for step i-1 alone, while step
i is queued behind it.  Randomness: one ``torch.Generator`` on the device,
seeded from ``--seed``, draws every train step's augmentation; target
validation seeds a generator per (epoch, batch) and the visual panel one
fixed generator, so their draws are the same in every run.

One process, one device.  ``dasac_tpu``'s mesh and pod branches
(loop.py:36-133) are multi-GPU work (ROADMAP Queue 1 items 1 and 10):
``TPU.MESH_DEVICES`` > 1, ``TPU.PARTITION`` "gspmd", ``TPU.MESH_SP`` > 1,
``TPU.REMAT`` other than "none", and a ``torch.distributed`` world of more
than one process raise ``NotImplementedError``.
"""

import os

import numpy as np
import torch

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.data.factory import Loaders
from dasac_tpu_torch.nn import convert
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim as optim_lib
from dasac_tpu_torch.train import steps as steps_lib
from dasac_tpu_torch.train.checkpoints import BestTracker, Checkpointer
from dasac_tpu_torch.train.metrics import StatManager, summarise
from dasac_tpu_torch.utils import visualise
from dasac_tpu_torch.utils.logging import ScalarWriter
from dasac_tpu_torch.utils.timer import Timer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the panels show this many items (visualise.source_panel's max_items)
_PANEL_ITEMS = 4


def check_single_device(cfg):
    """Raise ``NotImplementedError`` for the settings that need more than
    one device or a mode the port's models lack."""
    tpu = cfg.TPU
    if tpu.PARTITION not in ("shard_map", "gspmd"):
        raise ValueError("unknown TPU.PARTITION %r (expected 'shard_map' or "
                         "'gspmd')" % (tpu.PARTITION,))
    unsupported = []
    if tpu.MESH_DEVICES > 1:
        unsupported.append("TPU.MESH_DEVICES=%d" % tpu.MESH_DEVICES)
    if tpu.PARTITION == "gspmd":
        unsupported.append("TPU.PARTITION='gspmd'")
    if tpu.MESH_SP > 1:
        unsupported.append("TPU.MESH_SP=%d" % tpu.MESH_SP)
    if tpu.REMAT != "none":
        unsupported.append("TPU.REMAT=%r" % (tpu.REMAT,))
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        unsupported.append("%d processes" % dist.get_world_size())
    if unsupported:
        raise NotImplementedError(
            "the port trains on one device in one process; multi-GPU "
            "training and remat are not ported yet (ROADMAP Queue 1 items 1 "
            "and 10): %s" % ", ".join(unsupported))


class Trainer:
    def __init__(self, args, cfg, seed=0, device=None):
        """``device``: default CUDA (raises when there is none)."""
        self.args = args
        self.cfg = cfg
        self.seed = getattr(args, "seed", None) or seed
        check_single_device(cfg)
        self.device = resolve_device(device)

        self.loaders = Loaders(cfg, num_replicas=1, rank=0, seed=self.seed)
        self.nclass = self.loaders.num_classes
        self.class_names = self.loaders.class_names

        self.arch = cfg.MODEL.ARCH
        self.model = build_model(
            self.arch, self.nclass, dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE],
            device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        self.scfg = steps_lib.step_config_from_cfg(cfg)._replace(
            num_classes=self.nclass)
        state = create_train_state(
            self.model, optim_lib.build_optimizer(cfg.MODEL, self.arch,
                                                  self.model),
            self.nclass, device=self.device)

        # ImageNet init (MODEL.INIT_MODEL, models/__init__.py:22-25); the
        # teacher starts as a copy of the loaded student
        init_model = cfg.MODEL.INIT_MODEL
        if init_model and os.path.isfile(init_model):
            sd = torch.load(init_model, map_location="cpu", weights_only=True)
            n_loaded, _ = convert.load_torchvision_backbone(
                self.model, sd.get("model", sd), self.arch)
            print("Loaded {} backbone tensors from {}".format(
                n_loaded, init_model))
            with torch.no_grad():
                for store, src in ((state.teacher_params,
                                    state.student_params()),
                                   (state.teacher_stats,
                                    state.student_stats())):
                    for k, t in store.items():
                        t.copy_(src[k])
        elif init_model:
            print("Backbone model not found: {}".format(init_model))

        # checkpointing / resume
        self.checkpointer = Checkpointer(
            getattr(args, "snapshot_dir", None) or "./snapshots")
        self.start_epoch, best = 0, -1e16
        resume = getattr(args, "resume", None)
        if resume == "auto":
            # preemption recovery: continue from the rolling snapshot
            resume = self.checkpointer.latest_path()
            if resume is None:
                print("No last.pth found; starting fresh")
        if resume:
            state, self.start_epoch, best = self.checkpointer.load(
                resume, state)
            print("Resumed from {} (epoch {}, score {:.3f})".format(
                resume, self.start_epoch, best))
        self.best = BestTracker(self.checkpointer, best)
        self.state = state

        if cfg.MODEL.BASELINE:
            self.train_step = steps_lib.make_abn_step(self.scfg, self.device)
        else:
            self.train_step = steps_lib.make_sac_step(self.scfg, self.device)
        self.eval_step = steps_lib.make_eval_step(self.scfg, self.device)
        self.target_eval_step = steps_lib.make_target_eval_step(
            self.scfg, self.device)
        self.visual_step = steps_lib.make_visual_step(self.scfg, self.device)

        logdir = getattr(args, "logdir", None) or "./logs"
        self.writer = ScalarWriter(os.path.join(logdir, "train"))
        self.writer_target = ScalarWriter(os.path.join(logdir, "train_target"))
        self.writer_val = {vs: ScalarWriter(os.path.join(logdir, vs))
                           for vs in self.loaders.val}
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.fixed = visualise.FixedBatch()

    def _generator(self, *salt):
        """A generator on the device whose seed depends only on ``--seed``
        and ``salt`` (the counterpart of ``jax.random.fold_in``)."""
        seed = self.seed
        for s in salt:
            seed = (seed * 1_000_003 + s) % (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def close(self):
        for w in (self.writer, self.writer_target, *self.writer_val.values()):
            w.close()

    # ------------------------------------------------------------------ train

    def train_epoch(self, epoch):
        cfg = self.cfg
        stat = StatManager()
        timer = Timer()
        src_loader, tgt_loader = self.loaders.train_loaders(epoch)
        images_per_step = (cfg.TRAIN.BATCH_SIZE +
                           cfg.TRAIN.NUM_GROUPS * cfg.TRAIN.GROUP_SIZE)

        pending = None  # read the metrics one step late (no sync stall)
        for i, ((src_i, src_l), (tgt_i, tgt_l)) in enumerate(
                zip(src_loader, tgt_loader)):
            metrics = self.train_step(self.state, (src_i, src_l, tgt_i, tgt_l),
                                      self.generator)
            if pending is not None:
                pi, pmetrics = pending
                self._log_train(stat, pending, epoch)
                if pi % 10 == 0:
                    # the PREVIOUS step's metrics: reading them waits for
                    # that step only, while this one is queued
                    mvals = {k: float(v) for k, v in pmetrics.items()
                             if v.dim() == 0}
                    rate = (pi + 1) * images_per_step / timer.elapsed()
                    msg = " | ".join("{} {:.4f}".format(k, v)
                                     for k, v in sorted(mvals.items()))
                    print("Loss [{:04d}]: {} | Im/Sec: {:.1f}".format(
                        pi, msg, rate))
            pending = (i, metrics)
        if pending is not None:
            self._log_train(stat, pending, epoch)

        for name, val in stat.items():
            self.writer.add_scalar("train_epoch/{}".format(name), val, epoch)
        # per-group learning rates (reference train.py:328-330; constant
        # schedule, groups ordered like BaseNet.parameter_groups)
        for gi, g in enumerate(optim_lib.GROUPS):
            self.writer.add_scalar("lr/enc_group_{:02d}".format(gi),
                                   cfg.MODEL.LR * optim_lib.LR_MULT[g], epoch)
        return stat

    def _log_train(self, stat, pending, epoch):
        _, metrics = pending
        for k, v in metrics.items():
            if k == "self_ce_per_class":
                # [C] vector -> per-class scalars (reference loss_per_class)
                v = v.float().cpu().numpy()
                for ni, cname in enumerate(self.class_names):
                    stat.update_stats(
                        "self_ce_class/{:02d}_{}".format(ni, cname),
                        float(v[ni]))
            else:
                stat.update_stats(k, float(v))

    # ------------------------------------------------------------- validation

    def validation(self, epoch, split, max_batches=None, target_mode=False):
        """Returns the best layer's mIoU on the split (reference
        train.py:339-469)."""
        ignore = set(self.cfg.VAL.IGNORE_CLASS)
        writer = self.writer_val.get(split, self.writer)
        if target_mode:
            return self._validation_target(epoch, max_batches)

        bs = max(1, self.cfg.TRAIN.BATCH_SIZE // 2)
        loader = self.loaders.val_loader(split, batch_size=bs,
                                         max_batches=max_batches)
        conf = None
        first_batch = None
        for imgs, lbls in loader:
            if first_batch is None:
                first_batch = (imgs, lbls)
            c = self.eval_step(self.state, imgs, lbls)
            conf = c if conf is None else conf + c
        if conf is None:  # empty split / max_batches == 0
            return 0.0
        self._visualise_val(writer, split, first_batch, epoch)
        return self._publish(writer, "logits_up", conf, epoch, ignore)

    @torch.no_grad()
    def _visualise_val(self, writer, split, batch, epoch):
        """Input/GT/pred/confidence panel for a fixed val batch
        (reference visualise_results on val sets, base_trainer.py:272-278).
        Only the items the panel shows go through the model."""
        self.fixed.save(split, batch)
        imgs, lbls = (a[:_PANEL_ITEMS] for a in self.fixed.get(split))
        x = P.normalize(torch.from_numpy(imgs).to(self.device).float() / 255.0,
                        self.scfg.mean, self.scfg.std)
        _, up = self.model(x, train=False, update_stats=False)
        panel = visualise.source_panel(x, lbls, up, self.scfg.mean,
                                       self.scfg.std)
        writer.add_image("{}/panel".format(split), panel, epoch)

    def _validation_target(self, epoch, max_batches):
        """Target-train-split validation (reference train.py:510-512, every
        LOG.ITER_TARGET epochs).  SAC: the four teacher/student layers via
        target_eval_step.  ABN baseline: a plain forward (the reference's
        step_target is ``step(train=False)``), publishing logits_up only."""
        ignore = set(self.cfg.VAL.IGNORE_CLASS)
        baseline = self.cfg.MODEL.BASELINE
        _, tgt_loader = self.loaders.train_loaders(epoch,
                                                   replicated_eval=True)
        confs = None
        first_batch = None
        for bi, (imgs, lbls) in enumerate(tgt_loader):
            if max_batches and bi >= max_batches:
                break
            if bi == 0:
                first_batch = (imgs, lbls)
                self.fixed.save("train_target", (imgs, lbls))
            if baseline:
                c = {"logits_up": self.eval_step(self.state, imgs, lbls)}
            else:
                c = self.target_eval_step(self.state, imgs, lbls,
                                          self._generator(10_000 + epoch, bi))
            confs = c if confs is None else {k: confs[k] + c[k] for k in c}
        if baseline:
            if first_batch is not None:  # input/GT/pred panel, like val sets
                self._visualise_val(self.writer_target, "train_target",
                                    first_batch, epoch)
        else:
            self._visualise_target(epoch)
        if confs is None:  # empty loader / max_batches == 0
            return 0.0
        best = 0.0
        for layer, conf in confs.items():
            best = max(best, self._publish(self.writer_target, layer, conf,
                                           epoch, ignore))
        return best

    def _visualise_target(self, epoch):
        """Fixed-batch diagnostic panel + per-class running_conf scalars
        (reference base_trainer.py:118-198)."""
        batch = self.fixed.get("train_target")
        if batch is None:
            return
        imgs, lbls = batch
        # ONE group suffices: the panel shows max_items (= GROUP_SIZE)
        # views, and the full-batch visual forward peaks device memory next
        # to the resident train state
        views, refined, pseudo, student_up, diags = self.visual_step(
            self.state, imgs[:1], lbls[:1], self._generator(777))
        panel = visualise.target_panel(
            views, refined, pseudo, student_up,
            self.scfg.mean, self.scfg.std, diags=diags)
        self.writer_target.add_image("train_target/panel", panel, epoch)
        rc = self.state.running_conf.float().cpu().numpy()
        for ni, cname in enumerate(self.class_names):
            self.writer_target.add_scalar(
                "running_conf/{:02d}_{}".format(ni, cname), rc[ni], epoch)

    def _publish(self, writer, layer, conf, epoch, ignore):
        iou, pr, re = summarise(conf)
        keep = [i for i in range(self.nclass) if i not in ignore]
        for ni, cname in enumerate(self.class_names):
            label = "{}_{:02d}_{}".format(layer, ni, cname)
            writer.add_scalar("{}/IoU".format(label), iou[ni], epoch)
            writer.add_scalar("{}/Precision".format(label), pr[ni], epoch)
            writer.add_scalar("{}/Recall".format(label), re[ni], epoch)
        miou = float(np.mean(iou[keep]))
        writer.add_scalar("{}_all/mIoU".format(layer), miou, epoch)
        writer.add_scalar("{}_all/Precision".format(layer),
                          float(np.mean(pr[keep])), epoch)
        writer.add_scalar("{}_all/Recall".format(layer),
                          float(np.mean(re[keep])), epoch)
        print("[{}] mIoU {:.3f}".format(layer, miou))
        return miou

    # ------------------------------------------------------------------- fit

    def fit(self):
        cfg = self.cfg
        log_val = cfg.LOG.ITER_VAL
        log_target = cfg.LOG.ITER_TARGET
        for epoch in range(self.start_epoch, cfg.TRAIN.NUM_EPOCHS + 1):
            print("Epoch >>> {:02d} <<<".format(epoch))
            # target-split validation runs for BOTH modes (the reference's
            # baseline uses step_target = step(train=False), train.py:115)
            if epoch > self.start_epoch and epoch % log_target == 0:
                self.validation(epoch, cfg.TRAIN.TARGET, max_batches=300,
                                target_mode=True)
            if epoch > self.start_epoch and epoch % log_val == 0:
                score = 0.0
                for vs in self.loaders.val:
                    s = self.validation(epoch, vs)
                    if vs == self.loaders.testset:
                        score += s
                saved = self.best.update(self.state, score, epoch)
                if saved:
                    print("New best snapshot: {}".format(saved))
            self.train_epoch(epoch)
            # rolling preemption-safe snapshot after every epoch
            self.checkpointer.save_latest(self.state, self.best.best,
                                          epoch + 1)
        return self.state
