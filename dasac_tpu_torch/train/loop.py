"""Trainer: epoch loop, validation cadence, best-3 and rolling snapshots
(counterpart of ``dasac_tpu/train/loop.py``; reference train.py:48-533).

The host feeds uint8 batches from the prefetch loaders and reads each
step's metrics back only after it has launched the next step: on CUDA,
``float()`` on step i-1's tensors then waits for step i-1 alone, while step
i is queued behind it.  Randomness: one ``torch.Generator`` on the device,
seeded from ``--seed``, draws every train step's augmentation; target
validation seeds a generator per (epoch, batch) and the visual panel one
fixed generator, so their draws are the same in every run.

One process drives one device.  Inside a ``torch.distributed`` world (the
counterpart of ``dasac_tpu``'s shard_map branch, loop.py:36-133) each rank
decodes its slice of every global batch and runs its share of each step
(``train/steps.py``); every rank's generators add the rank to their salt,
so each draws its own augmentation (``dasac_tpu``'s ``_fold_axis``).  The
state is broadcast from rank 0 after start-up and resume; rank 0 alone
writes events, panels and snapshots; validation is sharded over the ranks,
with the confusions summed.  ``TPU.REMAT`` (none / block / convs) goes to
the model.

``TPU.PARTITION`` "gspmd" (``dasac_tpu``'s loop.py:39-77, 215-239): the
world is a ``(data, sp)`` layout (``core.mesh.train_mesh``, ``TPU.MESH_SP``
ranks a frame) running the global-batch steps (``make_gspmd_*``).  Rank
``(d, s)`` decodes data slice ``d`` of every batch (the ``sp`` ranks of a
slice decode the same frames), the generators are not salted (every rank
draws the global batch's augmentation), and the validation batch rounds
to the data axis.
"""

import os
import time

import numpy as np
import torch

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.core.mesh import train_groups, train_mesh
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.data import native_build
from dasac_tpu_torch.data.factory import Loaders
from dasac_tpu_torch.nn import convert
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.nn.resnet import remat_mode
from dasac_tpu_torch.ops import ce, cuda_build
from dasac_tpu_torch.train import optim as optim_lib
from dasac_tpu_torch.train import steps as steps_lib
from dasac_tpu_torch.train.checkpoints import BestTracker, Checkpointer
from dasac_tpu_torch.train.metrics import StatManager, summarise
from dasac_tpu_torch.utils import visualise
from dasac_tpu_torch.utils.logging import NullWriter, ScalarWriter
from dasac_tpu_torch.utils.timer import Timer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the panels show this many items (visualise.source_panel's max_items)
_PANEL_ITEMS = 4


def check_partition(cfg):
    """Raise ``ValueError`` for an unknown ``TPU.PARTITION`` or
    ``TPU.REMAT``."""
    tpu = cfg.TPU
    remat_mode(tpu.REMAT)
    if tpu.PARTITION not in ("shard_map", "gspmd"):
        raise ValueError("unknown TPU.PARTITION %r (expected 'shard_map' or "
                         "'gspmd')" % (tpu.PARTITION,))


def mesh_size(cfg, available, world=None, n_local=None):
    """The ``core.mesh.TrainLayout`` ``cfg`` asks for: the ranks the
    train CLI spawns over ``available`` devices, or the layout of a
    ``world`` already joined (``core.mesh.train_mesh``)."""
    check_partition(cfg)
    return train_mesh(cfg, available, world, n_local)


def _local_ranks():
    """The ranks this host runs in a joined world (torchrun's
    ``LOCAL_WORLD_SIZE``), or ``None`` when nothing says."""
    n = os.environ.get("LOCAL_WORLD_SIZE")
    return int(n) if n else None


class Trainer:
    def __init__(self, args, cfg, seed=0, device=None):
        """``device``: default CUDA (raises when there is none)."""
        self.args = args
        self.cfg = cfg
        self.seed = getattr(args, "seed", None) or seed
        self.device = resolve_device(device)
        # a process group, when there is one, is the mesh: it spans every
        # rank whatever TPU.MESH_DEVICES says (dasac_tpu's pod rule)
        self.group = dist.group()
        self.world, self.rank = dist.world_size(), dist.rank()
        self.is_main = self.rank == 0
        if self.group is None:
            self.layout = mesh_size(cfg, 1)
            if self.layout.ranks > 1:
                raise ValueError(
                    "TPU.MESH_DEVICES={} asks for one process per device: "
                    "train through train.cli, which spawns them, or join a "
                    "world with --multiprocessing-distributed".format(
                        cfg.TPU.MESH_DEVICES))
        else:
            self.layout = mesh_size(cfg, 1, world=self.world,
                                    n_local=_local_ranks())
        self.gspmd = self.layout.gspmd
        # gspmd in a world: the (data, sp) groups; the loaders slice the
        # batch by data index
        self.groups = (train_groups(self.layout, self.rank, self.group)
                       if self.gspmd and self.group is not None else None)
        n_data, d = ((self.layout.n_data, self.groups.d)
                     if self.groups is not None else (self.world, self.rank))
        self.n_data = n_data
        print("Mesh: {} device(s) / {} process(es){}".format(
            self.world, self.world,
            " (gspmd {}x{})".format(self.layout.n_data, self.layout.n_sp)
            if self.gspmd else
            " (data-parallel)" if self.world > 1 else ""))
        self._build_on_rank0_first(cfg)

        self.loaders = Loaders(cfg, num_replicas=n_data, rank=d,
                               seed=self.seed)
        self.nclass = self.loaders.num_classes
        self.class_names = self.loaders.class_names

        self.arch = cfg.MODEL.ARCH
        self.model = build_model(
            self.arch, self.nclass, dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE],
            remat=cfg.TPU.REMAT, device=self.device, group=self.group,
            generator=torch.Generator().manual_seed(self.seed))
        self.scfg = steps_lib.step_config_from_cfg(cfg)._replace(
            num_classes=self.nclass)
        state = create_train_state(
            self.model, optim_lib.build_optimizer(cfg.MODEL, self.arch,
                                                  self.model, self.seed),
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
        if resume == "auto" and self.is_main:
            # preemption recovery: continue from the rolling snapshot
            resume = self.checkpointer.latest_path()
            if resume is None:
                print("No last.pth found; starting fresh")
        if resume and self.is_main:
            state, self.start_epoch, best = self.checkpointer.load(
                resume, state)
            print("Resumed from {} (epoch {}, score {:.3f})".format(
                resume, self.start_epoch, best))
        # rank 0 alone resolved and read the snapshot: every rank takes its
        # state, epoch and score, bit for bit
        dist.broadcast_state(state, self.device, group=self.group)
        self.start_epoch, best = dist.broadcast_values(
            (self.start_epoch, best), self.device, group=self.group)
        self.start_epoch = int(self.start_epoch)
        self.best = BestTracker(self.checkpointer, best)
        self.state = state

        g, gs = self.group, self.groups
        if gs is not None:
            self.train_step = (steps_lib.make_gspmd_abn_step
                               if cfg.MODEL.BASELINE else
                               steps_lib.make_gspmd_sac_step)(
                self.scfg, gs, self.device)
            self.eval_step = steps_lib.make_gspmd_eval_step(
                self.scfg, gs, self.device)
            self.target_eval_step = steps_lib.make_gspmd_target_eval_step(
                self.scfg, gs, self.device)
        else:
            self.train_step = (steps_lib.make_abn_step
                               if cfg.MODEL.BASELINE else
                               steps_lib.make_sac_step)(
                self.scfg, self.device, group=g)
            self.eval_step = steps_lib.make_eval_step(self.scfg, self.device,
                                                      group=g)
            self.target_eval_step = steps_lib.make_target_eval_step(
                self.scfg, self.device, group=g)
        self.visual_step = steps_lib.make_visual_step(self.scfg, self.device)

        logdir = getattr(args, "logdir", None) or "./logs"

        def writer(sub):
            if self.is_main:
                return ScalarWriter(os.path.join(logdir, sub))
            return NullWriter()

        self.writer = writer("train")
        self.writer_target = writer("train_target")
        self.writer_val = {vs: writer(vs) for vs in self.loaders.val}
        self.generator = self._generator()
        self.fixed = visualise.FixedBatch()
        # (epoch, index in the epoch, ms) of every train step run: the
        # time between marks around the step call, CUDA events on the card
        self.step_ms = []

    def _build_on_rank0_first(self, cfg):
        """In a world, rank 0 builds the CUDA kernels and the native decoder
        while the others wait, and they load what it built (two ranks'
        builds would be safe, but redundant)."""
        if self.group is None:
            return
        if not self.is_main:
            dist.barrier(self.device, self.group)
        if self.device.type == "cuda":
            cuda_build.build(ce.SOURCE)
        if cfg.TPU.NATIVE_LOADER:
            native_build.build()
        if self.is_main:
            dist.barrier(self.device, self.group)

    def _generator(self, *salt):
        """A generator on the device whose seed depends only on ``--seed``,
        ``salt`` and, in a shard_map world of more than one rank, the rank
        (the counterpart of ``jax.random.fold_in`` and ``_fold_axis``)."""
        seed = self.seed
        own = self.world > 1 and not self.gspmd
        for s in salt + ((self.rank,) if own else ()):
            seed = (seed * 1_000_003 + s) % (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _mark(self):
        """A CUDA event recorded on the current stream on the card, the
        host clock elsewhere: no synchronization."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _elapsed_ms(self, marks):
        """ms between each ``(start, end)`` pair of marks, once the last
        end is reached."""
        if self.device.type == "cuda":
            if marks:
                marks[-1][1].synchronize()
            return [a.elapsed_time(b) for a, b in marks]
        return [(b - a) * 1e3 for a, b in marks]

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
        marks = []
        for i, ((src_i, src_l), (tgt_i, tgt_l)) in enumerate(
                zip(src_loader, tgt_loader)):
            start = self._mark()
            metrics = self.train_step(self.state, (src_i, src_l, tgt_i, tgt_l),
                                      self.generator)
            marks.append((start, self._mark()))
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
        self.step_ms.extend((epoch, i, ms) for i, ms in
                            enumerate(self._elapsed_ms(marks)))

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
        # sharded: the global batch rounds to whole per-slice batches (the
        # data axis under gspmd), and each rank decodes only its slice of
        # it (the eval step sums the confusions over the ranks)
        n = self.n_data
        bs = max(n, (bs // n) * n)
        loader = self.loaders.val_loader(split, batch_size=bs // n,
                                         max_batches=max_batches,
                                         distributed=n > 1)
        conf = None
        first_batch = None
        for imgs, lbls in loader:
            if first_batch is None:
                first_batch = (imgs, lbls)
            c = self.eval_step(self.state, imgs, lbls)
            conf = c if conf is None else conf + c
        if self.world > 1:
            print("[val:{}] rank {} decoded {} real images".format(
                split, self.rank, loader.n_real))
        if conf is None:  # empty split / max_batches == 0
            return 0.0
        if self.is_main:
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
        # sharded like the train step: each rank decodes its groups
        _, tgt_loader = self.loaders.train_loaders(epoch)
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
        if self.is_main and baseline and first_batch is not None:
            # input/GT/pred panel, like val sets
            self._visualise_val(self.writer_target, "train_target",
                                first_batch, epoch)
        elif self.is_main and not baseline:
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
                if self.is_main:
                    saved = self.best.update(self.state, score, epoch)
                    if saved:
                        print("New best snapshot: {}".format(saved))
                dist.barrier(self.device, self.group)
            self.train_epoch(epoch)
            # rolling preemption-safe snapshot after every epoch
            if self.is_main:
                self.checkpointer.save_latest(self.state, self.best.best,
                                              epoch + 1)
            dist.barrier(self.device, self.group)
        if self.world > 1:
            n = dist.assert_replicas_equal(
                dist.state_tensors(self.state, self.device, group=self.group),
                self.device, self.group)
            print("Replicas equal: {} tensors on {} ranks".format(
                n, self.world))
        return self.state
