"""Dataloader factory (counterpart of ``dasac_tpu/data/factory.py``; the
reference's datasets/__init__.py:14-78).

Builds host-side prefetch loaders for:
  * source train split (renormalisation handled on-device by the step config)
  * target train split — SAC: importance-sampled groups at CROP_SIZE;
    ABN baseline: plain source-style loader
  * the four validation splits per task, plus the checkpoint-selection set

Split sizes come from the first image's PNG header.  A split is served from
a memmap pack (``data/packed.py``) when one matches its name, size, decode
mode and current file list; the trainer passes ``num_replicas=1, rank=0``.
"""

import os

from dasac_tpu_torch.data import host_loader, lists, native, packed, sampler
from dasac_tpu_torch.data.category import get_class_names, get_num_classes
from dasac_tpu_torch.data.png import png_size


def get_val_sets(task):
    """(val splits, checkpoint-selection split) — datasets/__init__.py:21-27."""
    if task == "train_game_9K":
        return ("val_game_1K", "train_cityscapes", "val_cityscapes",
                "val2_cityscapes"), "val2_cityscapes"
    if task == "train_synthia_9K":
        return ("val_synthia", "train_cityscapes", "val_cityscapes",
                "val2_cityscapes"), "val2_cityscapes"
    raise NotImplementedError("Train split '{}' not recognised".format(task))


def _split_size(split, images):
    probed = png_size(images[0])
    if "game" in split:
        # GTA frames vary slightly in size; the reference standardizes them
        # to 1052x1914 (dataloader_seg.py:151-153).  Synthetic/test data is
        # far smaller — forcing the canonical size there would upscale 20x,
        # so only apply it within a plausible range.
        forced = lists.canonical_size(split)
        if probed[0] >= forced[0] // 2:
            return forced
    return probed


def open_dataset(cfg, split, images, masks, out_hw, mode):
    """SegDataset, or a PackedDataset when a matching memmap pack exists
    (decoded offline by tools/pack_dataset.py — skips all PNG work)."""
    pdir = getattr(cfg.TPU, "PACKED_DIR", "")
    if pdir:
        if pdir == "auto":
            pdir = packed.default_dir(cfg.DATASET.ROOT)
        hdr = packed.find_pack(pdir, split, out_hw, mode)
        if hdr is not None:
            try:
                ds = packed.PackedDataset(hdr)
            except (OSError, ValueError):  # truncated/corrupt data files
                ds = None
            # the pack must match the split's CURRENT file list, in order —
            # a regenerated or re-sorted list silently shuffles sample
            # identity otherwise (the header stores the packing-time order).
            # Image basenames matter too: mask-less splits would otherwise
            # match any same-length pack ([None]*n == [None]*n)
            cur_m = [None if m is None else os.path.basename(m)
                     for m in masks]
            cur_i = [os.path.basename(p) for p in images]
            if (ds is not None and ds.mask_basenames() == cur_m
                    and ds.image_basenames() == cur_i):
                return ds
    return host_loader.SegDataset(images, masks, out_hw, mode=mode)


class Loaders:
    """Bundle the trainer consumes."""

    def __init__(self, cfg, num_replicas=1, rank=0, seed=0):
        self.cfg = cfg
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.num_classes = get_num_classes()
        self.class_names = get_class_names()
        root = cfg.DATASET.ROOT
        task = cfg.TRAIN.TASK
        crop = tuple(cfg.DATASET.CROP_SIZE)

        native.set_enabled(cfg.TPU.NATIVE_LOADER)

        # ---- source train ---------------------------------------------------
        src_imgs, src_msks = lists.read_split(root, task)
        self.source = open_dataset(
            cfg, task, src_imgs, src_msks, _split_size(task, src_imgs),
            mode="resize")

        # ---- target train ---------------------------------------------------
        tgt_split = cfg.TRAIN.TARGET
        tgt_imgs, tgt_msks = lists.read_split(root, tgt_split)
        if cfg.MODEL.BASELINE:
            self.target = open_dataset(
                cfg, tgt_split, tgt_imgs, tgt_msks,
                _split_size(tgt_split, tgt_imgs), mode="resize")
            self.importance = None
        else:
            # SAC target groups are decoded straight at CROP_SIZE (the
            # reference's MaskScale(CROP_SIZE) head of the pipeline)
            self.target = open_dataset(
                cfg, tgt_split, tgt_imgs, tgt_msks, crop, mode="resize")
            weights = sampler.load_sample_weights(cfg.DATASET.SAMPLE_WEIGHTS)
            self.importance = sampler.ImportanceSampler(
                len(tgt_imgs), self.num_classes,
                mask_names=self.target.mask_basenames(),
                weights=weights,
                prior_weight=cfg.DATASET.SAMPLE_UNIFORM_PRIOR,
                ignore_class=tuple(cfg.VAL.IGNORE_CLASS))
        # epoch alignment (datasets/__init__.py:56)
        self.target.set_num_samples(len(self.source))

        # ---- validation -----------------------------------------------------
        val_sets, self.testset = get_val_sets(task)
        self.val = {}
        for vs in val_sets:
            vi, vm = lists.read_split(root, vs)
            mode = "center_crop" if cfg.DATASET.VAL_CROP else "resize"
            self.val[vs] = open_dataset(cfg, vs, vi, vm, crop, mode=mode)

    # ---- per-epoch loader builders -----------------------------------------

    def source_batch_size(self):
        """GLOBAL source batch (reference TRAIN.BATCH_SIZE semantics)."""
        return max(1, self.cfg.TRAIN.BATCH_SIZE)

    def target_batch_size(self):
        # same for SAC and the ABN baseline (datasets/__init__.py:64)
        return max(1, self.cfg.TRAIN.NUM_GROUPS)

    def steps_per_epoch(self):
        """zip() semantics over GLOBAL batch sizes (train.py:266)."""
        n_src = len(self.source) // self.source_batch_size()
        n_tgt = len(self.target) // self.target_batch_size()
        steps = min(n_src, n_tgt)
        if steps == 0:
            raise ValueError(
                "split smaller than one global batch: {} source / {} target "
                "samples vs batch sizes {}/{}".format(
                    len(self.source), len(self.target),
                    self.source_batch_size(), self.target_batch_size()))
        return steps

    def train_loaders(self, epoch, replicated_eval=False):
        cfg = self.cfg
        steps = self.steps_per_epoch()
        # multi-host: each process loads 1/num_replicas of every batch, in
        # rank order, so the assembled global batch matches single-host;
        # with replicated_eval every host loads full batches (for unsharded
        # evaluation steps)
        reps = 1 if replicated_eval else self.num_replicas
        rank = 0 if replicated_eval else self.rank
        assert self.source_batch_size() % reps == 0 and \
            self.target_batch_size() % reps == 0, (
                "global batch sizes must divide the process count")
        bs_src = self.source_batch_size() // reps
        bs_tgt = self.target_batch_size() // reps

        s_sampler = sampler.EpochSampler(
            len(self.source), num_replicas=reps, rank=rank,
            shuffle=True, seed=self.seed, drop_last=True)
        s_sampler.set_epoch(epoch)
        src_loader = host_loader.PrefetchLoader(
            self.source, bs_src, steps,
            host_loader.make_plain_index_fn(
                s_sampler.indices(batch_size=bs_src), bs_src),
            threads=cfg.TPU.LOADER_THREADS, prefetch=cfg.TPU.PREFETCH)

        # distinct stream constant: seed+1 would collide with the source
        # sampler at epoch+1 (both datasets share a length after
        # set_num_samples, so the permutations would be identical)
        t_sampler = sampler.EpochSampler(
            len(self.target), num_replicas=reps, rank=rank,
            shuffle=True, seed=self.seed + 1_000_003, drop_last=True)
        t_sampler.set_epoch(epoch)
        if self.importance is not None:
            index_fn = host_loader.make_importance_index_fn(
                self.importance, t_sampler.indices(batch_size=bs_tgt),
                bs_tgt, epoch, seed=self.seed)
        else:
            index_fn = host_loader.make_plain_index_fn(
                t_sampler.indices(batch_size=bs_tgt), bs_tgt)
        tgt_loader = host_loader.PrefetchLoader(
            self.target, bs_tgt, steps, index_fn,
            threads=cfg.TPU.LOADER_THREADS, prefetch=cfg.TPU.PREFETCH)
        return src_loader, tgt_loader

    def val_loader(self, split, batch_size=None, max_batches=None):
        """Whole batches in one process: the trainer evaluates on one
        device (multi-process validation is ROADMAP Queue 1 item 10)."""
        ds = self.val[split]
        bs = batch_size or max(1, self.cfg.TRAIN.BATCH_SIZE // 2)
        return host_loader.padded_plain_loader(
            ds, bs, self.cfg.TPU.LOADER_THREADS, self.cfg.TPU.PREFETCH,
            max_batches=max_batches)
