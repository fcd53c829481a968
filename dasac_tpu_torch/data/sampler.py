"""Samplers: epoch shuffling and class-uniform importance sampling (a copy
of ``dasac_tpu/data/sampler.py``; reference ``DistributedSampler`` usage +
``DataTarget``'s inverse-CDF sampling, dataloader_target.py:146-198,
264-272).  Every ``numpy.random.RandomState`` seed is ``dasac_tpu``'s, so
the index streams are identical."""

import os
import pickle

import numpy as np


class EpochSampler:
    """Deterministic per-epoch shuffle, shardable across hosts (the
    reference's torch DistributedSampler role: epoch-seeded permutation,
    per-rank slice, padded to equal length).

    ``indices(batch_size=b)`` slices at BATCH granularity: rank r's batch
    ``i`` is ``order[i*R*b + r*b : i*R*b + (r+1)*b]``, so the global batch
    assembled rank-by-rank (``shard_batch`` concatenation order) is exactly
    the single-process batch ``order[i*R*b : (i+1)*R*b]`` — the pod
    trajectory reproduces the solo trajectory sample-for-sample (device-side
    augmentation keys are positional).  Without ``batch_size`` the slice is
    torch-DistributedSampler rank-strided (``order[rank::R]``) — same
    coverage, but the within-batch order differs from single-process."""

    def __init__(self, num_samples, num_replicas=1, rank=0, shuffle=True,
                 seed=0, drop_last=False):
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def indices(self, batch_size=None):
        n = self.num_samples
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            order = g.permutation(n)
        else:
            order = np.arange(n)
        R = self.num_replicas
        if batch_size is not None:
            stride = R * batch_size
            if self.drop_last:
                nb = n // stride
                order = order[: nb * stride]
            else:
                nb = -(-n // stride)
                pad = nb * stride - n
                if pad:  # wrap-pad like the strided branch below
                    order = np.concatenate(
                        [order, np.resize(order, pad)])
            return order.reshape(-1, R, batch_size)[:, self.rank, :].ravel()
        if self.drop_last:
            per = n // R
            order = order[: per * R]
        else:
            per = -(-n // R)
            pad = per * R - n
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.rank::R]


def load_sample_weights(path):
    """Load IS weights {mask_basename: {class_id: fraction}}.

    Accepts the pickle format of ``dasac_tpu/tools/compute_is_weights.py``
    and the reference's torch.save format (compute_IS_weights.py:97); the
    latter holds a plain dict, so ``torch.load`` needs
    ``weights_only=False`` for this legacy file only.
    """
    if not path:
        return None
    if not os.path.isfile(path):
        # loud, like the reference (dataloader_target.py:88): a typo'd path
        # silently degrading to uniform sampling is hard to notice
        print("Path to sample weights NOT found: {} -- falling back to "
              "uniform class sampling".format(path))
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)


class ImportanceSampler:
    """Class-uniform importance sampling over the target split.

    index -> class c = index % C; sample id drawn by inverse CDF over
    per-class cumulative weights.  Weight construction matches
    init_sampling: ``prior_weight * uniform + (1-prior_weight) * class_pixel
    _fraction``; classes in ``ignore_class`` fall back to uniform.
    """

    def __init__(self, num_images, num_classes, mask_names=None, weights=None,
                 prior_weight=0.25, ignore_class=()):
        self.num_classes = num_classes
        prior = 1.0 / num_images
        cum = np.full((num_classes, num_images), prior, np.float64)
        if weights is not None:
            assert mask_names is not None
            assert len(weights) == num_images, (
                "IS weights cover {} images, split has {}".format(
                    len(weights), num_images))
            index = {name: i for i, name in enumerate(mask_names)}
            cum *= prior_weight
            for name, stat in weights.items():
                i = index[name]
                for cid, val in stat.items():
                    cid = int(cid)
                    if cid < num_classes:
                        cum[cid, i] += (1.0 - prior_weight) * float(val)
            for cid in ignore_class:
                cum[cid, :] = prior
        cum = np.cumsum(cum, axis=1)
        totals = cum[:, -1]
        # classes absent from the weight stats keep only the uniform prior
        # mass; sampling normalizes by row[-1], so they fall back to uniform
        assert np.all(totals > 1e-9), totals
        covered = np.abs(totals - 1.0) < 1e-3
        if weights is not None and not covered.all():
            missing = np.nonzero(~covered)[0].tolist()
            print("ImportanceSampler: classes {} absent from weights, "
                  "using uniform sampling for them".format(missing))
        self._cum = cum

    def sample(self, index, rng):
        """(split-index, np.random.RandomState) -> image id."""
        cid = index % self.num_classes
        row = self._cum[cid]
        r = rng.uniform(0, row[-1])
        return int(np.searchsorted(row, r, side="left"))
