"""Segmentation metrics as on-device confusion accumulation (counterpart of
``dasac_tpu/train/metrics.py``).

A batch contributes one [C, C] confusion matrix (rows = ground truth,
columns = prediction), counted exactly in int64 on the device without a
host sync.  tp/fp/fn and the IoU/precision/recall formulas are the
reference's (``tp / max(1e-3, .)``, reference utils/metrics.py:41-53).
"""

import numpy as np
import torch


def confusion_matrix(pred, gt, num_classes, ignore=255):
    """[..., H, W] integer predictions and ground truth -> int64 [C, C].

    Counts what the JAX version counts: a pixel whose ``gt`` is not
    ``ignore`` goes to the flat cell ``gt*C + pred`` (negative indices clip
    to 0, as ``jnp.bincount`` clips them) when that index is below ``C*C``,
    and is dropped otherwise.  So a prediction of 255 (an unlabelled teacher
    pixel) with ``gt*C + 255 < C*C`` (gt <= 5 for C = 19) lands in row
    ``gt + 255 // C``, column ``255 % C``, as in ``dasac_tpu``; the
    reference's Jaccard would count it as a false negative of ``gt``
    (ROADMAP, Queue 3).  Dropped and ignored pixels go to one extra bin
    that is sliced off, so there is no boolean indexing.

    Bins are one row per row of pixels, so the atomic adds of a row spread
    over its own bins instead of all meeting on ``C*C`` addresses.
    """
    c = num_classes
    gt = gt.long()
    flat = (gt * c + pred.long()).clamp_min(0)
    idx = torch.where((gt != ignore) & (flat < c * c), flat, c * c)
    idx = idx.reshape(-1, idx.shape[-1]) if idx.dim() > 1 else idx.view(1, -1)
    bins = torch.zeros((idx.shape[0], c * c + 1), dtype=torch.int64,
                       device=idx.device)
    bins.scatter_add_(1, idx, torch.ones_like(idx))
    return bins.sum(dim=0)[:c * c].view(c, c)


def tp_fp_fn(conf):
    tp = torch.diagonal(conf)
    fp = conf.sum(dim=0) - tp
    fn = conf.sum(dim=1) - tp
    return tp, fp, fn


def _numpy(conf):
    if isinstance(conf, torch.Tensor):
        conf = conf.detach().cpu().numpy()
    return np.asarray(conf, np.float64)


def summarise(conf):
    """Per-class (iou, precision, recall) numpy arrays (reference
    utils/metrics.py:41-53)."""
    conf = _numpy(conf)
    tp = np.diagonal(conf)
    fp = conf.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    denom_j = np.maximum(1e-3, tp + fp + fn)
    denom_p = np.maximum(1e-3, tp + fp)
    denom_r = np.maximum(1e-3, tp + fn)
    return tp / denom_j, tp / denom_p, tp / denom_r


def mean_iou(conf, ignore_class=()):
    iou, _, _ = summarise(conf)
    skip = set(ignore_class)
    keep = [i for i in range(iou.shape[0]) if i not in skip]
    return float(np.mean(iou[keep]))


class StatManager:
    """Scalar running-average registry (reference utils/stat_manager.py)."""

    def __init__(self):
        self._sums = {}
        self._counts = {}

    def update_stats(self, key, val, count=1):
        self._sums[key] = self._sums.get(key, 0.0) + float(val) * count
        self._counts[key] = self._counts.get(key, 0) + count

    def __getitem__(self, key):
        return self._sums[key] / max(1, self._counts[key])

    def items(self):
        for k in self._sums:
            yield k, self[k]

    def keys(self):
        return self._sums.keys()

    def has_vals(self, key):
        return key in self._sums and self._counts[key] > 0
