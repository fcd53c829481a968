"""Training visualisation grids (counterpart of
``dasac_tpu/utils/visualise.py``; reference base_trainer.py:75-278).

The same diagnostic panels: input views, GT masks, pseudo-labels,
student/teacher predictions, confidence and entropy heatmaps, and the
teacher-aligned views, stacked into one uint8 image grid per tag.  Inputs
may be numpy arrays or torch tensors on any device: the per-pixel
reductions over classes (softmax, argmax, max, entropy) run where the
tensors are, so only [B, H, W] maps come to the host.  A fixed batch is
captured once so the panels stay comparable epoch over epoch.
"""

import numpy as np
import torch

from dasac_tpu_torch.data.category import colorize


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_u8(img01):
    return (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)


def denorm_to_u8(frames, mean, std):
    """Normalized [B,H,W,3] -> uint8 RGB."""
    frames = _np(frames).astype(np.float32)
    return _to_u8(frames * np.asarray(std, np.float32)
                  + np.asarray(mean, np.float32))


def heatmap(values01, cmap="inferno"):
    """[B,H,W] in [0,1] -> uint8 RGB via a matplotlib colormap (gray where
    matplotlib is absent)."""
    v = np.clip(_np(values01), 0, 1)
    try:
        import matplotlib

        mapper = matplotlib.colormaps[cmap]
    except (ImportError, KeyError):
        return np.stack([_to_u8(v)] * 3, -1)
    return _to_u8(mapper(v)[..., :3])


def grid(rows):
    """rows: list of [B,H,W,3] uint8 -> one [R*(H+2), B*(W+2), 3]."""
    pad = 2
    rows = [np.asarray(r) for r in rows]
    b, h, w, _ = rows[0].shape
    out = np.zeros((len(rows) * (h + pad), b * (w + pad), 3), np.uint8)
    for ri, row in enumerate(rows):
        for bi in range(min(b, row.shape[0])):
            out[ri * (h + pad):ri * (h + pad) + h,
                bi * (w + pad):bi * (w + pad) + w] = row[bi]
    return out


def masks_to_rgb(masks):
    return np.stack([colorize(m) for m in _np(masks)])


def _argmax_rgb(scores):
    return masks_to_rgb(_t(scores).float().argmax(-1))


def entropy_heatmap(probs):
    """[B,H,W,C] probabilities -> normalized-entropy jet heatmap
    (reference base_trainer.py:244-250 _error_rgb with the jet colormap)."""
    p = torch.clamp(_t(probs).float(), 1e-8, 1.0)
    ent = -(p * torch.log(p)).sum(-1) / np.log(p.shape[-1])
    return heatmap(ent, cmap="jet")


def target_panel(views, refined_probs, pseudo, student_up, mean, std,
                 max_items=4, diags=None):
    """The reference's train_target visual: aug view / clean view / GT /
    pseudo-labels / student pred / teacher refined pred / teacher conf /
    teacher entropy (jet), plus the teacher-ALIGNED views (warped frame,
    aligned pred, aligned conf — base_trainer.py:170-176)."""
    sel = slice(0, max_items)
    refined = _t(refined_probs)[sel].float()
    rows = [denorm_to_u8(views.frames_aug[sel], mean, std),
            denorm_to_u8(views.frames_clean[sel], mean, std),
            masks_to_rgb(views.labels[sel]), masks_to_rgb(pseudo[sel]),
            _argmax_rgb(student_up[sel]), _argmax_rgb(refined),
            heatmap(refined.max(-1).values), entropy_heatmap(refined)]
    if diags and "teacher_aligned" in diags:
        aligned = _t(diags["teacher_aligned"])[sel].float()
        frames_al = denorm_to_u8(diags["frames_aligned"][sel], mean, std)
        blend = (0.3 * frames_al + 0.7 * _argmax_rgb(aligned)).astype(
            np.uint8)
        rows += [frames_al, blend, heatmap(aligned.max(-1).values)]
    return grid(rows)


def source_panel(frames, labels, logits_up, mean, std, max_items=4):
    """Input / GT / prediction / confidence for a source batch."""
    sel = slice(0, max_items)
    probs = torch.softmax(_t(logits_up)[sel].float(), -1)
    conf, _ = probs.max(-1)
    return grid([denorm_to_u8(frames[sel], mean, std),
                 masks_to_rgb(labels[sel]), _argmax_rgb(probs),
                 heatmap(conf)])


class FixedBatch:
    """Capture-once storage for stable epoch-over-epoch visuals
    (reference save_fixed_batch / has_fixed_batch)."""

    def __init__(self):
        self._batches = {}

    def save(self, tag, batch):
        if tag not in self._batches:
            self._batches[tag] = tuple(np.asarray(x) for x in batch)

    def get(self, tag):
        return self._batches.get(tag)
