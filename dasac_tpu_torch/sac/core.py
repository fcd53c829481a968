"""SAC algorithm core as plain functions on tensors (counterpart of
``dasac_tpu/sac/core.py``).

Layout: probabilities/logits are channels-last ``[..., H, W, C]``; label
maps are ``[..., H, W]`` int32 with 255 = ignore.  The teacher lazy-init /
EMA branch is decided on the host from the step counter and ``slow_init``,
which the train state keeps as Python values (no device sync per step).
"""

import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.ops.ce import nll_fused

IGNORE = 255


# ---------------------------------------------------------------------------
# running class prior (reference models/sac.py:104-117)
# ---------------------------------------------------------------------------

def update_running_conf(running_conf, probs, stat_momentum, threshold_beta,
                        tolerance=1e-8, group=None):
    """EMA of the mean class probability.

    Classes still at their init value (``threshold_beta``) adopt the batch
    average directly; others get ``m*old + (1-m)*avg``.  With a process
    ``group`` the batch average is averaged over its ranks first, so every
    replica tracks the global prior.
    """
    c = probs.shape[-1]
    probs_avg = probs.reshape(-1, c).float().mean(dim=0)
    dist.all_reduce_mean_([probs_avg], group)
    is_new = (probs_avg > tolerance) & (running_conf == threshold_beta)
    ema = stat_momentum * running_conf + (1.0 - stat_momentum) * probs_avg
    return torch.where(is_new, probs_avg, ema)


def threshold_discount(running_conf, threshold_beta):
    """1 - exp(-prior/beta): relaxes thresholds for long-tail classes."""
    return 1.0 - torch.exp(-running_conf / threshold_beta)


# ---------------------------------------------------------------------------
# pseudo-label generation (reference models/sac.py:154-187)
# ---------------------------------------------------------------------------

def pseudo_labels(probs, ignore_augm, running_conf, *, upper, lower,
                  threshold_beta, discount=True,
                  compute_dtype=torch.float32):
    """Adaptive-threshold pseudo labels.

    Per image, each class's confidence peak (max prob over pixels where that
    class is the argmax) sets its threshold ``clamp(upper*peak*discount_c,
    min=lower)``; a pixel keeps its argmax label iff its confidence strictly
    exceeds the argmax class's threshold.

    Args:
        probs: [B, H, W, C] teacher probabilities.
        ignore_augm: [B, H, W] bool, True at augmentation padding.
    Returns:
        labels [B,H,W] int32 (255 ignore), max_conf [B,H,W], max_idx [B,H,W].
    """
    b, h, w, c = probs.shape
    probs = probs.to(compute_dtype)
    max_conf, max_idx = probs.max(dim=-1)
    idx_flat = max_idx.reshape(b, -1)
    # per-class peak of the argmax confidence; classes that are nowhere the
    # argmax keep 0, as the one-hot product in the JAX version gives
    peaks = torch.zeros((b, c), dtype=torch.float32, device=probs.device)
    peaks = peaks.scatter_reduce(1, idx_flat, max_conf.reshape(b, -1).float(),
                                 reduce="amax", include_self=True)
    thresholds = peaks * upper
    if discount:
        thresholds = thresholds * threshold_discount(
            running_conf, threshold_beta)[None]
    thresholds = torch.clamp(thresholds, min=lower)  # [B, C]

    tau = thresholds.to(compute_dtype).gather(1, idx_flat).view(b, h, w)
    keep = (max_conf > tau) & (~ignore_augm)
    labels = torch.where(keep, max_idx, IGNORE).to(torch.int32)
    return labels, max_conf, max_idx.to(torch.int32)


# ---------------------------------------------------------------------------
# losses (reference models/sac.py:119-149 and models/deeplabv2.py:222-224)
# ---------------------------------------------------------------------------

CE_IMPLS = ("kernel", "logsoftmax")


def _nll(logits, labels, compute_dtype=torch.float32, impl="kernel"):
    """Per-pixel negative log-likelihood with ignore masking.

    ``impl="kernel"`` computes it with the fused :mod:`dasac_tpu_torch.ops.ce`
    pair (softmax recomputed in backward, no log-softmax residual; f32
    only).  ``impl="logsoftmax"`` is the plain formula, with the log-softmax
    in ``compute_dtype`` (the per-pixel NLL is always returned in f32).

    Returns (nll [B,H,W] zeroed at ignore, valid mask [B,H,W], safe labels
    [B,H,W] int64 with ignore mapped to class 0).
    """
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    if impl == "kernel":
        if compute_dtype != torch.float32:
            raise ValueError(
                "CE_IMPL=kernel computes in f32 only; it cannot honour "
                "LOSS_DTYPE=%s — drop one of the two settings"
                % str(compute_dtype).replace("torch.", ""))
        return nll_fused(logits, labels), valid, safe
    if impl != "logsoftmax":
        raise ValueError("ce impl must be one of %s, got %r"
                         % (CE_IMPLS, impl))
    logp = torch.log_softmax(logits.to(compute_dtype), dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0].float()
    return torch.where(valid, -picked, 0.0), valid, safe


def cross_entropy_mean(logits, labels, compute_dtype=torch.float32,
                       impl="kernel"):
    """Reference source loss: sum of valid per-pixel CE divided by the TOTAL
    pixel count (torch ignore_index zeros + .mean())."""
    nll, _, _ = _nll(logits, labels, compute_dtype, impl=impl)
    return nll.mean()


def focal_ce(logits, pseudo_gt, teacher_conf, running_conf, p=3,
             use_conf=True, compute_dtype=torch.float32, impl="kernel"):
    """Focal-weighted self-supervision CE (focal_ce_conf by default).

    Per-pixel loss = (1 - clamp(prior,0))^p [class] * NLL, optionally
    multiplied by the teacher confidence, then averaged over ALL pixels
    (ignored pixels contribute zero).  Also returns the per-class mean-loss
    diagnostic (reference loss_per_class), detached.
    """
    c = logits.shape[-1]
    focal_w = (1.0 - torch.clamp(running_conf, min=0.0)) ** p  # [C]
    nll, valid, safe = _nll(logits, pseudo_gt, compute_dtype, impl=impl)
    w = focal_w[safe] * valid.float()
    ce = nll * w
    if use_conf:
        # the reference broadcast: loss_ce [B,H,W] * teacher_probs
        # [B,1,H,W] broadcasts to [B,B,H,W] before .mean(), i.e. each
        # pixel's CE is weighted by the BATCH-MEAN confidence at that
        # location.  mean_{i,j,h,w} ce[j]*conf[i] == mean_{h,w}[ mean_j ce *
        # mean_i conf ] — computed in that factored O(BHW) form.
        ce_mean_views = ce.mean(dim=0)
        conf_mean_views = teacher_conf.float().mean(dim=0)
        loss = (ce_mean_views * conf_mean_views).mean()
    else:
        loss = ce.mean()

    # per-class sums, one row of bins per image row: a single [C] row of
    # bins would take every pixel's atomic add on 19 addresses
    ce_d = ce.detach().reshape(-1, ce.shape[-1])
    bins = torch.zeros(ce_d.shape[0], c, dtype=torch.float32, device=ce.device)
    bins.scatter_add_(1, safe.reshape(ce_d.shape), ce_d)
    return loss, bins.sum(dim=0) / ce_d.numel()


def entropy(probs, eps=1e-5):
    """Per-pixel entropy; near-zero-mass pixels get 1/eps
    (reference models/sac.py:189-196)."""
    probs = probs.float()
    probs_eps = (probs + eps) / (1.0 + eps)
    ent = -(probs * torch.log(probs_eps)).sum(dim=-1, keepdim=True)
    mass = probs.sum(dim=-1, keepdim=True)
    return torch.where(mass < 0.1, 1.0 / eps, ent)


# ---------------------------------------------------------------------------
# momentum (EMA) teacher (reference models/sac.py:70-102)
# ---------------------------------------------------------------------------

def ema_update(teacher, student, momentum):
    """teacher <- m*teacher + (1-m)*student over every tensor.

    Updates ``teacher`` (a list of tensors) IN PLACE, unlike the JAX
    version, which returns a new tree.
    """
    torch._foreach_mul_(teacher, momentum)
    torch._foreach_add_(teacher, student, alpha=1.0 - momentum)


def teacher_param_distance(teacher, student):
    """Sum of per-tensor L2 distances (the reference's teacher_diff
    diagnostic), as a 0-d f32 tensor."""
    diffs = torch._foreach_sub([t.float() for t in teacher],
                               [s.float() for s in student])
    return torch.stack(torch._foreach_norm(diffs)).sum()


def maybe_update_teacher(teacher, student, slow_init, running_conf, *,
                         momentum, threshold_beta, do_update):
    """Teacher update, branched on the host.

    The first effective update copies the student wholesale and resets the
    class prior to ``threshold_beta`` (reference lazy init, sac.py:74-81);
    afterwards it EMAs.  ``teacher`` and ``student`` are lists of tensors in
    the same order; ``teacher`` is updated IN PLACE.  ``slow_init`` and
    ``do_update`` are Python values.

    Returns (slow_init, running_conf, diff) where diff is the parameter
    distance diagnostic (0 on the init branch).
    """
    if do_update and not slow_init:
        torch._foreach_copy_(teacher, student)
        rc = torch.full_like(running_conf, threshold_beta)
        return 1, rc, torch.zeros((), device=running_conf.device)
    diff = teacher_param_distance(teacher, student)
    if do_update:
        ema_update(teacher, student, momentum)
    return slow_init, running_conf, diff
