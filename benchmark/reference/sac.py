"""The SAC core and the multi-view refine: a frozen copy of
``dasac_tpu_torch``'s ``sac/core.py`` and ``sac/refine.py``, cut
to the paths the cells run (average pool over views, the refine at the
teacher's stride-8 grid, the plain log-softmax CE, one process)."""

import torch

from benchmark.reference.aug import warp_affine
from benchmark.reference.layers import resize_align_corners

IGNORE = 255


def update_running_conf(running_conf, probs, momentum, beta, tol=1e-8):
    """EMA of the batch-mean class probability; classes still at their
    initial value ``beta`` adopt the batch mean."""
    avg = probs.reshape(-1, probs.shape[-1]).float().mean(dim=0)
    new = (avg > tol) & (running_conf == beta)
    return torch.where(new, avg,
                       momentum * running_conf + (1.0 - momentum) * avg)


def pseudo_labels(probs, padding, running_conf, *, upper, lower, beta,
                  discount=True, dtype=torch.float32):
    """Per image and class, the threshold ``clamp(upper * peak *
    (1 - exp(-prior / beta)), min=lower)`` from the peak confidence where
    the class is the argmax; a pixel keeps its argmax iff its confidence
    exceeds its class's threshold.  Returns (labels, confidence)."""
    b, h, w, c = probs.shape
    probs = probs.to(dtype)
    conf, idx = probs.max(dim=-1)
    flat = idx.reshape(b, -1)
    peaks = torch.zeros((b, c), dtype=torch.float32, device=probs.device)
    peaks = peaks.scatter_reduce(1, flat, conf.reshape(b, -1).float(),
                                 reduce="amax", include_self=True)
    th = peaks * upper
    if discount:
        th = th * (1.0 - torch.exp(-running_conf / beta))[None]
    th = torch.clamp(th, min=lower)
    tau = th.to(dtype).gather(1, flat).view(b, h, w)
    keep = (conf > tau) & (~padding)
    return torch.where(keep, idx, IGNORE).to(torch.int32), conf


def nll(logits, labels):
    """Per-pixel CE (plain log-softmax, f32) zeroed at ignored pixels;
    also the valid mask and the labels with ignore mapped to 0."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, -picked, 0.0), valid, safe


def cross_entropy_mean(logits, labels):
    """Valid pixels' CE summed over ALL pixels' count."""
    return nll(logits, labels)[0].mean()


def focal_ce(logits, pseudo, conf, running_conf, p=3, use_conf=True):
    """``(1 - prior)^p`` -weighted CE on the pseudo-labels, each pixel
    weighted by the batch-mean teacher confidence there."""
    ce, valid, safe = nll(logits, pseudo)
    ce = ce * ((1.0 - torch.clamp(running_conf, min=0.0)) ** p)[safe] \
        * valid.float()
    if use_conf:
        return (ce.mean(dim=0) * conf.float().mean(dim=0)).mean()
    return ce.mean()


def update_teacher(teacher, student, slow_init, running_conf, *, momentum,
                   beta, do_update):
    """The lazy init (a copy of the student, the prior reset to ``beta``)
    on the first update, the EMA afterwards; ``teacher`` in place.
    Returns (slow_init, running_conf)."""
    with torch.no_grad():
        if do_update and not slow_init:
            torch._foreach_copy_(teacher, student)
            return 1, torch.full_like(running_conf, beta)
        if do_update:
            torch._foreach_mul_(teacher, momentum)
            torch._foreach_add_(teacher, student, alpha=1.0 - momentum)
    return slow_init, running_conf


def _pool_views(probs_m, affine, affine_inv, group_size, tol=0.1):
    """Warp each view's masked probabilities to the group's frame,
    average over the group's views where the mass exceeds ``tol``, warp
    the average back into each view."""
    b, h, w, c = probs_m.shape
    aligned = warp_affine(probs_m, affine)
    ones = torch.ones((b, h, w, 1), dtype=probs_m.dtype,
                      device=probs_m.device)
    masked = (aligned * warp_affine(ones, affine_inv)).reshape(
        b // group_size, group_size, h, w, c)
    total = masked.sum(dim=1, keepdim=True)
    mass = total.sum(dim=-1, keepdim=True)
    valid = (mass > tol).to(masked.dtype)
    pooled = (total / torch.clamp(mass, min=1e-3)).expand(masked.shape)
    valid = valid.expand(masked.shape[:-1] + (1,))
    return (warp_affine(pooled.reshape(b, h, w, c), affine_inv)
            * warp_affine(valid.reshape(b, h, w, 1), affine_inv))


def refine_stride8(logits, affine, affine_inv, padding, group_size,
                   dtype=None):
    """The refine at the teacher's stride-8 grid: softmax, the padding
    sampled onto the grid at the positions the final upsample reads,
    pooled over views, upsampled once.  ``dtype`` None: float32.
    Returns (refined [B, H, W, C], stride-8 probabilities)."""
    h8, w8 = logits.shape[1:3]
    h, w = padding.shape[1:3]
    rdt = torch.float32 if dtype is None else dtype
    probs = torch.softmax(logits if dtype is None else logits.to(dtype),
                          dim=-1)
    dev = logits.device
    yi = torch.round(torch.linspace(0.0, h - 1.0, h8, device=dev)).long()
    xi = torch.round(torch.linspace(0.0, w - 1.0, w8, device=dev)).long()
    mask8 = padding[:, yi[:, None], xi[None, :]]
    probs_m = probs * (1.0 - mask8[..., None].to(probs.dtype))
    refined = _pool_views(probs_m, affine, affine_inv, group_size)
    return resize_align_corners(refined, (h, w), dtype=rdt), probs
