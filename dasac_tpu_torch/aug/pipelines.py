"""Fused on-device augmentation pipelines (counterpart of
``dasac_tpu/aug/pipelines.py``).

Source chain: RandScale -> [Blur] -> HFlip -> [Jitter] -> RandCrop(pad) ->
Normalize -> ApplyMask(255).  Target chain: shared RandScale+RandCrop ->
group HFlip -> per-view GuidedHFlip -> per-view RandScaleCrop
(affine-tracked) -> photometric on the student copy -> Normalize ->
ApplyMask.  Every geometric step is a similarity transform, so each view is
ONE bilinear warp of the base image (labels: nearest).

Each pipeline is split into ``sample_*_draws(generator, ...)`` (every
random number it uses, in the order and ranges of the JAX version) and a
deterministic ``apply_*(draws, ...)``.
"""

from typing import NamedTuple

import numpy as np
import torch

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.aug.affine import build_affine, build_affine_inv, compose
from dasac_tpu_torch.aug.warp import valid_mask_affine, warp_affine

IGNORE = 255


def _pixel_affine_to_theta(a_y, b_y, a_x, b_x, dst_hw, src_hw=None):
    """Per-axis pixel map src_px = a*dst_px + b  ->  normalized 2x3 theta
    (align_corners=False convention; handles differing src/dst sizes)."""
    dh, dw = dst_hw
    sh, sw = src_hw if src_hw is not None else dst_hw

    def axis(a, b, d, s):
        return a * d / s, (a * d - a + 2.0 * b + 1.0) / s - 1.0

    coef_x, off_x = axis(a_x, b_x, dw, sw)
    coef_y, off_y = axis(a_y, b_y, dh, sh)
    zeros = torch.zeros_like(coef_x)
    row0 = torch.stack([coef_x, zeros, off_x], -1)
    row1 = torch.stack([zeros, coef_y, off_y], -1)
    return torch.stack([row0, row1], -2)


def _flip_theta(flip):
    """Horizontal mirror in normalized coords (exact for align_corners=False)."""
    zeros = torch.zeros_like(flip)
    ones = torch.ones_like(flip)
    row0 = torch.stack([flip, zeros, zeros], -1)
    row1 = torch.stack([zeros, ones, zeros], -1)
    return torch.stack([row0, row1], -2)


def _warp_views(images, labels, theta, out_hw):
    """Warp base images/labels [N,...] by theta [N,2,3]; returns imgs,
    labels (int32, 255 outside), valid."""
    imgs = warp_affine(images, theta, out_hw=out_hw)
    lbl = labels[..., None].float()
    lbl_w = warp_affine(lbl, theta, out_hw=out_hw, mode="nearest")[..., 0]
    valid = valid_mask_affine(theta, out_hw, labels.shape[1:3])
    labels = torch.where(valid, lbl_w.to(torch.int32), IGNORE).to(torch.int32)
    return imgs, labels, valid


def _flip_sign(enabled, u):
    return torch.where((u > 0.5) & enabled, -1.0, 1.0)


class TargetViews(NamedTuple):
    frames_aug: torch.Tensor    # [G*T, H, W, 3] normalized, padding zeroed
    labels: torch.Tensor        # [G*T, H, W] int32, 255 at ignore+padding
    frames_clean: torch.Tensor  # [G*T, H, W, 3] normalized (teacher input)
    affine: torch.Tensor        # [G*T, 2, 3] view -> reference
    affine_inv: torch.Tensor    # [G*T, 2, 3] reference -> view
    padding: torch.Tensor       # [G*T, H, W] bool, True at augmentation padding


# ---------------------------------------------------------------------------
# target groups
# ---------------------------------------------------------------------------

def sample_target_draws(generator, g, t, *, target_scale=(1.0, 1.1),
                        zoom=(0.5, 1.2), blur=True, jitter=0.4,
                        greyscale=0.2, device=None):
    """Every random number of ``augment_target_groups`` (pipelines.py:101-126
    and the photometric draws): per group ``sigma``, ``u_off_y``,
    ``u_off_x``, ``u_gflip`` [G]; per view ``u_vflip``, ``zoom`` (view 0 is
    overwritten with 1 in the apply step), ``u_y``, ``u_x`` [G,T]; then the
    ``blur``, ``jitter`` and ``grey`` draws over the G*T views where
    enabled."""
    def u(shape, lo=0.0, hi=1.0):
        return P._uniform(generator, shape, lo, hi, device=device)

    d = dict(sigma=u((g,), *target_scale), u_off_y=u((g,)), u_off_x=u((g,)),
             u_gflip=u((g,)), u_vflip=u((g, t)), zoom=u((g, t), *zoom),
             u_y=u((g, t)), u_x=u((g, t)))
    b = g * t
    if blur:
        d["blur"] = P.sample_blur_draws(generator, b, device=device)
    if jitter > 0:
        d["jitter"] = P.sample_jitter_draws(generator, b, jitter,
                                            min(0.1, jitter), device=device)
    if greyscale > 0:
        d["grey"] = P.sample_grayscale_draws(generator, b, device=device)
    return d


def apply_target_groups(draws, images, labels, *, group_size,
                        group_hflip=True, guided_hflip=True, blur=True,
                        jitter=0.4, greyscale=0.2,
                        mean=(0.485, 0.456, 0.406),
                        std=(0.229, 0.224, 0.225)):
    """Expand [G, H, W, ...] uint8 crop-size inputs into augmented groups.

    Args:
        draws: from :func:`sample_target_draws`.
        images: [G, H, W, 3] uint8 (already at CROP_SIZE).
        labels: [G, H, W] uint8/int trainIds (255 ignore).
    Returns a TargetViews with leading dim G*T (views of group g contiguous).
    """
    g, h, w, _ = images.shape
    t = group_size

    # --- shared scale + crop (one per group) --------------------------------
    sigma = draws["sigma"]
    off_y = draws["u_off_y"] * (sigma * h - h)
    off_x = draws["u_off_x"] * (sigma * w - w)
    theta_sc = _pixel_affine_to_theta(
        1.0 / sigma, off_y / sigma, 1.0 / sigma, off_x / sigma, (h, w))
    gflip = _flip_sign(group_hflip, draws["u_gflip"])
    theta_shared = compose(theta_sc, _flip_theta(gflip))  # crop then flip

    # --- per-view tracked params (guided flip + zoom) -----------------------
    vflip = _flip_sign(guided_hflip, draws["u_vflip"])
    s = draws["zoom"].clone()
    s[:, 0] = 1.0   # view 0 keeps the reference frame (tf_target.py:195-196)
    # crop (s<1): offsets in [0, d-s*d]; pad (s>1): in [d-s*d, 0]
    ii = draws["u_y"] * (h - s * h)
    jj = draws["u_x"] * (w - s * w)
    dy = ii + s * h / 2.0 - h / 2.0
    dx = jj + s * w / 2.0 - w / 2.0
    params = torch.stack([dy, dx, torch.zeros_like(dy), 1.0 / s, vflip], -1)
    params_flat = params.reshape(g * t, 5)
    affine = build_affine(params_flat, (h, w))
    affine_inv = build_affine_inv(affine, params_flat, (h, w))

    # full warp: base -> shared frame -> view
    theta_full = compose(theta_shared.repeat_interleave(t, dim=0), affine_inv)

    imgs_f = images.float() / 255.0
    imgs_v, labels_v, valid_v = _warp_views(
        imgs_f.repeat_interleave(t, dim=0),
        labels.to(torch.int32).repeat_interleave(t, dim=0),
        theta_full, (h, w))

    # --- photometric on the student copy ------------------------------------
    aug = imgs_v
    if blur:
        aug = P.gaussian_blur_sigma(aug, draws["blur"]["sigma"])
    if jitter > 0:
        aug = P.apply_color_jitter(draws["jitter"], aug, p=0.5)
    if greyscale > 0:
        aug = P.apply_random_grayscale(draws["grey"], aug, greyscale)

    vm = valid_v[..., None].float()
    frames_aug = P.normalize(aug, mean, std) * vm
    frames_clean = P.normalize(imgs_v, mean, std) * vm
    return TargetViews(frames_aug, labels_v, frames_clean,
                       affine, affine_inv, ~valid_v)


def augment_target_groups(generator, images, labels, *, group_size,
                          target_scale=(1.0, 1.1), zoom=(0.5, 1.2),
                          group_hflip=True, guided_hflip=True,
                          blur=True, jitter=0.4, greyscale=0.2,
                          mean=(0.485, 0.456, 0.406),
                          std=(0.229, 0.224, 0.225)):
    """Draw from ``generator``, then :func:`apply_target_groups`."""
    draws = sample_target_draws(
        generator, images.shape[0], group_size, target_scale=target_scale,
        zoom=zoom, blur=blur, jitter=jitter, greyscale=greyscale,
        device=images.device)
    return apply_target_groups(
        draws, images, labels, group_size=group_size,
        group_hflip=group_hflip, guided_hflip=guided_hflip, blur=blur,
        jitter=jitter, greyscale=greyscale, mean=mean, std=std)


# ---------------------------------------------------------------------------
# source batch
# ---------------------------------------------------------------------------

def sample_source_draws(generator, b, *, scale_range=(0.5, 1.5),
                        jitter=0.0, blur=False, device=None):
    """Every random number of ``augment_source_batch``
    (pipelines.py:190-205): ``sigma``, ``u_y``, ``u_x``, ``u_flip`` [B],
    then the ``blur`` and ``jitter`` draws where enabled."""
    def u(shape, lo=0.0, hi=1.0):
        return P._uniform(generator, shape, lo, hi, device=device)

    d = dict(sigma=u((b,), *scale_range), u_y=u((b,)), u_x=u((b,)),
             u_flip=u((b,)))
    if blur:
        d["blur"] = P.sample_blur_draws(generator, b, device=device)
    if jitter > 0:
        d["jitter"] = P.sample_jitter_draws(generator, b, jitter,
                                            min(0.1, jitter), device=device)
    return d


def apply_source_batch(draws, images, labels, *, crop_hw, hflip=True,
                       jitter=0.0, blur=False,
                       mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225)):
    """Source augmentation: scale/flip/crop as one warp + photometric.

    Args:
        images: [B, H0, W0, 3] uint8 full-resolution source frames.
        labels: [B, H0, W0] trainIds.
        crop_hw: output (H, W).
    Returns (frames [B,H,W,3] normalized with padding zeroed,
             labels [B,H,W] int32 with 255 at ignore+padding).
    """
    b, h0, w0, _ = images.shape
    ch, cw = crop_hw
    sigma = draws["sigma"]
    sh, sw = sigma * h0, sigma * w0

    def off_pad(scaled, crop, u):
        off = u * torch.clamp(scaled - crop, min=0.0)
        pad = torch.floor(torch.clamp(crop - scaled, min=0.0) / 2.0)
        return off, pad

    off_y, pad_y = off_pad(sh, ch, draws["u_y"])
    off_x, pad_x = off_pad(sw, cw, draws["u_x"])
    flip = _flip_sign(hflip, draws["u_flip"])

    theta = _pixel_affine_to_theta(
        1.0 / sigma, (off_y - pad_y) / sigma,
        1.0 / sigma, (off_x - pad_x) / sigma, (ch, cw), (h0, w0))
    # reference order: scale -> flip -> crop, re-parameterized as a flip
    # after the crop with a mirrored (still uniform) offset
    theta = compose(theta, _flip_theta(flip))

    imgs_f = images.float() / 255.0
    # anti-alias pre-blur for downscale warps (PIL's area-weighted resize
    # has an implicit low-pass; point-sampled gathers do not)
    aa_sigma = 0.5 * torch.sqrt(torch.clamp(1.0 / sigma ** 2 - 1.0, min=0.0))
    imgs_f = P.gaussian_blur_sigma(imgs_f, aa_sigma)

    frames, labels_o, valid = _warp_views(
        imgs_f, labels.to(torch.int32), theta, (ch, cw))

    # mask-aware photometric: the reference blurs/jitters before RandCrop
    # pads, so its ops never see padding
    if blur:
        frames = P.gaussian_blur_sigma(frames, draws["blur"]["sigma"],
                                       valid=valid)
    if jitter > 0:
        frames = P.apply_color_jitter(draws["jitter"], frames, p=0.5,
                                      valid=valid)

    vm = valid[..., None].float()
    return P.normalize(frames, mean, std) * vm, labels_o


def augment_source_batch(generator, images, labels, *, crop_hw,
                         scale_range=(0.5, 1.5), hflip=True,
                         jitter=0.0, blur=False,
                         mean=(0.485, 0.456, 0.406),
                         std=(0.229, 0.224, 0.225)):
    """Draw from ``generator``, then :func:`apply_source_batch`."""
    draws = sample_source_draws(generator, images.shape[0],
                                scale_range=scale_range, jitter=jitter,
                                blur=blur, device=images.device)
    return apply_source_batch(draws, images, labels, crop_hw=crop_hw,
                              hflip=hflip, jitter=jitter, blur=blur,
                              mean=mean, std=std)


def renorm_stats(mean, std, source_mean, source_std, target_mean, target_std):
    """Source-renormalisation statistics (reference dataloader_seg.py:96-107):
    mean' = mu_src - sigma_src/sigma_tgt * (mu_tgt - mean),
    std'  = sigma_src * std / sigma_tgt.  Numpy on the host."""
    mean = np.asarray(mean)
    std = np.asarray(std)
    m_src, s_src = np.asarray(source_mean), np.asarray(source_std)
    m_tgt, s_tgt = np.asarray(target_mean), np.asarray(target_std)
    new_mean = m_src - s_src / s_tgt * (m_tgt - mean)
    new_std = s_src * std / s_tgt
    return tuple(new_mean.tolist()), tuple(new_std.tolist())
