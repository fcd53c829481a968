"""The SAC and ABN augmentation: a frozen copy of ``dasac_tpu_torch``'s
``aug/`` (pipelines, affine, warp, photometric), cut to the
paths the cells run (no batch slicing).  The draws are taken from the
generator in the same order and ranges, so the same generator state gives
the same views on both sides.

Source: scale, horizontal flip and crop as one warp of the loader-size
frame (pre-blurred against aliasing), then normalize and zero the
padding.  Target groups: a shared scale and crop, a group flip, per-view
guided flip and zoom (affine-tracked), blur, colour jitter and grey on
the student's copy, normalize.  Images are float32 RGB in [0, 1]."""

import math
from typing import NamedTuple

import numpy as np
import torch

IGNORE = 255
_GRAY = (0.299, 0.587, 0.114)
_BLUR_TAPS = 13


class TargetViews(NamedTuple):
    frames_aug: torch.Tensor
    labels: torch.Tensor
    frames_clean: torch.Tensor
    affine: torch.Tensor
    affine_inv: torch.Tensor
    padding: torch.Tensor


def uniform(generator, shape, lo=0.0, hi=1.0, device=None):
    return lo + torch.rand(shape, generator=generator, device=device) * (
        hi - lo)


# ---- warps (axis-aligned affines, grid_sample align_corners=False) ----

def _src_coords(theta, out_hw, src_hw):
    oh, ow = out_hw
    h, w = src_hw
    theta = theta.float()
    dev = theta.device
    f32 = torch.float32
    xs = (2.0 * torch.arange(ow, dtype=f32, device=dev) + 1.0) / ow - 1.0
    ys = (2.0 * torch.arange(oh, dtype=f32, device=dev) + 1.0) / oh - 1.0
    sx = theta[:, 0, 0, None] * xs[None] + theta[:, 0, 2, None]
    sy = theta[:, 1, 1, None] * ys[None] + theta[:, 1, 2, None]
    return ((sy + 1.0) * h - 1.0) / 2.0, ((sx + 1.0) * w - 1.0) / 2.0


def _expand(a, ndim, axis):
    shape = [a.shape[0]] + [1] * (ndim - 1)
    shape[axis] = a.shape[1]
    return a.reshape(shape)


def _take(data, idx, axis):
    return torch.take_along_dim(data, _expand(idx, data.ndim, axis), dim=axis)


def warp_affine(img, theta, out_hw=None, mode="bilinear"):
    """``grid_sample(img, affine_grid(theta))`` for axis-aligned ``theta``
    on NHWC ``img``: zero padding, bilinear (in f32) or nearest (round half
    to even); ``img``'s dtype."""
    n, h, w, c = img.shape
    oh, ow = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    sy, sx = _src_coords(theta, (oh, ow), (h, w))

    def gather(data, src, axis, size):
        if mode == "nearest":
            i = torch.round(src).long()
            ok = (i >= 0) & (i < size)
            return (_take(data, i.clamp(0, size - 1), axis)
                    * _expand(ok, data.ndim, axis).to(data.dtype))
        i0f = torch.floor(src)
        frac = src - i0f
        i0 = i0f.long()
        ok0 = (i0 >= 0) & (i0 < size)
        ok1 = (i0 + 1 >= 0) & (i0 + 1 < size)
        g0 = _take(data, i0.clamp(0, size - 1), axis)
        g1 = _take(data, (i0 + 1).clamp(0, size - 1), axis)
        out = (g0.float() * _expand((1.0 - frac) * ok0, data.ndim, axis)
               + g1.float() * _expand(frac * ok1, data.ndim, axis))
        return out.to(data.dtype)

    return gather(gather(img, sy, 1, h), sx, 2, w)


def valid_mask(theta, out_hw, src_hw):
    h, w = int(src_hw[0]), int(src_hw[1])
    sy, sx = _src_coords(theta, (int(out_hw[0]), int(out_hw[1])), (h, w))

    def inb(src, size):
        i = torch.round(src).long()
        return (i >= 0) & (i < size)

    return inb(sy, h)[:, :, None] & inb(sx, w)[:, None, :]


# ---- affine bookkeeping ----

def pixel_theta(a_y, b_y, a_x, b_x, dst_hw, src_hw=None):
    """Per-axis pixel map ``src = a * dst + b`` -> normalized 2x3 theta."""
    dh, dw = dst_hw
    sh, sw = src_hw if src_hw is not None else dst_hw

    def axis(a, b, d, s):
        return a * d / s, (a * d - a + 2.0 * b + 1.0) / s - 1.0

    cx, ox = axis(a_x, b_x, dw, sw)
    cy, oy = axis(a_y, b_y, dh, sh)
    z = torch.zeros_like(cx)
    return torch.stack([torch.stack([cx, z, ox], -1),
                        torch.stack([z, cy, oy], -1)], -2)


def flip_theta(flip):
    z, o = torch.zeros_like(flip), torch.ones_like(flip)
    return torch.stack([torch.stack([flip, z, z], -1),
                        torch.stack([z, o, z], -1)], -2)


def compose(a, b):
    """``a(b(x))`` of two [..., 2, 3] affines."""
    lin = a[..., :2] @ b[..., :2]
    t = (a[..., :2] @ b[..., 2][..., None])[..., 0] + a[..., 2]
    return torch.cat([lin, t[..., None]], dim=-1)


def build_affine(params, hw):
    """``params`` [T, 5] (dy, dx, alpha, scale, flip) -> view affines."""
    dy, dx, alpha, scale, flip = params.float().unbind(dim=1)
    ch, cw = float(hw[0]), float(hw[1])
    aspect = ch / cw
    rad = alpha * math.pi / 180.0
    sin, cos = torch.sin(rad), torch.cos(rad)
    t0 = -(cos * dx + sin * dy) / float(int(cw) // 2)
    t1 = -(-sin * dx + cos * dy) / float(int(ch) // 2)
    a = torch.stack([torch.stack([flip * cos, sin * aspect, t0], -1),
                     torch.stack([-sin / aspect, cos, t1], -1)], dim=1)
    return a * scale[:, None, None]


def build_affine_inv(a, params, hw):
    scale = params.float()[:, 3]
    aspect = float(hw[0]) / float(hw[1])
    i00, i11 = a[:, 0, 0], a[:, 1, 1]
    i01 = a[:, 1, 0] * aspect ** 2
    i10 = a[:, 0, 1] / aspect ** 2
    i02 = -(i00 * a[:, 0, 2] + i01 * a[:, 1, 2])
    i12 = -(i10 * a[:, 0, 2] + i11 * a[:, 1, 2])
    inv = torch.stack([torch.stack([i00, i01, i02], -1),
                       torch.stack([i10, i11, i12], -1)], dim=1)
    return inv / (scale ** 2)[:, None, None]


# ---- photometric ----

def _gray(img):
    return img @ torch.tensor(_GRAY, dtype=img.dtype, device=img.device)


def _blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def _contrast(img, f, valid):
    gray = _gray(img)
    v = valid.to(img.dtype)
    n = torch.clamp(v.sum(dim=(-2, -1), keepdim=True), min=1.0)
    mean = ((gray * v).sum(dim=(-2, -1), keepdim=True) / n)[..., None]
    return _blend(img, mean.expand(img.shape), f)


def _rgb_to_hsv(img):
    r, g, b = img.unbind(dim=-1)
    maxc, minc = img.amax(dim=-1), img.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    return torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0), s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _hue(img, delta):
    h, s, v = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    return torch.clamp(_hsv_to_rgb(torch.remainder(h + delta, 1.0), s, v),
                       0.0, 1.0)


def jitter_draws(generator, b, strength, device):
    hue_s = min(0.1, strength)
    return dict(apply_u=uniform(generator, (b,), device=device),
                factors=uniform(generator, (b, 3), max(0.0, 1.0 - strength),
                                1.0 + strength, device=device),
                hues=uniform(generator, (b,), -hue_s, hue_s, device=device),
                order_u=uniform(generator, (b, 4), device=device))


def color_jitter(d, img, valid=None, p=0.5):
    """torchvision ColorJitter, per image factors and op order."""
    fac = d["factors"][:, :, None, None, None]
    hue = d["hues"][:, None, None]
    order = torch.argsort(d["order_u"], dim=-1)
    if valid is None:
        valid = torch.ones(img.shape[:3], dtype=torch.bool, device=img.device)
    ops = (lambda z: torch.clamp(z * fac[:, 0], 0.0, 1.0),
           lambda z: _contrast(z, fac[:, 1], valid),
           lambda z: _blend(z, _gray(z)[..., None].expand(z.shape), fac[:, 2]),
           lambda z: _hue(z, hue))
    x = img
    for pos in range(4):
        out = x
        for k, op in enumerate(ops):
            out = torch.where((order[:, pos] == k)[:, None, None, None],
                              op(x), out)
        x = out
    return torch.where((d["apply_u"] < p)[:, None, None, None], x, img)


def gaussian_blur(img, sigma, valid=None):
    """Per-image ``sigma`` blur, two passes of 13 shifted adds, edge
    padding; with ``valid`` renormalized over real pixels."""
    half = _BLUR_TAPS // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=img.device)
    w = torch.exp(-0.5 * (offs[None, :] / torch.clamp(
        sigma.float()[:, None], min=1e-3)) ** 2)
    w = w / w.sum(dim=1, keepdim=True)

    def pass_axis(x, axis):
        size = x.shape[axis]
        idx = torch.arange(-half, size + half, device=x.device)
        xp = x.index_select(axis, idx.clamp(0, size - 1))
        out = torch.zeros_like(x)
        for i in range(_BLUR_TAPS):
            out = out + xp.narrow(axis, i, size) * w[:, i].view(-1, 1, 1, 1)
        return out

    x = img.float()
    if valid is not None:
        v = valid.float()[..., None]
        x = torch.cat([x * v, v], dim=-1)
    out = pass_axis(pass_axis(x, 1), 2)
    if valid is not None:
        out = out[..., :-1] / torch.clamp(out[..., -1:], min=1e-6)
        out = torch.where(valid[..., None], out, img.float())
    return out.to(img.dtype)


def normalize(img, mean, std):
    mean = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img.float() - mean) / std


def _flip_sign(enabled, u):
    return torch.where((u > 0.5) & enabled, -1.0, 1.0)


def _warp_views(images, labels, theta, out_hw):
    imgs = warp_affine(images, theta, out_hw)
    lbl = warp_affine(labels[..., None].float(), theta, out_hw,
                      mode="nearest")[..., 0]
    valid = valid_mask(theta, out_hw, labels.shape[1:3])
    return imgs, torch.where(valid, lbl.to(torch.int32),
                             IGNORE).to(torch.int32), valid


# ---- pipelines ----

def source_batch(generator, images, labels, *, crop_hw, scale_range, hflip,
                 jitter, blur, mean, std):
    """uint8 [B, H0, W0, 3] frames -> (normalized crops, int32 labels)."""
    b, h0, w0, _ = images.shape
    dev = images.device
    sigma = uniform(generator, (b,), *scale_range, device=dev)
    u_y = uniform(generator, (b,), device=dev)
    u_x = uniform(generator, (b,), device=dev)
    u_flip = uniform(generator, (b,), device=dev)
    blur_s = uniform(generator, (b,), 0.1, 2.0, device=dev) if blur else None
    jit = jitter_draws(generator, b, jitter, dev) if jitter > 0 else None
    ch, cw = crop_hw

    def off_pad(scaled, crop, u):
        return (u * torch.clamp(scaled - crop, min=0.0),
                torch.floor(torch.clamp(crop - scaled, min=0.0) / 2.0))

    off_y, pad_y = off_pad(sigma * h0, ch, u_y)
    off_x, pad_x = off_pad(sigma * w0, cw, u_x)
    theta = pixel_theta(1.0 / sigma, (off_y - pad_y) / sigma, 1.0 / sigma,
                        (off_x - pad_x) / sigma, (ch, cw), (h0, w0))
    theta = compose(theta, flip_theta(_flip_sign(hflip, u_flip)))
    imgs = images.float() / 255.0
    aa = 0.5 * torch.sqrt(torch.clamp(1.0 / sigma ** 2 - 1.0, min=0.0))
    imgs = gaussian_blur(imgs, aa)
    frames, lbl, valid = _warp_views(imgs, labels.to(torch.int32), theta,
                                     (ch, cw))
    if blur:
        frames = gaussian_blur(frames, blur_s, valid=valid)
    if jit is not None:
        frames = color_jitter(jit, frames, valid=valid)
    return normalize(frames, mean, std) * valid[..., None].float(), lbl


def target_groups(generator, images, labels, *, group_size, target_scale,
                  zoom, group_hflip, guided_hflip, blur, jitter, greyscale,
                  mean, std):
    """uint8 [G, H, W, 3] crop-size frames -> the G*T views."""
    g, h, w, _ = images.shape
    t = group_size
    dev = images.device

    def u(shape, lo=0.0, hi=1.0):
        return uniform(generator, shape, lo, hi, device=dev)

    sigma = u((g,), *target_scale)
    u_oy, u_ox, u_gflip = u((g,)), u((g,)), u((g,))
    u_vflip, s, u_y, u_x = u((g, t)), u((g, t), *zoom), u((g, t)), u((g, t))
    n = g * t
    blur_s = u((n,), 0.1, 2.0) if blur else None
    jit = jitter_draws(generator, n, jitter, dev) if jitter > 0 else None
    grey_u = u((n,)) if greyscale > 0 else None

    theta_sc = pixel_theta(1.0 / sigma, u_oy * (sigma * h - h) / sigma,
                           1.0 / sigma, u_ox * (sigma * w - w) / sigma, (h, w))
    theta_shared = compose(theta_sc,
                           flip_theta(_flip_sign(group_hflip, u_gflip)))
    vflip = _flip_sign(guided_hflip, u_vflip)
    s = s.clone()
    s[:, 0] = 1.0
    dy = u_y * (h - s * h) + s * h / 2.0 - h / 2.0
    dx = u_x * (w - s * w) + s * w / 2.0 - w / 2.0
    params = torch.stack([dy, dx, torch.zeros_like(dy), 1.0 / s, vflip],
                         -1).reshape(n, 5)
    affine = build_affine(params, (h, w))
    affine_inv = build_affine_inv(affine, params, (h, w))
    theta = compose(theta_shared.repeat_interleave(t, dim=0), affine_inv)
    imgs_v, labels_v, valid = _warp_views(
        (images.float() / 255.0).repeat_interleave(t, dim=0),
        labels.to(torch.int32).repeat_interleave(t, dim=0), theta, (h, w))
    aug = imgs_v
    if blur:
        aug = gaussian_blur(aug, blur_s)
    if jit is not None:
        aug = color_jitter(jit, aug)
    if grey_u is not None:
        aug = torch.where((grey_u < greyscale)[:, None, None, None],
                          _gray(aug)[..., None].expand(aug.shape), aug)
    vm = valid[..., None].float()
    return TargetViews(normalize(aug, mean, std) * vm, labels_v,
                       normalize(imgs_v, mean, std) * vm, affine, affine_inv,
                       ~valid)


def renorm_stats(mean, std, source_mean, source_std, target_mean,
                 target_std):
    """The source renormalisation to the target's statistics."""
    mean, std = np.asarray(mean), np.asarray(std)
    m_s, s_s = np.asarray(source_mean), np.asarray(source_std)
    m_t, s_t = np.asarray(target_mean), np.asarray(target_std)
    return (tuple((m_s - s_s / s_t * (m_t - mean)).tolist()),
            tuple((s_s * std / s_t).tolist()))
