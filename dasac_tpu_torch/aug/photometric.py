"""Device-side photometric augmentations (counterpart of
``dasac_tpu/aug/photometric.py``).

Each random op is split into a draw (``sample_*``: the random numbers, from
a ``torch.Generator``) and a deterministic application (``apply_*``) that
takes the draws, so a test can feed the port the numbers ``jax.random``
drew.  Images are float32 RGB in [0, 1], layout [B, H, W, 3].
"""

import torch

_GRAY = (0.299, 0.587, 0.114)
# (values, dtype, device) -> the tensor, copied there once: a copy from the
# host's memory waits until the device has run all it was given
_CONSTANTS = {}


def _uniform(generator, shape, lo=0.0, hi=1.0, device=None):
    u = torch.rand(shape, generator=generator, device=device)
    return lo + u * (hi - lo)


def _constant(values, dtype, device):
    key = (tuple(float(v) for v in values), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype,
                                           device=device)
    return t


def _gray(img):
    return img @ _constant(_GRAY, img.dtype, img.device)


def _grayscale(img):
    return _gray(img)[..., None].expand(img.shape)


def _blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def adjust_brightness(img, f):
    """``f`` broadcastable against ``img`` ([B,1,1,1] for a batch)."""
    return torch.clamp(img * f, 0.0, 1.0)


def adjust_contrast(img, f, valid=None):
    """torchvision: blend with the mean of the grayscale image; ``valid``
    [B, H, W] restricts the mean to real pixels (excludes warp padding)."""
    gray = _gray(img)
    if valid is None:
        mean = gray.mean(dim=(-2, -1), keepdim=True)[..., None]
    else:
        v = valid.to(img.dtype)
        mean = ((gray * v).sum(dim=(-2, -1), keepdim=True)
                / torch.clamp(v.sum(dim=(-2, -1), keepdim=True), min=1.0)
                )[..., None]
    return _blend(img, mean.expand(img.shape), f)


def adjust_saturation(img, f):
    return _blend(img, _grayscale(img), f)


def _rgb_to_hsv(img):
    r, g, b = img.unbind(dim=-1)
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img, delta):
    """``delta`` broadcastable against the [B, H, W] hue plane."""
    h, s, v = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    return torch.clamp(_hsv_to_rgb(torch.remainder(h + delta, 1.0), s, v),
                       0.0, 1.0)


# ---------------------------------------------------------------------------
# color jitter
# ---------------------------------------------------------------------------

def sample_jitter_draws(generator, b, strength, hue_strength, device=None):
    """The draws of ``dasac_tpu`` ``color_jitter`` (photometric.py:103-111):
    ``apply_u`` [B], ``factors`` [B,3] in [max(0,1-s), 1+s], ``hues`` [B] in
    [-hue_s, hue_s], ``order_u`` [B,4] (argsorted into the op order)."""
    return dict(
        apply_u=_uniform(generator, (b,), device=device),
        factors=_uniform(generator, (b, 3), max(0.0, 1.0 - strength),
                         1.0 + strength, device=device),
        hues=_uniform(generator, (b,), -hue_strength, hue_strength,
                      device=device),
        order_u=_uniform(generator, (b, 4), device=device))


def apply_color_jitter(draws, img, p=0.5, valid=None):
    """torchvision ColorJitter on a batch: per-image factors, per-image
    op order, applied where ``apply_u < p``.

    The op order differs per image, so each of the 4 positions computes all
    4 ops for the whole batch and keeps, per image, the one its order names
    (what the JAX version's vmapped switch does).
    """
    fac = draws["factors"][:, :, None, None, None]           # [B,3,1,1,1]
    hue = draws["hues"][:, None, None]
    order = torch.argsort(draws["order_u"], dim=-1)          # [B,4]
    if valid is None:
        valid = torch.ones(img.shape[:3], dtype=torch.bool, device=img.device)
    ops = (
        lambda z: adjust_brightness(z, fac[:, 0]),
        lambda z: adjust_contrast(z, fac[:, 1], valid),
        lambda z: adjust_saturation(z, fac[:, 2]),
        lambda z: adjust_hue(z, hue),
    )
    x = img
    for pos in range(4):
        out = x
        for k, op in enumerate(ops):
            pick = (order[:, pos] == k)[:, None, None, None]
            out = torch.where(pick, op(x), out)
        x = out
    apply = (draws["apply_u"] < p)[:, None, None, None]
    return torch.where(apply, x, img)


# ---------------------------------------------------------------------------
# random grayscale
# ---------------------------------------------------------------------------

def sample_grayscale_draws(generator, b, device=None):
    """``apply_u`` [B] (photometric.py:137)."""
    return dict(apply_u=_uniform(generator, (b,), device=device))


def apply_random_grayscale(draws, img, p):
    apply = (draws["apply_u"] < p)[:, None, None, None]
    return torch.where(apply, _grayscale(img), img)


# ---------------------------------------------------------------------------
# gaussian blur
# ---------------------------------------------------------------------------

# radius <= 2 in the reference -> 3-sigma support of 6 px
_BLUR_TAPS = 13  # center +- 6


def sample_blur_draws(generator, b, radius_range=(0.1, 2.0), device=None):
    """Per-image sigma ~ U[radius_range] (photometric.py:149: PIL
    GaussianBlur with radius ~ U[0.1, 2])."""
    return dict(sigma=_uniform(generator, (b,), radius_range[0],
                               radius_range[1], device=device))


def gaussian_blur_sigma(img, sigma, taps=_BLUR_TAPS, valid=None):
    """Blur with per-image sigma [B] via 2 passes of ``taps`` shifted adds.

    Edge padding matches PIL's edge extension.  With ``valid`` [B, H, W]
    the blur is renormalized over real pixels (blur(x*v)/blur(v)).
    """
    half = taps // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=img.device)
    w = torch.exp(-0.5 * (offs[None, :] / torch.clamp(
        sigma.float()[:, None], min=1e-3)) ** 2)
    w = w / w.sum(dim=1, keepdim=True)  # [B, taps]

    def pass_axis(x, axis):
        size = x.shape[axis]
        idx = torch.arange(-half, size + half, device=x.device)
        xp = x.index_select(axis, idx.clamp(0, size - 1))   # edge padding
        out = torch.zeros_like(x)
        for i in range(taps):
            out = out + xp.narrow(axis, i, size) * w[:, i].view(-1, 1, 1, 1)
        return out

    x = img.float()
    if valid is not None:
        v = valid.float()[..., None]
        x = torch.cat([x * v, v], dim=-1)  # blur value+mask together
    out = pass_axis(pass_axis(x, 1), 2)
    if valid is not None:
        out = out[..., :-1] / torch.clamp(out[..., -1:], min=1e-6)
        out = torch.where(valid[..., None], out, img.float())
    return out.to(img.dtype)


def normalize(img, mean, std):
    """(img - mean) / std with broadcast constants."""
    mean = _constant(mean, torch.float32, img.device)
    std = _constant(std, torch.float32, img.device)
    return (img.float() - mean) / std
