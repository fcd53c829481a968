"""Inference program: full-resolution single- or multi-scale (+flip)
prediction (counterpart of ``make_infer_fn`` in
``dasac_tpu/infer/engine.py``; reference infer_val.py:50-184, extended
with the multi-scale+flip protocol).
"""

import torch

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.nn.functional import (resize_bilinear_align_corners,
                                           resize_linear)


def make_infer_fn(model, mean, std, scales=(1.0,), flip=False, fuse="full",
                  output="probs", device=None):
    """``fn(images_u8 [B,H,W,3]) -> f32 probabilities [B,H,W,C]`` (or uint8
    labels [B,H,W] with ``output="argmax"``), with ``model``'s weights and
    frozen BN, on ``device`` (default CUDA; raises when there is none).

    Each scale ``s`` resizes the normalized input to ``int(round(h*s))`` x
    ``int(round(w*s))`` (linear, antialiased when it shrinks); with ``flip``
    the mirrored image runs in the same forward at twice the batch, and its
    result is mirrored back and averaged.

    ``fuse``:
      * ``"full"``    the reference protocol: each scale's logits are
        upsampled (align corners) to the input size, softmaxed there, and
        the probability maps averaged;
      * ``"stride8"`` each scale's stride-8 logits are resampled to the
        largest scale's stride-8 grid, softmaxed and averaged there, and
        the fused probabilities upsampled once.
    ``output="argmax"`` returns the labels from inside the program; with a
    single scale, ``fuse="full"`` and no flip it also skips the softmax
    (argmax-invariant).
    """
    if fuse not in ("full", "stride8"):
        raise ValueError("fuse must be full/stride8, got %r" % fuse)
    if output not in ("probs", "argmax"):
        raise ValueError("output must be probs/argmax, got %r" % output)
    device = resolve_device(device)
    skip_softmax = (output == "argmax" and fuse == "full"
                    and len(scales) == 1 and not flip)
    denom = len(scales) * (2 if flip else 1)

    def finish(p):
        if output == "argmax":
            return p.argmax(dim=-1).to(torch.uint8)
        return p

    def views(xs):
        return torch.cat([xs, xs.flip(2)], 0) if flip else xs

    def unflip(p, b):
        return p[:b] + p[b:].flip(2) if flip else p

    @torch.no_grad()
    def fn(images_u8):
        x = torch.as_tensor(images_u8).to(device, non_blocking=True)
        x = P.normalize(x.float() / 255.0, mean, std)
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        scaled = [x if s == 1.0 else
                  resize_linear(x, (int(round(h * s)), int(round(w * s))))
                  for s in scales]

        if fuse == "stride8":
            logits = [model(views(xs), train=False, update_stats=False,
                            upsample=False)[0] for xs in scaled]
            # common grid: the largest scale's stride-8 grid
            tgt = max(((lg.shape[1], lg.shape[2]) for lg in logits),
                      key=lambda s: s[0] * s[1])
            acc = None
            for lg in logits:
                p = unflip(torch.softmax(
                    resize_bilinear_align_corners(lg, tgt), dim=-1), b)
                acc = p if acc is None else acc + p
            return finish(resize_bilinear_align_corners(acc / denom, (h, w)))

        acc = None
        for xs in scaled:
            _, up = model(views(xs), train=False, update_stats=False)
            up = resize_bilinear_align_corners(up, (h, w))
            p = unflip(up if skip_softmax else torch.softmax(up, dim=-1), b)
            acc = p if acc is None else acc + p
        return finish(acc / denom)

    return fn
