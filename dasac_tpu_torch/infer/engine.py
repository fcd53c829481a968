"""Inference program: full-resolution single- or multi-scale (+flip)
prediction and Cityscapes export on one device (counterpart of
``dasac_tpu/infer/engine.py``; reference infer_val.py:50-184, extended
with the multi-scale+flip protocol).

Exports per image, all through the port's PNG codec (``data/png.py``):
  * ``<name>.png``     trainId mask, a palette PNG (the pixel values ARE the
                       trainIds; PIL opens it in mode "P");
  * ``cs/<name>.png``  Cityscapes labelId mask, gray (for the official
                       evalPixelLevelSemanticLabeling tool);
  * ``raw/<name>.npz`` float16 softmax probabilities (optional);
  * ``vis/<name>.png`` overlay visualisation (optional).

Over a world of ranks, one process a device, ``run_inference`` lays the
ranks out as ``dasac_tpu``'s ``infer_mesh`` lays out devices
(``core/mesh.py``): frames split over the ranks, one frame's height over
all of them (``nn/spatial.py`` does the halo exchanges that GSPMD does
for ``dasac_tpu``), or both.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.core.mesh import infer_mesh, sp_group
from dasac_tpu_torch.data import host_loader, lists, png
from dasac_tpu_torch.data.category import (colorize, train_palette,
                                           trainid_to_cs_table)
from dasac_tpu_torch.data.factory import _split_size
from dasac_tpu_torch.nn.functional import (resize_bilinear_align_corners,
                                           resize_linear)
from dasac_tpu_torch.nn.spatial import Sharded, frame_hw
from dasac_tpu_torch.train.metrics import confusion_matrix
from dasac_tpu_torch.utils.spans import span

PROGRESS_EVERY = 50   # frames between run_inference's progress lines


class InferDataset(host_loader.SegDataset):
    """Full-resolution loader for an infer list (reference DLInfer /
    DLCityscapesInfer, dataloader_infer.py:30-124).

    Frames are resized to the split's canonical size (GTA val frames vary
    slightly per file; the reference resizes them too), so every batch has
    one shape."""

    def __init__(self, root, split, cityscapes_names=False, list_dir=None):
        images, masks = lists.read_split(root, split, list_dir=list_dir)
        super().__init__(images, masks, _split_size(split, images),
                         mode="resize")
        self.cityscapes_names = cityscapes_names

    def name(self, i):
        base = os.path.splitext(os.path.basename(self.images[i]))[0]
        if self.cityscapes_names:
            base = base.replace("_leftImg8bit", "_gtFine_labelIds")
        return base


def make_infer_fn(model, mean, std, scales=(1.0,), flip=False, fuse="full",
                  output="probs", device=None, sharded=None):
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

    ``sharded`` (an ``nn.spatial.Sharded``) splits each frame's height over
    its group: every rank of the group passes the same whole frames, each
    scale is resized whole and then sharded, and ``fn`` returns this
    rank's rows (``sharded.own(H)``) of the result.  Flip mirrors W, which
    every rank holds whole.

    Each call is an ``infer`` span (``utils/spans.py``).
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

    def fused(scaled, b, h, w):
        if fuse == "stride8":
            logits = [model(views(xs), train=False, update_stats=False,
                            upsample=False)[0] for xs in scaled]
            # common grid: the largest scale's stride-8 grid
            tgt = max((frame_hw(lg) for lg in logits),
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

    @torch.no_grad()
    def fn(images_u8):
        with span("infer", device):
            x = torch.as_tensor(images_u8).to(device, non_blocking=True)
            x = P.normalize(x.float() / 255.0, mean, std)
            b, h, w = x.shape[0], x.shape[1], x.shape[2]
            scaled = [x if s == 1.0 else
                      resize_linear(x, (int(round(h * s)), int(round(w * s))))
                      for s in scales]
            if sharded is None:
                return fused(scaled, b, h, w)
            with sharded.frame():
                return fused([sharded.shard(xs, 1) for xs in scaled], b, h, w)

    return fn


class ResultWriter:
    """Export on a thread pool (reference ResultWriter + mp.Pool,
    infer_val.py:70-109,160).  ``close()`` waits for every write and
    re-raises the first error a worker hit."""

    def __init__(self, out_dir, save_raw=False, vis=False, workers=4):
        self.out_dir = out_dir
        self.save_raw = save_raw
        self.vis = vis
        for sub, on in (("", True), ("cs", True), ("raw", save_raw),
                        ("vis", vis)):
            if on:
                os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        self._palette = train_palette().reshape(-1, 3)
        self._t2c = trainid_to_cs_table()
        self._pool = ThreadPoolExecutor(workers)
        self._futures = []

    def submit(self, pred, image_u8, name, probs=None):
        """``pred``: uint8 [H, W] trainIds (host memory); ``probs`` [H, W,
        C] only with ``save_raw``."""
        self._futures.append(self._pool.submit(
            self._write, pred, image_u8, name, probs))

    def _write(self, pred, image_u8, name, probs=None):
        png.write(os.path.join(self.out_dir, name + ".png"), pred,
                  palette=self._palette)
        png.write(os.path.join(self.out_dir, "cs", name + ".png"),
                  self._t2c[pred])
        if self.save_raw:
            if probs is None:
                raise ValueError("save_raw needs the probabilities of %s"
                                 % name)
            np.savez_compressed(os.path.join(self.out_dir, "raw",
                                             name + ".npz"),
                                raw=probs.astype(np.float16))
        if self.vis:
            overlay = (0.3 * image_u8 + 0.7 * colorize(pred)).astype(np.uint8)
            png.write(os.path.join(self.out_dir, "vis", name + ".png"),
                      overlay)
        return name

    def close(self):
        try:
            for f in self._futures:
                f.result()
        finally:
            self._pool.shutdown()


def pad_to_tile(imgs, n_sp):
    """``imgs`` ``[B, H, W, 3]`` with edge-replicated rows added below up
    to the next multiple of ``n_sp`` (``dasac_tpu``'s rule for a height
    that does not tile its ``sp`` axis; the output is sliced back)."""
    pad = -imgs.shape[1] % n_sp if n_sp else 0
    if not pad:
        return imgs
    return np.pad(imgs, ((0, 0), (0, pad), (0, 0), (0, 0)), mode="edge")


def run_inference(model, dataset, out_dir, *, mean, std, num_classes=19,
                  scales=(1.0,), flip=False, save_raw=False, vis=False,
                  workers=4, verbose=True, batch_size=None, spatial=0,
                  fuse="full", device=None, group=None):
    """Forward every image of ``dataset`` with ``model``'s weights on
    ``device`` (default CUDA; raises when there is none), export it, and
    sum the confusion where ground truth is present.  Returns the int64
    ``[C, C]`` confusion as numpy (on every rank), or None.

    ``group`` is the world's process group (``None``: a world of one, no
    ``torch.distributed`` call), one rank a device; the world is laid out
    as ``dasac_tpu`` lays out its devices (:func:`infer_mesh`):
      * ``spatial`` 0: batches of ``batch_size`` frames (default one a
        rank) split over the ranks;
      * ``spatial`` True/-1: every rank on one frame's height;
      * ``spatial`` N: ``world / N`` frames side by side, N ranks a frame.
    Each rank decodes its data index's frames (``padded_plain_loader``,
    ``num_replicas`` the data axis; the ``sp`` ranks of a frame all decode
    it) on ``workers`` threads two batches ahead; tails are padded with
    all-ignore frames.  A height that does not tile the ``sp`` ranks is
    edge-padded to the next multiple and the result sliced back, as
    ``dasac_tpu`` pads it.  Each rank counts the confusion on its own rows
    and the world sums it; a frame's labels are gathered to its first
    ``sp`` rank, which exports it.

    Unless ``save_raw`` asks for the probabilities, the program returns
    the on-device argmax (``make_infer_fn(output="argmax")``); either way
    one uint8 copy per batch crosses to the host, and the float
    probabilities only with ``save_raw``.  ``fuse`` is
    :func:`make_infer_fn`'s."""
    device = resolve_device(device)
    world, rank = (1, 0) if group is None else (group.size(), group.rank())
    layout = infer_mesh(world, batch_size, spatial)
    sp = None if group is None else sp_group(layout, rank)
    sharded = None if sp is None else Sharded(sp)
    coords = layout.coords(rank)
    have_gt = any(m is not None for m in dataset.masks)
    conf = None
    if coords is not None:
        conf = _infer_rank(model, dataset, out_dir, layout, coords, sharded,
                           mean=mean, std=std, num_classes=num_classes,
                           scales=scales, flip=flip, save_raw=save_raw,
                           vis=vis, workers=workers,
                           verbose=verbose and rank == 0, fuse=fuse,
                           device=device, have_gt=have_gt)
    if have_gt and group is not None:
        if conf is None:
            conf = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                               device=device)
        dist.all_reduce_sum_([conf], group)
    return None if conf is None else conf.cpu().numpy()


def _infer_rank(model, dataset, out_dir, layout, coords, sharded, *, mean,
                std, num_classes, scales, flip, save_raw, vis, workers,
                verbose, fuse, device, have_gt):
    """One rank's part of :func:`run_inference`: its confusion (device
    int64) or None."""
    d, s = coords
    b = layout.b // layout.n_data
    infer_fn = make_infer_fn(model, mean, std, scales, flip, fuse,
                             output="probs" if save_raw else "argmax",
                             device=device, sharded=sharded)
    writer = (ResultWriter(out_dir, save_raw=save_raw, vis=vis,
                           workers=workers) if s == 0 else None)
    conf = None
    n = len(dataset)
    loader = host_loader.padded_plain_loader(
        dataset, b, threads=workers, prefetch=2, num_replicas=layout.n_data,
        rank=d)
    try:
        for bi, (imgs, masks) in enumerate(loader):
            h_img = imgs.shape[1]
            frames = pad_to_tile(imgs, layout.n_sp)
            h_pad = frames.shape[1] - h_img
            out = infer_fn(frames)
            preds = out.argmax(-1).to(torch.uint8) if save_raw else out
            lo, hi = ((0, h_img) if sharded is None
                      else sharded.own(h_img + h_pad))
            real = min(hi, h_img) - lo   # this rank's rows inside the frame
            if have_gt and real > 0:
                c = confusion_matrix(preds[:, :real], torch.from_numpy(
                    masks[:, lo:lo + real]).to(device, non_blocking=True),
                    num_classes)
                conf = c if conf is None else conf + c
            probs = out if save_raw else None
            if sharded is not None:
                preds = sharded.gather(preds, 1, h_img + h_pad)
                if save_raw:
                    probs = sharded.gather(probs, 1, h_img + h_pad)
            if writer is not None:
                preds_np = preds[:, :h_img].cpu().numpy()  # one uint8 copy
                probs_np = (probs[:, :h_img].cpu().numpy() if save_raw
                            else None)
                # padded_plain_loader's frames of this data index
                first = bi * layout.b + d * b
                for k in range(min(b, n - first)):
                    writer.submit(preds_np[k], imgs[k],
                                  dataset.name(first + k),
                                  probs=None if probs_np is None
                                  else probs_np[k])
            step = layout.b
            if verbose and (bi * step) % PROGRESS_EVERY < step:
                print("[{:4d}/{:4d}] {}".format(
                    min(bi * step + 1, n), n,
                    dataset.name(min(bi * step, n - 1))))
    finally:
        if writer is not None:
            writer.close()
    return conf
