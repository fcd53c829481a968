"""Host-side decode + prefetch pipeline feeding uint8 batches to the card
(counterpart of ``dasac_tpu/data/host_loader.py``).

A thread pool decodes (``data/png.py``: zlib inflates with the GIL
released), optionally resizes or crops, and stacks uint8 arrays; the
augmentation runs on the card inside the train step.  Batches are
prefetched ahead of the step.

Decode policies (``mode``), the same as ``dasac_tpu``'s:

  * ``"resize"``: with ``TPU.NATIVE_LOADER`` on (the default), PNG pairs go
    through the C++ decoder (``data/native.py``, the library ``dasac_tpu``
    loads), whose bilinear image resize is within a mean |d| of 1.5 levels
    of PIL's and whose masks are PIL-``NEAREST``'s: the bytes
    ``dasac_tpu`` gives.  A batch is one call into the library's thread
    pool.  Otherwise, and for every sample the library refuses, images get
    PIL-``BILINEAR`` semantics, i.e. antialiased bilinear on a downscale,
    by ``F.interpolate(..., mode="bilinear", antialias=True)`` on uint8
    channels-last tensors on the CPU (torch's uint8 path, which follows
    PIL's fixed-point filter: equal to PIL on integer-ratio downscales,
    within 1 level elsewhere); masks PIL-``NEAREST`` index mapping (source
    coordinate ``scale/2 + k*scale`` accumulated in float64 and truncated,
    as PIL's affine scaler does), so labels match exactly;
  * ``"center_crop"``: pad with the fill value, then slice (numpy);
  * ``"native"``: as decoded.

With ``TPU.NATIVE_LOADER`` on, ``"center_crop"`` and ``"native"`` samples
are decoded by the library at the frame's own size, which is exact (the
bytes of PIL's decode and of ``data/png.py``'s), unless the mask is of a
colour type other than gray or palette: the library's luma of such a mask
is not PIL's ``convert("L")``, so that pair is decoded in Python.
``native.PATH_DECODES`` counts every decoded sample by route.
"""

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dasac_tpu_torch.data import native, png
from dasac_tpu_torch.data.category import IGNORE_LABEL


def resize_image(img, out_hw):
    """uint8 [H, W, 3] -> [*out_hw, 3], PIL-BILINEAR semantics."""
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t.contiguous(memory_format=torch.channels_last),
                        size=tuple(out_hw), mode="bilinear", antialias=True,
                        align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def _nearest_index(n_in, n_out):
    """PIL's nearest-neighbour source index of each output pixel."""
    step = n_in / n_out
    v, idx = step * 0.5, []
    for _ in range(n_out):
        idx.append(min(int(v), n_in - 1))
        v += step
    return np.asarray(idx, np.intp)


def resize_mask(mask, out_hw):
    """uint8 [H, W] -> ``out_hw``, PIL-NEAREST index mapping."""
    h, w = mask.shape
    return mask[np.ix_(_nearest_index(h, out_hw[0]),
                       _nearest_index(w, out_hw[1]))]


def _is_png(path):
    return path is None or path.endswith(".png")


def _exact_mask(mask_path):
    """Whether the library decodes this mask as the Python path does: no
    mask, or an 8-bit gray or palette PNG (colour type 0 or 3)."""
    return mask_path is None or png.ihdr(mask_path)[2:] in ((8, 0), (8, 3))


def _load_native(img_path, mask_path, out_hw, mode):
    """The pair through the C++ decoder, or None where it takes the Python
    path: resized to ``out_hw`` in ``resize`` mode, else decoded exactly at
    its own size (and cropped in ``center_crop`` mode)."""
    if not (_is_png(img_path) and _is_png(mask_path)):
        return None
    if mode == "resize" and out_hw is not None:
        return native.decode_pair(img_path, mask_path, out_hw,
                                  mask_fill=IGNORE_LABEL)
    if not _exact_mask(mask_path):
        return None
    hw = native.png_info(img_path)
    res = hw and native.decode_pair(img_path, mask_path, hw,
                                    mask_fill=IGNORE_LABEL)
    if res is None or mode != "center_crop":
        return res
    img, mask = res
    return (np.ascontiguousarray(_center_crop(img, out_hw, fill=0)),
            np.ascontiguousarray(_center_crop(mask, out_hw,
                                              fill=IGNORE_LABEL)))


def _load_pair(img_path, mask_path, out_hw, mode):
    """Decode one (image, mask) pair to uint8 arrays sized ``out_hw``."""
    if mode not in ("resize", "center_crop", "native"):
        raise ValueError(mode)
    if native.enabled():
        res = _load_native(img_path, mask_path, out_hw, mode)
        if res is not None:
            return res
    native.count("python")
    img = png.to_rgb(png.read(img_path))
    if mask_path is None:
        mask = np.full(img.shape[:2], IGNORE_LABEL, np.uint8)
    else:
        # colour-type-3 masks carry trainIds as palette INDICES (the
        # inference engine exports this format): kept raw
        mask = png.to_mask(png.read(mask_path))
    if img.shape[:2] != mask.shape:
        raise ValueError("image %s is %s, mask %s is %s" % (
            img_path, img.shape[:2], mask_path, mask.shape))

    if mode == "resize":
        if out_hw is not None and img.shape[:2] != tuple(out_hw):
            img = resize_image(img, out_hw)
            mask = resize_mask(mask, out_hw)
    elif mode == "center_crop":
        img = _center_crop(img, out_hw, fill=0)
        mask = _center_crop(mask, out_hw, fill=IGNORE_LABEL)
    return np.ascontiguousarray(img), np.ascontiguousarray(mask)


def _center_crop(a, out_hw, fill=0):
    th, tw = out_hw
    h, w = a.shape[:2]
    if w < tw or h < th:
        ph, pw = max(h, th), max(w, tw)
        canvas = np.full((ph, pw) + a.shape[2:], fill, np.uint8)
        y0, x0 = (ph - h) // 2, (pw - w) // 2
        canvas[y0:y0 + h, x0:x0 + w] = a
        a, h, w = canvas, ph, pw
    left = (w - tw) // 2
    top = (h - th) // 2
    return a[top:top + th, left:left + tw]


class SegDataset:
    """File lists + decode policy for one split."""

    def __init__(self, images, masks, out_hw, mode="resize"):
        self.images = images
        self.masks = masks
        self.out_hw = tuple(out_hw) if out_hw is not None else None
        self.mode = mode
        self.num_samples = len(images)  # may be overridden (epoch alignment)

    def set_num_samples(self, n):
        self.num_samples = n

    def __len__(self):
        return self.num_samples

    def load(self, i):
        if i < 0:
            # padding sample (fills a partial tail batch): contributes nothing
            assert self.out_hw is not None
            return (np.zeros((*self.out_hw, 3), np.uint8),
                    np.full(self.out_hw, IGNORE_LABEL, np.uint8))
        i = i % len(self.images)
        return _load_pair(self.images[i], self.masks[i], self.out_hw, self.mode)

    def _native_eligible(self, i):
        return (i >= 0 and self.mode == "resize" and self.out_hw is not None
                and _is_png(self.images[i % len(self.images)])
                and _is_png(self.masks[i % len(self.images)]))

    def load_batch(self, idxs, pool=None, threads=8):
        """list[(img, mask)] ordered like ``idxs``.  With the native decoder
        on, the batch's resize-mode PNG samples are ONE call into the C++
        thread pool (decode + unfilter + resize with the GIL released); the
        rest, and the samples it refuses, are decoded on ``pool``."""
        out = [None] * len(idxs)
        sel = [j for j, i in enumerate(idxs) if self._native_eligible(i)]
        if sel and native.enabled():
            ii = [idxs[j] % len(self.images) for j in sel]
            imgs, masks, status = native.decode_batch(
                [self.images[i] for i in ii], [self.masks[i] for i in ii],
                self.out_hw, threads=threads, mask_fill=IGNORE_LABEL)
            for k, j in enumerate(sel):
                if status[k] == 0:
                    out[j] = (imgs[k], masks[k])
        rest = [j for j in range(len(idxs)) if out[j] is None]
        loaded = (pool.map(self.load, [idxs[j] for j in rest]) if pool
                  else map(self.load, [idxs[j] for j in rest]))
        for j, pair in zip(rest, loaded):
            out[j] = pair
        return out

    def mask_basenames(self):
        return [None if m is None else os.path.basename(m) for m in self.masks]


class PrefetchLoader:
    """Iterates batches of decoded samples with thread-pool prefetch.

    ``index_fn(batch_idx) -> list[int]`` decides which samples form a batch
    (plain slicing for source/val; importance sampling for target groups).
    """

    def __init__(self, dataset, batch_size, num_batches, index_fn,
                 threads=8, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.index_fn = index_fn
        self.threads = threads
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return self.num_batches

    def _assemble(self, pool, bi):
        idxs = self.index_fn(bi)
        pairs = self.dataset.load_batch(idxs, pool, self.threads)
        imgs = np.stack([p[0] for p in pairs])
        msks = np.stack([p[1] for p in pairs])
        return imgs, msks

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # stop-aware put: a plain q.put blocks forever when the consumer
            # abandons the iterator (e.g. validation's max_batches break),
            # leaking the producer thread and its pool
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # exceptions (corrupt file, transient FS error) are forwarded to
            # the consumer instead of silently killing this thread — a dead
            # producer with no sentinel would hang the training job forever
            try:
                with ThreadPoolExecutor(self.threads) as pool:
                    for bi in range(self.num_batches):
                        if stop.is_set() or not put(self._assemble(pool, bi)):
                            return
                put(None)
            except BaseException as e:  # noqa: B036 — re-raised in consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def padded_plain_loader(dataset, batch_size, threads, prefetch,
                        max_batches=None):
    """Sequential loader over the whole dataset with the tail batch padded by
    all-ignore dummies (index -1), keeping batch shapes static without
    double-counting images (shared by validation and inference)."""
    n = len(dataset)
    num_batches = -(-n // batch_size)
    if max_batches:
        num_batches = min(num_batches, max_batches)
    idx = np.full(num_batches * batch_size, -1, np.int64)
    take = min(n, len(idx))
    idx[:take] = np.arange(take)
    return PrefetchLoader(dataset, batch_size, num_batches,
                          make_plain_index_fn(idx, batch_size),
                          threads=threads, prefetch=prefetch)


def make_plain_index_fn(sampler_indices, batch_size):
    idx = np.asarray(sampler_indices)

    def fn(bi):
        return idx[bi * batch_size:(bi + 1) * batch_size].tolist()

    return fn


def make_importance_index_fn(importance, order, batch_size, epoch, seed=0):
    """Target-group batches: each slot draws an image by class-uniform
    importance sampling, seeded deterministically per (epoch, slot)."""

    def fn(bi):
        out = []
        for k in range(batch_size):
            slot = int(order[(bi * batch_size + k) % len(order)])
            rng = np.random.RandomState(
                (seed * 9973 + epoch * 131071 + slot) % (2**31 - 1))
            out.append(importance.sample(slot, rng))
        return out

    return fn
