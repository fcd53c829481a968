"""Observability: scalar/image writers (counterpart of
``dasac_tpu/utils/logging.py``; reference base_trainer.py TB usage).  Data
parallel: rank 0 writes, the other ranks get a :class:`NullWriter`.

Every scalar goes to a JSONL event log, ``events.jsonl`` (machine-readable,
the same records as ``dasac_tpu`` writes); when torch's SummaryWriter is
importable the same scalars are mirrored to TensorBoard.  Images are
written as PNGs by the port's encoder (``data/png.py``).
"""

import json
import os
import time

import numpy as np

from dasac_tpu_torch.data import png


class ScalarWriter:
    def __init__(self, logdir):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:
            self._tb = None

    def add_scalar(self, tag, value, step):
        rec = {"t": time.time(), "tag": tag, "value": float(value),
               "step": int(step)}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_image(self, tag, image_hwc, step):
        """uint8 [H,W,3]; saved as PNG next to the log + mirrored to TB."""
        arr = np.asarray(image_hwc)
        d = os.path.join(self.logdir, "images")
        os.makedirs(d, exist_ok=True)
        png.write(os.path.join(d, "{}_{:06d}.png".format(
            tag.replace("/", "_"), int(step))), arr)
        if self._tb is not None:
            self._tb.add_image(tag, arr, int(step), dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """What the ranks other than 0 write to: nothing (reference
    train.py:523 logs from rank 0 only)."""

    def add_scalar(self, tag, value, step):
        pass

    def add_image(self, tag, image_hwc, step):
        pass

    def close(self):
        pass
