"""Tiny segmentation model (registered arch name: "tiny"; counterpart of
``dasac_tpu/nn/tiny.py``).

Not a reference arch — exists for CPU smoke runs and tests where the full
backbones are too heavy."""

import torch
from torch import nn

from dasac_tpu_torch.nn.functional import resize_bilinear_align_corners
from dasac_tpu_torch.nn import spatial
from dasac_tpu_torch.nn.resnet import remat_mode
from dasac_tpu_torch.nn.layers import (Conv2d, SyncBatchNorm,
                                       apply_channel_dropout,
                                       sample_channel_dropout_draws)


class TinySeg(nn.Module):
    """Takes NHWC input; returns ``(logits, logits_up)`` NHWC f32."""

    def __init__(self, num_classes=5, width=8, dtype=torch.float32,
                 remat="none", group=None):
        super().__init__()
        remat_mode(remat)  # accepted for interface parity; nothing to checkpoint
        self.conv_a = Conv2d(3, width, 3, stride=2, padding="same", bias=True)
        self.bn_a = SyncBatchNorm(width, group=group)
        self.conv_b = Conv2d(width, width, 3, stride=2, padding="same",
                             bias=True)
        self.bn_b = SyncBatchNorm(width, group=group)
        self.aspp = Conv2d(width, num_classes, 1, bias=True)

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        """``upsample=False`` returns ``(logits, None)``."""
        h, w = spatial.frame_hw(x)
        y = x.permute(0, 3, 1, 2)
        y = self.bn_a(self.conv_a(y), not update_stats, relu=True)
        y = self.bn_b(self.conv_b(y), not update_stats, relu=True)
        if train:
            # Dropout(0.1) with one mask value per (image, channel), as the
            # flax broadcast_dims=(1, 2) gives
            y = apply_channel_dropout(
                y, sample_channel_dropout_draws(generator, y, 0.1), 0.1)
        logits = self.aspp(y).float().permute(0, 2, 3, 1)
        if not upsample:
            return logits, None
        return logits, resize_bilinear_align_corners(logits, (h, w))
