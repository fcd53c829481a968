"""VGG-16(BN) backbones: the DeepLabv2 head and FCN8s (counterpart of
``dasac_tpu/nn/vgg.py``).

  * DeepLabv2/VGG-16 (reference ``models/deeplabv2.py:229-312``):
    torchvision vgg16_bn features without pool4 and pool5 (indices 33 and
    43), dilation 2 on conv5_* (indices 34, 37, 40), dilated fc6/fc7 (3x3,
    1024 channels, dilation 4), then the ASPP head.
  * FCN8s/VGG-16 (reference ``models/fcn.py:10-149``): the features split at
    pool3 and pool4, a 4096-channel head (7x7 then 1x1) with BN, ReLU and
    channel dropout, and skip fusions through ``score_pool4`` and
    ``score_pool3``; each fusion resizes (align corners) to the skip's grid.

Like the ResNet, a model passes ``group`` to every BN, takes NHWC input, runs on its NCHW-shaped
``channels_last`` view and returns ``(logits, logits_up)`` NHWC f32.
Module names are the reference's torch keys and are registered in the
reference's order, so a reference ``state_dict`` loads with
``strict=True`` and ``named_parameters()`` lists the parameters in the
order of the reference optimizer's groups:

  * DeepLab: ``features.<i>`` (torchvision indices, shifted down by one
    above the removed pool 33), fc6/fc7 as ``features.42``/``features.44``,
    then ``classifier.conv2d_list.{0..3}``;
  * FCN: ``block1.<i>``, ``block2.<i>``, ``block3.<i>`` with the torchvision
    indices (the reference slices one Sequential, which keeps them),
    ``vgg_head.{0,1,4,5,8}``, ``score_pool4``, ``score_pool3``.
"""

import torch
from torch import nn

from dasac_tpu_torch.nn.functional import (max_pool,
                                           resize_bilinear_align_corners)
from dasac_tpu_torch.nn.layers import (Conv2d, SyncBatchNorm,
                                       apply_channel_dropout,
                                       sample_channel_dropout_draws)
from dasac_tpu_torch.nn.resnet import ASPP

_INIT_STD = 0.01  # reference init of the skip scores, normal(0, 0.01)

# torchvision vgg16_bn feature layout: (torch index, kind, out channels);
# every bn is followed by a relu, pools sit at 6, 13, 23, 33 and 43
VGG16_BN_LAYOUT = (
    (0, "conv", 64), (1, "bn", 64),
    (3, "conv", 64), (4, "bn", 64),
    (6, "pool", None),
    (7, "conv", 128), (8, "bn", 128),
    (10, "conv", 128), (11, "bn", 128),
    (13, "pool", None),
    (14, "conv", 256), (15, "bn", 256),
    (17, "conv", 256), (18, "bn", 256),
    (20, "conv", 256), (21, "bn", 256),
    (23, "pool", None),
    (24, "conv", 512), (25, "bn", 512),
    (27, "conv", 512), (28, "bn", 512),
    (30, "conv", 512), (31, "bn", 512),
    (33, "pool", None),
    (34, "conv", 512), (35, "bn", 512),
    (37, "conv", 512), (38, "bn", 512),
    (40, "conv", 512), (41, "bn", 512),
    (43, "pool", None),
)


class VGGStage(nn.Module):
    """The vgg16_bn features with torch indices in ``[start, stop)``, as
    children named by index (``rename`` maps a torch index to another
    name).  ``skip_pools`` are left out; the convs in ``dilate`` get
    dilation 2."""

    def __init__(self, start, stop, skip_pools=(), dilate=(),
                 dtype=torch.float32, rename=lambda i: i, group=None):
        super().__init__()
        self.plan = []
        in_ch = 3 if start == 0 else next(
            ch for i, kind, ch in reversed(VGG16_BN_LAYOUT)
            if i < start and kind == "conv")
        for idx, kind, ch in VGG16_BN_LAYOUT:
            if not start <= idx < stop or idx in skip_pools:
                continue
            if kind == "conv":
                d = 2 if idx in dilate else 1
                self.add_module(str(rename(idx)), Conv2d(
                    in_ch, ch, 3, padding=d, dilation=d, bias=True,
                    dtype=dtype))
                in_ch = ch
            elif kind == "bn":
                self.add_module(str(rename(idx)), SyncBatchNorm(
                    ch, dtype=dtype, group=group))
            self.plan.append((kind, str(rename(idx))))
        self.out_channels = in_ch

    def forward(self, x, update_stats):
        for kind, name in self.plan:
            if kind == "pool":
                x = max_pool(x, 2, 2)
            elif kind == "conv":
                x = getattr(self, name)(x)
            else:
                x = torch.relu(getattr(self, name)(x, not update_stats))
        return x


def _finish(logits, h, w, upsample):
    """NCHW-shaped logits -> ``(logits NHWC f32, upsampled or None)``."""
    logits = logits.float().permute(0, 2, 3, 1)
    if not upsample:
        return logits, None
    return logits, resize_bilinear_align_corners(logits, (h, w))


def _check_remat(remat):
    if remat not in ("none", False):
        raise ValueError("the port supports remat='none' only")


class DeepLabV2VGG16(nn.Module):
    """DeepLabv2 / VGG-16-BN, output stride 8."""

    def __init__(self, num_classes=19, dtype=torch.float32, remat="none",
                 group=None):
        super().__init__()
        _check_remat(remat)
        self.dtype = dtype
        # pools 33 and 43 removed: the reference's Sequential renumbers
        # everything after 33 one down
        self.features = VGGStage(0, 44, skip_pools=(33, 43),
                                 dilate=(34, 37, 40), dtype=dtype,
                                 rename=lambda i: i - 1 if i > 33 else i,
                                 group=group)
        kw = dict(padding=4, dilation=4, bias=True, dtype=dtype)
        self.features.add_module("42", Conv2d(512, 1024, 3, **kw))    # fc6
        self.features.add_module("44", Conv2d(1024, 1024, 3, **kw))   # fc7
        self.classifier = ASPP(1024, num_classes, dtype=dtype)

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        """``upsample=False`` returns ``(logits, None)``."""
        h, w = x.shape[1], x.shape[2]
        f = self.features
        y = f(x.to(self.dtype).permute(0, 3, 1, 2), update_stats)
        y = torch.relu(getattr(f, "42")(y))
        y = torch.relu(getattr(f, "44")(y))
        return _finish(self.classifier(y), h, w, upsample)


class VGG16FCN8s(nn.Module):
    """FCN8s / VGG-16-BN, output stride 8.  With ``train=True`` the head's
    two channel dropouts draw their masks from ``generator``."""

    def __init__(self, num_classes=19, dtype=torch.float32, remat="none",
                 drop_rate=0.1, group=None):
        super().__init__()
        _check_remat(remat)
        self.dtype = dtype
        self.drop_rate = drop_rate
        bn = dict(dtype=dtype, group=group)
        self.block1 = VGGStage(0, 24, **bn)     # to pool3, 1/8
        self.block2 = VGGStage(24, 34, **bn)    # to pool4, 1/16
        self.block3 = VGGStage(34, 44, **bn)    # to pool5, 1/32
        kw = dict(bias=True, dtype=dtype)
        # the reference's Sequential: 0 conv 7x7, 1 bn, 2 relu, 3 dropout,
        # 4 conv 1x1, 5 bn, 6 relu, 7 dropout, 8 conv 1x1 (the score)
        self.vgg_head = nn.ModuleDict({
            "0": Conv2d(512, 4096, 7, padding=3, **kw),
            "1": SyncBatchNorm(4096, **bn),
            "4": Conv2d(4096, 4096, 1, **kw),
            "5": SyncBatchNorm(4096, **bn),
            "8": Conv2d(4096, num_classes, 1, **kw),
        })
        self.score_pool4 = Conv2d(512, num_classes, 1, init_std=_INIT_STD,
                                  **kw)
        self.score_pool3 = Conv2d(256, num_classes, 1, init_std=_INIT_STD,
                                  **kw)

    def _dropout(self, x, train, generator):
        if not train or self.drop_rate == 0.0:
            return x
        keep = sample_channel_dropout_draws(generator, x, self.drop_rate)
        return apply_channel_dropout(x, keep, self.drop_rate)

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        """``upsample=False`` returns ``(logits, None)``."""
        h, w = x.shape[1], x.shape[2]
        frozen = not update_stats
        pool3 = self.block1(x.to(self.dtype).permute(0, 3, 1, 2),
                            update_stats)
        pool4 = self.block2(pool3, update_stats)
        pool5 = self.block3(pool4, update_stats)
        head = self.vgg_head
        s = torch.relu(head["1"](head["0"](pool5), frozen))
        s = self._dropout(s, train, generator)
        s = torch.relu(head["5"](head["4"](s), frozen))
        s = self._dropout(s, train, generator)
        s = head["8"](s)
        for score, skip in ((self.score_pool4, pool4),
                            (self.score_pool3, pool3)):
            skip = score(skip)
            # resized to the skip's grid, not x2: the reference's x2
            # assumes sizes divisible by 32 and is the same there
            s = resize_bilinear_align_corners(
                s.permute(0, 2, 3, 1), skip.shape[-2:]).permute(0, 3, 1, 2)
            s = s + skip
        return _finish(s, h, w, upsample)
