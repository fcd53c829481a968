"""DeepLabv2 with a dilated ResNet-101 backbone (stride 8) — counterpart of
``dasac_tpu/nn/resnet.py``.

Architecture (reference ``models/deeplabv2.py:54-227``):
  * stem: 7x7/2 conv -> BN -> relu -> 3x3/2 ceil-mode maxpool
  * layer1 (3 bottlenecks), layer2 (4, stride 2), layer3 (23, dilation 2),
    layer4 (3, dilation 4) — stride on the first 1x1 conv of each
    bottleneck, downsample projection also on blocks that only change
    dilation
  * ASPP head: sum of four 3x3 convs, dilations 6/12/18/24
  * logits cast to f32, then upsampled to the input size with
    align_corners=True bilinear

The model takes NHWC input and permutes it to an NCHW-shaped view in
``channels_last`` memory (no copy); the convolutions run on that layout,
and the outputs come back NHWC.  Module names give the reference
``state_dict`` keys (``model.conv1``, ``model.layer1.0.conv1``,
``model.layer5.conv2d_list.0``, ...), so a reference checkpoint loads with
``strict=True``.  ``group`` (a process group, or ``None``) goes to every
BN for cross-replica statistics.
"""

import torch
from torch import nn

from dasac_tpu_torch.nn.functional import (max_pool_ceil,
                                           resize_bilinear_align_corners)
from dasac_tpu_torch.nn.layers import Conv2d, SyncBatchNorm

_INIT_STD = 0.01  # reference init for convs, normal(0, 0.01)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, dilation=1,
                 has_downsample=False, dtype=torch.float32, group=None):
        super().__init__()
        kw = dict(dtype=dtype, init_std=_INIT_STD)
        bn = dict(dtype=dtype, group=group)
        out = planes * self.expansion
        self.conv1 = Conv2d(in_planes, planes, 1, stride=stride, **kw)
        self.bn1 = SyncBatchNorm(planes, **bn)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation, **kw)
        self.bn2 = SyncBatchNorm(planes, **bn)
        self.conv3 = Conv2d(planes, out, 1, **kw)
        self.bn3 = SyncBatchNorm(out, **bn)
        self.downsample = nn.ModuleList([
            Conv2d(in_planes, out, 1, stride=stride, **kw),
            SyncBatchNorm(out, **bn),
        ]) if has_downsample else None

    def forward(self, x, update_stats):
        frozen = not update_stats
        out = torch.relu(self.bn1(self.conv1(x), frozen))
        out = torch.relu(self.bn2(self.conv2(out), frozen))
        out = self.bn3(self.conv3(out), frozen)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), frozen)
        return torch.relu(out + residual.to(out.dtype))


class ASPP(nn.Module):
    """Sum of four dilated 3x3 classifier convs (DeepLabv2 head)."""

    def __init__(self, in_ch, num_classes, dilations=(6, 12, 18, 24),
                 dtype=torch.float32):
        super().__init__()
        self.conv2d_list = nn.ModuleList([
            Conv2d(in_ch, num_classes, 3, padding=d, dilation=d, bias=True,
                   dtype=dtype, init_std=_INIT_STD)
            for d in dilations])

    def forward(self, x):
        out = None
        for conv in self.conv2d_list:
            branch = conv(x)
            out = branch if out is None else out + branch
        return out


class ResNet101Backbone(nn.Module):
    """Dilated ResNet-101 trunk, output stride 8, 2048 channels.

    ``layers`` sets the blocks per stage (the reference's (3, 4, 23, 3);
    tests build shallower trunks at full width).
    """

    # (planes, stride, dilation) per stage
    SPECS = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))

    def __init__(self, dtype=torch.float32, layers=(3, 4, 23, 3),
                 group=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype,
                            init_std=_INIT_STD)
        self.bn1 = SyncBatchNorm(64, dtype=dtype, group=group)
        in_planes = 64
        for li, ((planes, stride, dilation), n_blocks) in enumerate(
                zip(self.SPECS, layers), start=1):
            blocks = []
            for bi in range(n_blocks):
                first = bi == 0
                # first block projects when shape/stride/dilation changes
                # (reference deeplabv2.py:145 also projects for dilation 2/4)
                has_down = first and (stride != 1 or in_planes != planes * 4
                                      or dilation in (2, 4))
                blocks.append(Bottleneck(
                    in_planes, planes, stride=stride if first else 1,
                    dilation=dilation, has_downsample=has_down, dtype=dtype,
                    group=group))
                in_planes = planes * 4
            self.add_module("layer{}".format(li), nn.ModuleList(blocks))
        self.out_channels = in_planes

    def forward(self, x, update_stats):
        """``x`` NCHW-shaped; returns the stride-8 features."""
        x = torch.relu(self.bn1(self.conv1(x), not update_stats))
        x = max_pool_ceil(x, window=3, stride=2, padding=1)
        for li in range(1, 5):
            for block in getattr(self, "layer{}".format(li)):
                x = block(x, update_stats)
        return x


class DeepLabV2ResNet101(nn.Module):
    """Takes NHWC input; returns ``(logits_s8, logits_up)``, both NHWC f32
    (the reference forward, ``deeplabv2.py:213-227``, without the loss)."""

    def __init__(self, num_classes=19, dtype=torch.float32, remat="none",
                 layers=(3, 4, 23, 3), group=None):
        super().__init__()
        if remat not in ("none", False):
            raise ValueError("the port supports remat='none' only")
        self.dtype = dtype
        self.model = ResNet101Backbone(dtype=dtype, layers=layers,
                                       group=group)
        # the reference keeps the classifier inside its trunk container as
        # ``layer5``; the trunk's forward does not run it
        self.model.layer5 = ASPP(self.model.out_channels, num_classes,
                                 dtype=dtype)

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        """``upsample=False`` returns ``(logits_s8, None)`` (inference on
        the stride-8 grid)."""
        h, w = x.shape[1], x.shape[2]
        feats = self.model(x.to(self.dtype).permute(0, 3, 1, 2), update_stats)
        logits = self.model.layer5(feats).float().permute(0, 2, 3, 1)
        if not upsample:
            return logits, None
        return logits, resize_bilinear_align_corners(logits, (h, w))
