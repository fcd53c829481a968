"""DeepLabv2 with a dilated ResNet-101 trunk (Chen et al., TPAMI 2017; He
et al., CVPR 2016), output stride 8.

Stem: 7x7/2 conv, BN, ReLU, 3x3/2 ceil-mode max pool.  Four stages of
bottlenecks (3, 4, 23, 3) with (64, 128, 256, 512) planes, stride 2 on
the first 1x1 conv of stage 2, dilation 2 and 4 in stages 3 and 4; the
first block of a stage projects its residual (also where only the
dilation changes).  Head: the sum of four 3x3 convs with dilations 6, 12,
18 and 24 (ASPP).  Logits in f32, upsampled to the input size with
align-corners bilinear.  Module names are the reference torch code's
(``model.layer1.0.conv1``, ``model.layer5.conv2d_list.0``).

Starting weights: the head normal(0, 0.01), the reference's init of its
from-scratch layers.  The trunk, which the recipe starts from ImageNet
weights, stands in for them: lecun-normal convs, so that activations keep
their scale through the 33 blocks (at normal(0, 0.01) every projection
shrinks them ~10x and the logits vanish to ~1e-7: a model whose loss no
precision moves), and the last BN of each block at 0.1 (the small
residual-branch gain of Goyal et al. 2017's zero-init; at 1 the live-BN
step at this depth is chaotic, its first gradient moved by 25-95% by
bf16 rounding alone)."""

import torch
from torch import nn

from benchmark.reference.layers import (BatchNorm, Conv2d, max_pool_ceil,
                                        resize_align_corners)

NEW_SCOPES = ("model.layer5",)
HEAD_STD = 0.01
BRANCH_GAIN = 0.1


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dilation, project):
        super().__init__()
        out = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, stride=stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm(out, init_weight=BRANCH_GAIN)
        self.downsample = nn.ModuleList([
            Conv2d(cin, out, 1, stride=stride),
            BatchNorm(out)]) if project else None

    def forward(self, x, prec, live):
        y = torch.relu(self.bn1(self.conv1(x, prec), prec, live))
        y = torch.relu(self.bn2(self.conv2(y, prec), prec, live))
        y = self.bn3(self.conv3(y, prec), prec, live)
        r = x
        if self.downsample is not None:
            r = self.downsample[1](self.downsample[0](x, prec), prec, live)
        return torch.relu(y + r.to(y.dtype))


class ASPP(nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.conv2d_list = nn.ModuleList([
            Conv2d(cin, num_classes, 3, padding=d, dilation=d, bias=True,
                   init_std=HEAD_STD) for d in (6, 12, 18, 24)])

    def forward(self, x, prec):
        out = None
        for conv in self.conv2d_list:
            y = conv(x, prec)
            out = y if out is None else out + y
        return out


class Trunk(nn.Module):
    STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))

    def __init__(self, num_classes, layers):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, ((planes, stride, dilation), n) in enumerate(
                zip(self.STAGES, layers), start=1):
            blocks = []
            for j in range(n):
                project = j == 0 and (stride != 1 or cin != planes * 4
                                      or dilation in (2, 4))
                blocks.append(Bottleneck(cin, planes,
                                         stride if j == 0 else 1, dilation,
                                         project))
                cin = planes * 4
            setattr(self, "layer%d" % i, nn.ModuleList(blocks))
        self.layer5 = ASPP(cin, num_classes)


class Model(nn.Module):
    def __init__(self, num_classes, layers=(3, 4, 23, 3)):
        super().__init__()
        self.model = Trunk(num_classes, layers)

    def forward(self, x, prec, live=False, train=False, generator=None,
                upsample=True):
        """NHWC ``x`` -> ``(logits, logits_up)``, NHWC f32."""
        h, w = x.shape[1:3]
        t = self.model
        y = x.to(prec.dtype).permute(0, 3, 1, 2)
        y = torch.relu(t.bn1(t.conv1(y, prec), prec, live))
        y = max_pool_ceil(y)
        for i in range(1, 5):
            for block in getattr(t, "layer%d" % i):
                y = block(y, prec, live)
        logits = t.layer5(y, prec).float().permute(0, 2, 3, 1)
        if not upsample:
            return logits, None
        return logits, resize_align_corners(logits, (h, w))
