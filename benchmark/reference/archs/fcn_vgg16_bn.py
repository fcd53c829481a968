"""FCN8s on VGG-16 with BN (Long et al., CVPR 2015; Simonyan & Zisserman,
ICLR 2015), output stride 8.

The vgg16_bn features (3x3 convs with bias, each followed by BN and ReLU;
2x2 max pools) split at pool3 (1/8) and pool4 (1/16) into ``block1``,
``block2`` and ``block3`` (to pool5, 1/32); a head of a 7x7 conv to 4096
channels, BN, ReLU, channel dropout, a 1x1 conv to 4096, BN, ReLU, channel
dropout and a 1x1 score conv; the score is resized (align corners) to the
grid of pool4 and of pool3 in turn and added to each one's 1x1 score.
Module names are the reference torch code's, with torchvision's indices
inside the blocks.

Starting weights, a stand-in for the ImageNet weights the recipe starts
from: He-normal convs (torchvision's VGG init), so that with the frozen
BN at its initial statistics the activations keep their scale through
the 15 ReLU layers (lecun-normal halves their variance at each and the
logits fall to ~0.05); the skip scores normal(0, 0.01), the reference's
init."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (BatchNorm, Conv2d, channel_dropout,
                                        resize_align_corners)

NEW_SCOPES = ("vgg_head", "score_pool4", "score_pool3")
DROP_RATE = 0.1
# torchvision vgg16_bn: (index, channels) of each conv; its BN is at
# index + 1; max pools at 6, 13, 23, 33 and 43
CONVS = ((0, 64), (3, 64), (7, 128), (10, 128), (14, 256), (17, 256),
         (20, 256), (24, 512), (27, 512), (30, 512), (34, 512), (37, 512),
         (40, 512))
POOLS = (6, 13, 23, 33, 43)


def he(cin, k):
    return math.sqrt(2.0 / (cin * k * k))


class Block(nn.Module):
    """The vgg16_bn layers with torchvision index in ``[lo, hi)``."""

    def __init__(self, lo, hi):
        super().__init__()
        self.plan = []
        cin = max([3] + [c for i, c in CONVS if i < lo])
        for i, c in CONVS:
            if lo <= i < hi:
                self.add_module(str(i), Conv2d(cin, c, 3, padding=1,
                                               bias=True, init_std=he(cin, 3)))
                self.add_module(str(i + 1), BatchNorm(c))
                self.plan.append(("conv", i))
                cin = c
        self.plan = sorted(self.plan + [("pool", p) for p in POOLS
                                        if lo <= p < hi],
                           key=lambda s: s[1])

    def forward(self, x, prec, live):
        for kind, i in self.plan:
            if kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(getattr(self, str(i + 1))(
                    getattr(self, str(i))(x, prec), prec, live))
        return x


class Model(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.block1 = Block(0, 24)
        self.block2 = Block(24, 34)
        self.block3 = Block(34, 44)
        self.vgg_head = nn.ModuleDict({
            "0": Conv2d(512, 4096, 7, padding=3, bias=True,
                        init_std=he(512, 7)),
            "1": BatchNorm(4096),
            "4": Conv2d(4096, 4096, 1, bias=True, init_std=he(4096, 1)),
            "5": BatchNorm(4096),
            "8": Conv2d(4096, num_classes, 1, bias=True,
                        init_std=he(4096, 1))})
        self.score_pool4 = Conv2d(512, num_classes, 1, bias=True,
                                  init_std=0.01)
        self.score_pool3 = Conv2d(256, num_classes, 1, bias=True,
                                  init_std=0.01)

    def forward(self, x, prec, live=False, train=False, generator=None,
                upsample=True):
        """NHWC ``x`` -> ``(logits, logits_up)``, NHWC f32; with ``train``
        the head's two channel dropouts draw from ``generator``."""
        h, w = x.shape[1:3]
        pool3 = self.block1(x.to(prec.dtype).permute(0, 3, 1, 2), prec, live)
        pool4 = self.block2(pool3, prec, live)
        pool5 = self.block3(pool4, prec, live)
        head = self.vgg_head
        s = torch.relu(head["1"](head["0"](pool5, prec), prec, live))
        if train:
            s = channel_dropout(s, DROP_RATE, generator)
        s = torch.relu(head["5"](head["4"](s, prec), prec, live))
        if train:
            s = channel_dropout(s, DROP_RATE, generator)
        s = head["8"](s, prec)
        for score, skip in ((self.score_pool4, pool4),
                            (self.score_pool3, pool3)):
            skip = score(skip, prec)
            s = resize_align_corners(s.permute(0, 2, 3, 1),
                                     skip.shape[2:]).permute(0, 3, 1, 2)
            s = s + skip
        logits = s.float().permute(0, 2, 3, 1)
        if not upsample:
            return logits, None
        return logits, resize_align_corners(logits, (h, w))
