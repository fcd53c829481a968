"""Model factory: arch name -> module (counterpart of
``dasac_tpu/nn/factory.py``).

The SAC teacher is not a second module: it is a second set of tensors kept
by the train state (see ``dasac_tpu_torch/core/state.py``).
"""

import torch

from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.nn.layers import Conv2d
from dasac_tpu_torch.nn.resnet import DeepLabV2ResNet101
from dasac_tpu_torch.nn.tiny import TinySeg
from dasac_tpu_torch.nn.vgg import DeepLabV2VGG16, VGG16FCN8s

ARCHS = {
    "deeplabv2_resnet101": DeepLabV2ResNet101,
    "deeplabv2_vgg16_bn": DeepLabV2VGG16,
    "fcn_vgg16_bn": VGG16FCN8s,
    "tiny": TinySeg,  # smoke/test arch, not a reference model
}


def build_model(arch, num_classes, dtype=torch.float32, remat="none",
                device=None, generator=None, group=None, **kwargs):
    """Build ``arch`` with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; default seed 0) and move it to ``device``
    (default CUDA; raises when there is none).  ``group`` (a process
    group) makes every BN's live statistics cross-replica, as
    ``dasac_tpu``'s ``axis_name`` does.  ``kwargs`` go to the model
    (``layers`` for the ResNet, ``drop_rate`` for FCN8s, ``width`` for
    tiny)."""
    key = arch.lower()
    if key not in ARCHS:
        raise ValueError("Unknown arch: {} (have {})".format(
            arch, sorted(ARCHS)))
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ARCHS[key](num_classes=num_classes, dtype=dtype, remat=remat,
                       group=group, **kwargs)
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator=generator)
    return model.to(device)


def new_param_scopes(arch):
    """Module prefixes whose params are 'from scratch' (10x/20x LR), the
    reference's from_scratch registries: the ResNet's ASPP classifier
    (deeplabv2.py:195); VGG DeepLab's fc6, fc7 and classifier
    (deeplabv2.py:278-280); FCN's head and skip scores (fcn.py:78-95)."""
    key = arch.lower()
    if key == "deeplabv2_resnet101":
        return ("model.layer5",)
    if key == "deeplabv2_vgg16_bn":
        return ("features.42", "features.44", "classifier")
    if key == "fcn_vgg16_bn":
        return ("vgg_head", "score_pool4", "score_pool3")
    if key == "tiny":
        return ("aspp",)
    raise ValueError(arch)
