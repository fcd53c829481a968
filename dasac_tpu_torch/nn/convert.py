"""Weight carry-across from the flax variables of ``dasac_tpu`` to the
port's modules.

Input: the flax ``{"params", "batch_stats"}`` tree as nested dicts of numpy
arrays.  Output: a ``state_dict`` with the reference torch keys the port's
modules use.  Conv ``kernel`` HWIO becomes ``weight`` OIHW; BN ``scale`` /
``bias`` / ``mean`` / ``var`` become ``weight`` / ``bias`` /
``running_mean`` / ``running_var`` (plus ``num_batches_tracked = 0``).  The
converter walks whatever blocks the tree holds, so shallow trunks convert
too.  The key maps are this package's own copies of the ones in
``dasac_tpu/nn/convert.py`` (``_resnet_map``, ``_vgg_deeplab_map``,
``_fcn_map``).

:func:`load_torchvision_backbone` loads a torchvision ImageNet backbone
(``MODEL.INIT_MODEL``: ``resnet101`` or ``vgg16_bn``) into the port's
trunk.
"""

import re

import numpy as np
import torch

_LEAVES = {
    "kernel": "weight",
    "bias": "bias",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
}
_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


# DeepLabv2/VGG-16: the flax scopes outside ``features``
# (models/deeplabv2.py:253-267: fc6/fc7 appended to the renumbered
# features at 42 and 44, ASPP as ``classifier``)
_VGG_DEEPLAB_HEAD = {"fc6": "features.42", "fc7": "features.44"}
# FCN8s/VGG-16 (models/fcn.py:26-95): ``vgg_head`` Sequential 0 conv 7x7,
# 1 bn, 4 conv 1x1, 5 bn, 8 conv 1x1; the skip scores keep their names
_FCN_HEAD = {"head_fc6": "vgg_head.0", "head_bn6": "vgg_head.1",
             "head_fc7": "vgg_head.4", "head_bn7": "vgg_head.5",
             "head_score": "vgg_head.8", "score_pool4": "score_pool4",
             "score_pool3": "score_pool3"}


def _vgg_index(path_part):
    return int(re.fullmatch(r"features_(\d+)", path_part).group(1))


def _deeplab_vgg_shift(i):
    """torchvision feature index -> the reference DeepLab's (pool 33 gone:
    the indices above it shift down by one)."""
    return i - 1 if i > 33 else i


def _module_key(arch, path):
    """flax module path (tuple of scope names) -> torch module prefix."""
    if arch == "tiny":
        return ".".join(path)
    if arch == "deeplabv2_vgg16_bn":
        if path[0] == "features":
            return "features.%d" % _deeplab_vgg_shift(_vgg_index(path[1]))
        if path[0] == "aspp":
            return "classifier.conv2d_list." + path[1][len("conv"):]
        return _VGG_DEEPLAB_HEAD[path[0]]
    if arch == "fcn_vgg16_bn":
        if path[0] in ("block1", "block2", "block3"):
            return "%s.%d" % (path[0], _vgg_index(path[1]))
        return _FCN_HEAD[path[0]]
    if arch != "deeplabv2_resnet101":
        raise ValueError(arch)
    if path[0] == "aspp":
        return "model.layer5.conv2d_list." + path[1][len("conv"):]
    if path[0] != "backbone":
        raise KeyError(path)
    if len(path) == 2:                      # stem conv1 / bn1
        return "model." + path[1]
    li, bi = re.fullmatch(r"layer(\d+)_(\d+)", path[1]).groups()
    return "model.layer{}.{}.{}".format(li, bi, _DOWNSAMPLE.get(path[2], path[2]))


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables_np, arch):
    """flax variables (nested dicts of numpy arrays) -> torch state_dict."""
    arch = arch.lower()
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables_np.get(coll, {})):
            mod = _module_key(arch, path[:-1])
            arr = np.asarray(arr, np.float32)
            if path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            sd[mod + "." + _LEAVES[path[-1]]] = torch.from_numpy(
                np.array(arr, order="C"))  # a writable contiguous copy
            if path[-1] == "scale":
                sd[mod + ".num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
    return sd


def train_state_from_jax(jax_state, arch, state):
    """Load a ``dasac_tpu`` TrainState (its fields as nested dicts of numpy
    arrays: ``params``, ``batch_stats``, ``teacher_params``,
    ``teacher_stats``, ``running_conf``, ``slow_init``, ``step``) into the
    port's ``state`` in place: student weights, teacher tensors, class
    prior, lazy-init flag and step counter.  Returns ``state``."""
    state.model.load_state_dict(from_jax_variables(
        {"params": jax_state["params"],
         "batch_stats": jax_state["batch_stats"]}, arch), strict=True)
    teacher = from_jax_variables(
        {"params": jax_state["teacher_params"],
         "batch_stats": jax_state["teacher_stats"]}, arch)
    with torch.no_grad():
        for store in (state.teacher_params, state.teacher_stats):
            for name, t in store.items():
                t.copy_(teacher[name])
        state.running_conf.copy_(torch.from_numpy(
            np.asarray(jax_state["running_conf"], np.float32)))
    state.slow_init = int(np.asarray(jax_state["slow_init"]) > 0)
    state.step = int(np.asarray(jax_state["step"]))
    return state


# torchvision resnet101 trunk keys, as dasac_tpu/nn/convert.py maps them
# ("torchvision" style): no conv biases, the ImageNet classifier (fc.*) has
# no counterpart
_TV_PARTS = r"(?:weight|bias|running_mean|running_var)"
_TV_RESNET_KEY = re.compile(
    r"^(?:conv1\.weight|bn1\.{p}"
    r"|layer[1-4]\.\d+\.(?:conv[123]\.weight|bn[123]\.{p}"
    r"|downsample\.0\.weight|downsample\.1\.{p}))$".format(p=_TV_PARTS))
# torchvision vgg16_bn feature keys; the ImageNet classifier (classifier.*)
# has no counterpart
_TV_VGG_KEY = re.compile(r"^features\.(\d+)\.({p})$".format(p=_TV_PARTS))


def _fcn_block(i):
    return "block1" if i < 24 else ("block2" if i < 34 else "block3")


def _torchvision_name(arch, key):
    """The port's parameter name of torchvision key ``key``, or None."""
    if arch == "deeplabv2_resnet101":
        return "model." + key if _TV_RESNET_KEY.match(key) else None
    m = _TV_VGG_KEY.match(key)
    if m is None:
        return None
    i, part = int(m.group(1)), m.group(2)
    if arch == "deeplabv2_vgg16_bn":
        return "features.%d.%s" % (_deeplab_vgg_shift(i), part)
    return "%s.%d.%s" % (_fcn_block(i), i, part)


_TORCHVISION = {"deeplabv2_resnet101": "resnet101",
                "deeplabv2_vgg16_bn": "vgg16_bn", "fcn_vgg16_bn": "vgg16_bn"}


def load_torchvision_backbone(model, state_dict, arch):
    """Copy a torchvision ImageNet ``state_dict`` into ``model``'s trunk in
    place, with ``strict=False`` semantics: the counterpart of
    ``dasac_tpu``'s ``apply_state_dict(variables, sd, arch,
    "torchvision")``.  ``resnet101`` keys (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ...) go to the ResNet, ``vgg16_bn`` keys
    (``features.<i>.*``) to either VGG arch under its own names.

    ``num_batches_tracked`` entries are passed over; keys with no
    counterpart in ``model`` (``fc.*``, ``classifier.*``, blocks a
    shallower trunk lacks) are skipped and listed.  A shape mismatch
    raises.  Returns ``(n_loaded, skipped)``."""
    arch = arch.lower()
    if arch not in _TORCHVISION:
        raise ValueError("no torchvision key map for arch %r" % arch)
    own = model.state_dict()
    n_loaded, skipped = 0, []
    with torch.no_grad():
        for key, val in state_dict.items():
            if key.endswith("num_batches_tracked"):
                continue
            name = _torchvision_name(arch, key)
            if name is None or name not in own:
                skipped.append(key)
                continue
            val = (val.detach().float().cpu() if isinstance(val, torch.Tensor)
                   else torch.from_numpy(np.array(val, np.float32)))
            if tuple(own[name].shape) != tuple(val.shape):
                raise ValueError("Shape mismatch at {}: {} vs {}".format(
                    key, tuple(own[name].shape), tuple(val.shape)))
            own[name].copy_(val)
            n_loaded += 1
    return n_loaded, skipped
