"""Optimizer with the reference's 4 learning-rate groups (counterpart of
``dasac_tpu/train/optim.py``; reference models/basenet.py:102-139):
pretrained weights 1x, pretrained biases 2x (no weight decay), from-scratch
weights 10x, from-scratch biases 20x (no decay).

One ``torch.optim.SGD`` or ``torch.optim.Adam`` (``MODEL.OPT``) with four
param groups, in the reference's order, each holding its params in
module-traversal order.  Params under ``new_param_scopes(arch)`` are from
scratch; params named ``bias`` are biases; everything else — conv weights
and BN weights (flax ``scale``) — is in the weight group with decay.

``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))`` equals torch
SGD with ``weight_decay=wd`` and ``momentum``: both add ``wd * p`` to the
gradient, then keep ``buf = g + m * buf`` (starting from ``buf = g``) and
step ``p -= lr * buf``.

``optax.chain(add_decayed_weights(wd), adam(lr, b1=BETA1))`` equals torch
Adam with ``betas=(BETA1, 0.999)``, ``eps=1e-8`` and ``weight_decay=wd``
(coupled L2, not AdamW): both add ``wd * p`` to the gradient before the
moments, keep ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g^2``,
correct both for bias and step ``p -= lr * m_hat / (sqrt(v_hat) + eps)``,
``eps`` outside the square root.

``dasac_tpu`` also takes any other optax name at optax's defaults
(``getattr(optax, name)(lr)``); torch's classes of the same names have
other defaults (rmsprop's decay and where its eps sits, adagrad's initial
accumulator), so the port raises for them (ROADMAP Queue 1 item 15).
"""

import torch

from dasac_tpu_torch.nn.factory import new_param_scopes

GROUPS = ("old_w", "old_b", "new_w", "new_b")
LR_MULT = {"old_w": 1.0, "old_b": 2.0, "new_w": 10.0, "new_b": 20.0}


def param_group_names(model, arch):
    """{group: [param names]} in module-traversal order."""
    scopes = new_param_scopes(arch)
    out = {g: [] for g in GROUPS}
    for name, _ in model.named_parameters():
        is_new = any(name == s or name.startswith(s + ".") for s in scopes)
        is_bias = name.rsplit(".", 1)[-1] == "bias"
        out[("new_" if is_new else "old_") + ("b" if is_bias else "w")].append(
            name)
    return out


def build_optimizer(model_cfg, arch, model):
    """SGD or Adam over the 4 groups from the MODEL config section (``LR``,
    ``WEIGHT_DECAY``, ``OPT``, ``MOMENTUM``, ``OPT_NESTEROV``, ``BETA1``)."""
    kind = model_cfg.OPT.lower()
    if kind not in ("sgd", "adam"):
        raise ValueError(
            "MODEL.OPT={!r}: the port takes SGD and Adam only (optax's other "
            "optimizers by name: ROADMAP Queue 1 item 15)".format(
                model_cfg.OPT))
    params = dict(model.named_parameters())
    groups = []
    for g, names in param_group_names(model, arch).items():
        groups.append(dict(
            params=[params[n] for n in names], name=g,
            lr=model_cfg.LR * LR_MULT[g],
            weight_decay=0.0 if g.endswith("_b") else model_cfg.WEIGHT_DECAY))
    if kind == "adam":
        return torch.optim.Adam(groups, lr=model_cfg.LR,
                                betas=(model_cfg.BETA1, 0.999), eps=1e-8)
    return torch.optim.SGD(groups, lr=model_cfg.LR,
                           momentum=model_cfg.MOMENTUM,
                           nesterov=bool(model_cfg.OPT_NESTEROV))
