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

Every other optimizer that ``dasac_tpu`` trains with by name
(``getattr(optax, name)(lr)`` at optax's defaults, chained after the
group's ``add_decayed_weights``) is :class:`optax_rules.OptaxRule` with
that name: the 26 of :data:`optax_rules.NAMES`.  Any other name raises
at build time, and the message says why optax's other names do not
train in ``dasac_tpu`` either: ``lbfgs`` and ``polyak_sgd`` need the loss
at every update, which its step does not pass, and the rest are gradient
transformations (chained as an optimizer, ``optax.apply_updates`` adds
``+lr * g`` or the like: ``MODEL.OPT scale`` climbs the loss).

Each param group carries ``opt``, the ``MODEL.OPT`` name in lower case;
the snapshot's ``opt`` keeps it (``train/checkpoints.py``).
"""

import torch

from dasac_tpu_torch.nn.factory import new_param_scopes
from dasac_tpu_torch.train import optax_rules

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


def _check_name(opt):
    """``MODEL.OPT`` in lower case; raises for a name the port does not
    train with, saying why."""
    kind = opt.lower()
    if kind in ("sgd", "adam") or kind in optax_rules.RULES:
        return kind
    raise ValueError(
        "MODEL.OPT={!r}: the port trains with sgd, adam and {}.  optax's "
        "other names that take a learning rate do not train in dasac_tpu "
        "either: lbfgs and polyak_sgd need the loss (value=, grad=) at "
        "every update, which the train step does not pass, so the first "
        "step raises; the rest are gradient transformations, not "
        "optimizers, which do not step against the gradient (MODEL.OPT "
        "scale climbs the loss)".format(opt, ", ".join(optax_rules.NAMES)))


def build_optimizer(model_cfg, arch, model, seed=0):
    """The optimizer of ``MODEL.OPT`` over the 4 groups from the MODEL
    config section (``LR``, ``WEIGHT_DECAY``, ``OPT``, ``MOMENTUM``,
    ``OPT_NESTEROV``, ``BETA1``): torch's SGD or Adam, or optax's rule of
    that name.  ``seed``: ``noisy_sgd``'s draws (``--seed``; the same on
    every rank)."""
    kind = _check_name(model_cfg.OPT)
    params = dict(model.named_parameters())
    groups = []
    for g, names in param_group_names(model, arch).items():
        groups.append(dict(
            params=[params[n] for n in names], name=g, opt=kind,
            lr=model_cfg.LR * LR_MULT[g],
            weight_decay=0.0 if g.endswith("_b") else model_cfg.WEIGHT_DECAY))
    if kind == "adam":
        return torch.optim.Adam(groups, lr=model_cfg.LR,
                                betas=(model_cfg.BETA1, 0.999), eps=1e-8)
    if kind == "sgd":
        return torch.optim.SGD(groups, lr=model_cfg.LR,
                               momentum=model_cfg.MOMENTUM,
                               nesterov=bool(model_cfg.OPT_NESTEROV))
    return optax_rules.OptaxRule(groups, kind, seed=seed)
