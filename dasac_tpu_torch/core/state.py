"""Train state: all mutable algorithm state in one object (counterpart of
``dasac_tpu/core/state.py``).

  * model              — the student ``nn.Module`` (params + BN buffers)
  * optimizer          — its optimizer over the 4 LR groups (``MODEL.OPT``;
    None for inference); :func:`optimizer_fields` gives its per-parameter
    state
  * teacher_params / teacher_stats — the EMA teacher's tensors, keyed like
    the student's parameters / float buffers
  * running_conf [C]   — moving class prior (a tensor on the device)
  * slow_init          — teacher lazy-init flag (Python int 0/1)
  * step               — global iteration counter (Python int)

``slow_init`` and ``step`` stay on the host: the step decides the teacher
branch from them without reading the device.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from dasac_tpu_torch.core.device import resolve_device


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    teacher_params: Dict[str, torch.Tensor]
    teacher_stats: Dict[str, torch.Tensor]
    running_conf: torch.Tensor
    slow_init: int = 0
    step: int = 0

    def student_params(self):
        return dict(self.model.named_parameters())

    def student_stats(self):
        return {k: v for k, v in self.model.named_buffers()
                if v.is_floating_point()}


def create_train_state(model, optimizer, num_classes, device=None):
    """Move ``model`` to ``device`` (default CUDA; raises when there is none)
    and start the state.  The teacher starts as a copy of the student (the
    first teacher update overwrites it wholesale anyway, sac.py:74-81).
    ``optimizer=None`` makes a state for inference, which no step takes."""
    device = resolve_device(device)
    model.to(device)
    if optimizer is not None and (
            {id(p) for g in optimizer.param_groups for p in g["params"]}
            != {id(p) for p in model.parameters()}):
        raise ValueError("the optimizer must hold exactly the model's "
                         "parameters")
    state = TrainState(model=model, optimizer=optimizer,
                       teacher_params={}, teacher_stats={},
                       running_conf=torch.zeros(num_classes, device=device))
    with torch.no_grad():
        state.teacher_params = {k: v.detach().clone()
                                for k, v in state.student_params().items()}
        state.teacher_stats = {k: v.detach().clone()
                               for k, v in state.student_stats().items()}
    return state


# the field of an optimizer's per-parameter state that counts its steps
# (torch Adam's float32, an optax rule's int32), a host scalar
COUNT = "step"


def optimizer_fields(optimizer, p, group):
    """The per-parameter state fields of ``optimizer``'s kind for ``p`` in
    ``group``, each a tensor of its shape and dtype, on the meta device
    where it lives on the parameter's (``COUNT`` on the host): an optax
    rule's (``init_state``), torch Adam's or torch SGD's."""
    p = p.detach().to("meta")
    init = getattr(optimizer, "init_state", None)
    if init is not None:
        return init(p, group)
    if isinstance(optimizer, torch.optim.Adam):
        return {"exp_avg": p, "exp_avg_sq": p,
                COUNT: torch.zeros((), dtype=torch.float32)}
    if isinstance(optimizer, torch.optim.SGD):
        return {"momentum_buffer": p}
    raise ValueError("no state layout for %s" % type(optimizer).__name__)
