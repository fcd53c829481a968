"""Checkpoints in the reference's ``.pth`` snapshot container (counterpart of
``dasac_tpu/train/checkpoints.py``).

A snapshot is ``{"model", "opt", "score", "epoch"}`` written with
``torch.save`` (reference utils/checkpoints.py:68-71).  ``model`` holds
the keys the reference's DDP-wrapped SAC module has (models/sac.py:41-63),
as ``dasac_tpu/tools/export_torch.py`` writes them:

  * ``module.backbone.*``  the student's parameters and buffers;
  * ``module.slow_net.*``  the EMA teacher, written only once the teacher
    has been initialized (``slow_init``); an ABN snapshot has none;
  * ``module.running_conf`` [C] and ``module.slow_init`` (float, [1]).

``opt`` is the optimizer's ``state_dict()`` (``MODEL.OPT``: torch's SGD
or Adam, or one of optax's rules, ``train/optax_rules.py``): parameter ids
are positional over the four LR groups in the reference's order
(``train/optim.py``), and each group carries ``opt``, the ``MODEL.OPT``
name.  The content
is tensors, dicts, lists, strings and numbers, so
``torch.load(weights_only=True)`` reads it, and ``dasac_tpu``'s own
``Checkpointer.load`` takes it (a ``.pth`` goes to its torch reader).

The best snapshots are named ``epoch{E:03d}_score{S:4.3f}.pth`` (the top
``max_n`` kept) and the rolling one ``last.pth``; every file is written to
a temporary name and moved into place with ``os.replace``.  The port does
not read ``dasac_tpu``'s flax ``.ckpt`` files (msgpack, which the port's
machines do not have); convert them with
``python -m dasac_tpu.tools.export_torch``.
"""

import os

import torch

from dasac_tpu_torch.core.state import COUNT, optimizer_fields
from dasac_tpu_torch.train.optax_rules import OptaxRule

BACKBONE = "module.backbone."
TEACHER = "module.slow_net."


def _snapshot(state, score, epoch):
    """The train state as the reference's snapshot container (CPU
    tensors)."""
    model = {BACKBONE + k: v.detach().cpu()
             for k, v in state.model.state_dict().items()}
    if state.slow_init:
        teacher = {**state.teacher_params, **state.teacher_stats}
        for k, v in state.model.state_dict().items():
            # the teacher keeps float tensors only; the reference module's
            # BN step counters go in as zeros, as export_torch writes them
            src = teacher[k] if k in teacher else torch.zeros_like(v)
            model[TEACHER + k] = src.detach().cpu()
    model["module.running_conf"] = state.running_conf.detach().float().cpu()
    model["module.slow_init"] = torch.tensor([float(state.slow_init)])
    return {"model": model, "opt": _cpu(state.optimizer.state_dict()),
            "score": float(score), "epoch": int(epoch)}


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cpu(v) for v in obj]
    return obj


def _write(payload, fn):
    tmp = fn + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, fn)
    return fn


class Checkpointer:
    def __init__(self, path, max_n=3):
        self.path = path
        self.max_n = max_n
        self.kept = []
        if path:
            os.makedirs(path, exist_ok=True)

    def _file(self, name):
        return os.path.join(self.path, name + ".pth")

    def save(self, state, score, epoch):
        """Write ``epoch{E:03d}_score{S:4.3f}.pth`` and drop the oldest
        files beyond ``max_n``.  Returns the path."""
        name = "epoch{:03d}_score{:4.3f}".format(epoch, score)
        fn = self._file(name)
        if not os.path.isfile(fn):
            _write(_snapshot(state, score, epoch), fn)
        self.kept.append(name)
        n_rm = max(0, len(self.kept) - self.max_n)
        for old in self.kept[:n_rm]:
            if os.path.isfile(self._file(old)):
                os.remove(self._file(old))
        self.kept = self.kept[n_rm:]
        return fn

    def save_latest(self, state, score, epoch):
        """The rolling snapshot ``last.pth``."""
        return _write(_snapshot(state, score, epoch), self._file("last"))

    def latest_path(self):
        fn = self._file("last")
        return fn if os.path.isfile(fn) else None

    def load(self, path, state):
        """Load a reference-format snapshot into ``state`` in place; returns
        ``(state, epoch, score)``.

        The student loads with ``strict=True``.  The teacher loads when the
        file has one; otherwise (an ABN snapshot) the teacher tensors stay
        as they are and ``slow_init`` becomes 0, so the first SAC step
        copies the student (reference sac.py:74-81).  Only the optimizer's
        per-parameter state is taken from ``opt`` (SGD's momentum, Adam's
        moments and step, an optax rule's every field): the learning rates
        and weight decay stay the optimizer's own (an ABN snapshot's would
        otherwise replace the SAC stage's); a state without an optimizer
        (inference) reads no ``opt``.  A file that is a bare ``state_dict``
        loads as the student."""
        data = torch.load(path, map_location="cpu", weights_only=True)
        model_sd = data.get("model", data)
        student, teacher, extras = {}, {}, {}
        for k, v in model_sd.items():
            k = k[len("module."):] if k.startswith("module.") else k
            if k.startswith("backbone."):
                student[k[len("backbone."):]] = v
            elif k.startswith("slow_net."):
                teacher[k[len("slow_net."):]] = v
            else:
                extras[k] = v
        if not student:
            student, extras = dict(model_sd), {}
        state.model.load_state_dict(student, strict=True)
        with torch.no_grad():
            if teacher:
                for store in (state.teacher_params, state.teacher_stats):
                    for name, t in store.items():
                        t.copy_(teacher[name])
            if "running_conf" in extras:
                state.running_conf.copy_(extras["running_conf"])
        state.slow_init = int(bool(teacher)
                              and float(extras.get("slow_init", 0)) > 0)
        opt = data.get("opt") if "model" in data else None
        if opt and state.optimizer is not None:
            _load_optimizer_state(state.optimizer, opt)
        return state, int(data.get("epoch", 0)), float(
            data.get("score", -1e16))


# torch's optimizers by MODEL.OPT name
_TORCH = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}
# a snapshot whose groups carry no ``opt`` name (the reference's SGD, the
# port's before optax's rules): its kind by the key its groups carry
_UNNAMED = (("momentum", "sgd"), ("betas", "adam"))


def _saved_kind(groups):
    names = {g.get("opt") for g in groups}
    if names != {None}:
        if len(names) != 1:
            raise ValueError("snapshot param groups of several optimizers: "
                             "%s" % sorted(map(str, names)))
        return names.pop()
    for key, kind in _UNNAMED:
        if all(key in g for g in groups):
            return kind
    raise ValueError("snapshot optimizer of unknown kind (param-group keys "
                     "%s)" % sorted(groups[0]))


def _kind(optimizer):
    if isinstance(optimizer, OptaxRule):
        return optimizer.name
    for kind, cls in _TORCH.items():
        if type(optimizer) is cls:
            return kind
    raise ValueError("no snapshot format for %s" % type(optimizer).__name__)


def _load_optimizer_state(optimizer, opt_dict):
    """Copy the per-parameter state that ``opt_dict`` (a ``state_dict()``)
    holds into ``optimizer``, matching parameters by position within the
    param groups: SGD's ``momentum_buffer``; Adam's ``exp_avg``,
    ``exp_avg_sq`` and ``step``; an optax rule's every field, its ``step``
    included.  Raises where the optimizer kinds (``MODEL.OPT``), the group
    sizes, a rule's fields or a tensor's shape disagree."""
    groups = opt_dict.get("param_groups", [])
    st = opt_dict.get("state", {})
    if len(groups) != len(optimizer.param_groups):
        raise ValueError("snapshot has %d param groups, the optimizer %d"
                         % (len(groups), len(optimizer.param_groups)))
    saved, mine = _saved_kind(groups), _kind(optimizer)
    if saved != mine:
        raise ValueError("snapshot holds %s state, the trainer's optimizer "
                         "is %s (MODEL.OPT)" % (saved, mine))
    for sg, group in zip(groups, optimizer.param_groups):
        if len(sg["params"]) != len(group["params"]):
            raise ValueError("param-group size mismatch: %d saved vs %d"
                             % (len(sg["params"]), len(group["params"])))
        for pid, p in zip(sg["params"], group["params"]):
            entry = st.get(pid, {})
            if all(v is None for v in entry.values()):
                continue  # no state yet (SGD without momentum keeps None)
            want = optimizer_fields(optimizer, p, group)
            if set(entry) != set(want):
                raise ValueError("%s state fields %s, want %s" % (
                    mine, sorted(entry), sorted(want)))
            for f, like in want.items():
                t = entry[f]
                if f == COUNT:  # a scalar count, kept on the host
                    optimizer.state[p][f] = t.detach().clone()
                    continue
                if tuple(t.shape) != tuple(like.shape):
                    raise ValueError("%s shape mismatch: %s vs %s"
                                     % (f, tuple(t.shape), tuple(like.shape)))
                optimizer.state[p][f] = t.to(p.device, like.dtype, copy=True)


class BestTracker:
    """checkpoint_best logic (reference base_trainer.py:37-45)."""

    def __init__(self, checkpointer, best=-1e16):
        self.checkpointer = checkpointer
        self.best = best

    def update(self, state, score, epoch):
        if score > self.best:
            self.best = score
            return self.checkpointer.save(state, score, epoch)
        return None
