"""The rank side of ``tests/test_torch_optax.py``'s 2-rank gloo world: rank
0 alone resumes an optax rule's snapshot, as the trainer's ``--resume``
does, ``dist.broadcast_state`` hands it to rank 1, and both take one step.
It imports torch and the port only, so a spawned rank starts without
loading JAX; the results leave as a ``torch.save`` file per rank.
"""

import os

import torch

from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train.checkpoints import Checkpointer

ARCH = "tiny"
C = 5
# conv_b's flax kernel is (3, 3, 128, 128): adafactor factors it
WIDTH = 128
WORLD = 2


class MC:
    LR = 5e-4
    WEIGHT_DECAY = 5e-4
    MOMENTUM = 0.9
    OPT_NESTEROV = False
    BETA1 = 0.5


def make_state(name, seed):
    """The tiny model at ``WIDTH`` (weights from ``seed``) with optax's
    ``name`` over the four groups, on the CPU."""
    model = build_model(ARCH, C, width=WIDTH, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    mcfg = type("MC_" + name, (MC,), {"OPT": name})
    return create_train_state(
        model, toptim.build_optimizer(mcfg, ARCH, model), C, device="cpu")


def step(state, seed):
    """One optimizer step on gradients drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()


def _restored(optimizer, saved):
    """Every parameter's state equal to the snapshot's, field by field,
    dtype included."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        got, want = optimizer.state[p], saved[i]
        if set(got) != set(want):
            return False
        for f, t in want.items():
            if got[f].dtype != t.dtype or not torch.equal(got[f].cpu(), t):
                return False
    return True


def resume_main(rank, addr, base, names):
    """One rank: for each of ``names``, a fresh state (other weights than
    the snapshot's), ``base/<name>/last.pth`` read on rank 0 only, the
    broadcast, one step, and the replicas held equal."""
    torch.set_num_threads(1)
    dist.init(dist.Launch(addr, WORLD, rank, rank), torch.device("cpu"))
    out = {}
    try:
        g = dist.group()
        for name in names:
            path = os.path.join(base, name, "last.pth")
            state = make_state(name, seed=1)
            if rank == 0:
                Checkpointer(os.path.dirname(path)).load(path, state)
            dist.broadcast_state(state, "cpu", group=g)
            saved = torch.load(path, weights_only=True)["opt"]["state"]
            row = dict(restored=_restored(state.optimizer, saved))
            step(state, seed=5)
            try:
                row["equal"] = dist.assert_replicas_equal(
                    dist.state_tensors(state, "cpu", group=g), "cpu", g)
            except RuntimeError as e:
                row["equal"] = str(e)
            row["steps"] = sorted({int(st["step"]) for st
                                   in state.optimizer.state.values()})
            out[name] = row
    finally:
        dist.destroy()
    torch.save(out, os.path.join(base, "rank%d.pt" % rank))
