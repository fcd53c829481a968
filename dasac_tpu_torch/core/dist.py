"""Process groups for data-parallel training (counterpart of
``dasac_tpu/core/mesh.py`` and of root ``train.py:20-43``).

One process drives one device, the reference's own model (train.py:489-557,
``mp.spawn`` + ``DistributedDataParallel``) and PyTorch's: the global batch
splits along axis 0 in rank order, parameters, teacher and optimizer state
are the same on every rank, and the steps reduce what ``dasac_tpu``'s
shard_map steps ``pmean``/``psum`` over the ``data`` axis.  The port uses
two collectives only, ``all_reduce`` (always as SUM, then divided where a
mean is wanted) and ``broadcast``: those are the ones whose gloo backend
takes CUDA tensors as well as CPU ones.

With no process group every function here is a no-op that calls nothing
of ``torch.distributed``, so the single-device path is unchanged.

``CALLS`` counts the collectives by kind (``bn``/``bn_grad``: the
cross-replica BN statistics forward and backward), for the smoke's
per-step figures.
"""

import datetime
from typing import NamedTuple

import torch
import torch.distributed as tdist

DEFAULT_PORT = "12355"
# a rank that never reaches a collective ends the others' wait with an
# error after this long (rank 0 alone builds kernels, writes snapshots and
# panels, so the ranks drift apart by minutes at most)
TIMEOUT = datetime.timedelta(minutes=30)

CALLS = {"bn": 0, "bn_grad": 0, "mean": 0, "sum": 0, "broadcast": 0}


class Launch(NamedTuple):
    """The world one process joins: rendezvous ``host:port``, world size,
    this process's rank and its device index on the host."""

    addr: str
    world_size: int
    rank: int
    local_rank: int = 0


def resolve_dist_env(env):
    """``(address, world_size, rank)`` of a launch described by ``env``
    (root ``train.resolve_dist_env``): ``JAX_*`` variables first, then the
    torch convention (``MASTER_ADDR``/``MASTER_PORT`` + ``WORLD_SIZE``/
    ``RANK``, reference train.py:482-551), which counts only as a COMPLETE
    launch, so that a stale ``MASTER_ADDR`` or ``WORLD_SIZE`` alone is
    ignored.  Missing values are ``None``."""
    coord = env.get("JAX_COORDINATOR_ADDRESS")
    torch_style = bool(env.get("MASTER_ADDR") and env.get("WORLD_SIZE")
                       and env.get("RANK"))
    if coord is None and torch_style:
        coord = "{}:{}".format(env["MASTER_ADDR"],
                               env.get("MASTER_PORT", DEFAULT_PORT))
    nproc = env.get("JAX_NUM_PROCESSES",
                    env.get("WORLD_SIZE") if torch_style else None)
    pid = env.get("JAX_PROCESS_ID",
                  env.get("RANK") if torch_style else None)
    return (coord,
            None if nproc is None else int(nproc),
            None if pid is None else int(pid))


def launch_from_env(env):
    """The :class:`Launch` that ``env`` describes (torchrun and the
    reference's recipes set it); ``LOCAL_RANK`` chooses the device.
    Raises ``ValueError`` when the launch is incomplete."""
    coord, world, rank = resolve_dist_env(env)
    if coord is None or world is None or rank is None:
        raise ValueError(
            "--multiprocessing-distributed joins a world described by the "
            "environment: set MASTER_ADDR, WORLD_SIZE and RANK (and "
            "MASTER_PORT, LOCAL_RANK), as torchrun does")
    return Launch(coord, world, rank, int(env.get("LOCAL_RANK", 0)))


def init(launch, device, backend=None):
    """Join ``launch``'s world: NCCL on CUDA, gloo on the CPU unless
    ``backend`` names one (tests and the smoke run gloo on CUDA
    tensors)."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    tdist.init_process_group(
        backend, init_method="tcp://" + launch.addr,
        world_size=launch.world_size, rank=launch.rank, timeout=TIMEOUT)


def destroy():
    if initialized():
        tdist.destroy_process_group()


def initialized():
    return tdist.is_available() and tdist.is_initialized()


def group():
    """The world's group, or ``None`` without one (no collective then)."""
    return tdist.group.WORLD if initialized() else None


def world_size():
    return tdist.get_world_size() if initialized() else 1


def rank():
    return tdist.get_rank() if initialized() else 0


def is_main():
    return rank() == 0


def _bucketed(tensors, collective):
    """Run ``collective(flat)`` on one flat copy of ``tensors`` per dtype
    and copy the result back in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def all_reduce_sum_(tensors, group=None):
    """Sum ``tensors`` over the ranks of ``group``, in place (``psum``)."""
    if group is None:
        return
    CALLS["sum"] += 1
    _bucketed(tensors, lambda flat: tdist.all_reduce(flat, group=group))


def all_reduce_mean_(tensors, group=None):
    """Average ``tensors`` over the ranks of ``group``, in place, as one
    SUM then a division by the world size (``pmean``)."""
    if group is None:
        return
    n = tdist.get_world_size(group)
    CALLS["mean"] += 1

    def mean(flat):
        tdist.all_reduce(flat, group=group)
        flat.div_(n)

    _bucketed(tensors, mean)


class AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x``; its backward sums the incoming
    gradients over the ranks as well.  Divided by the world size, this is
    the cotangent JAX gives ``pmean`` inside ``shard_map(check_vma=False)``:
    each rank's input gradient is the SUM over ranks of the gradient
    reaching the mean, over the world size."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        CALLS["bn"] += 1
        y = x.clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        CALLS["bn_grad"] += 1
        g = grad.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


def broadcast_(tensors, src=0, group=None):
    """Overwrite ``tensors`` with rank ``src``'s, in place."""
    if group is None:
        return
    CALLS["broadcast"] += 1
    _bucketed(tensors, lambda flat: tdist.broadcast(flat, src, group=group))


def broadcast_values(values, device, src=0, group=None):
    """Rank ``src``'s Python numbers (float64 on the wire)."""
    if group is None:
        return list(values)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    broadcast_([t], src, group)
    return t.tolist()


def _momentum(optimizer, device, src, group):
    """The SGD momentum buffers, made to exist on every rank exactly where
    they exist on rank ``src`` (a rank that loaded no snapshot has none)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    has = torch.tensor([optimizer.state.get(p, {}).get("momentum_buffer")
                        is not None for p in params], dtype=torch.uint8,
                       device=device)
    broadcast_([has], src, group)
    out = []
    for p, h in zip(params, has.tolist()):
        st = optimizer.state[p]
        if h:
            if st.get("momentum_buffer") is None:
                st["momentum_buffer"] = torch.zeros_like(p)
            out.append(st["momentum_buffer"])
        else:
            st.pop("momentum_buffer", None)
    return out


def state_tensors(state, device, src=0, group=None):
    """Every tensor of a train state that must be equal on all ranks:
    parameters, buffers, teacher, ``running_conf`` and the momentum."""
    tensors = ([p.data for p in state.model.parameters()]
               + list(state.model.buffers())
               + list(state.teacher_params.values())
               + list(state.teacher_stats.values()) + [state.running_conf])
    if state.optimizer is not None:
        tensors += _momentum(state.optimizer, device, src, group)
    return tensors


def broadcast_state(state, device, src=0, group=None):
    """Make every rank's train state rank ``src``'s, bit for bit (after a
    resume that only rank ``src`` read), ``step`` and ``slow_init``
    included."""
    if group is None:
        return
    with torch.no_grad():
        broadcast_(state_tensors(state, device, src, group), src, group)
    state.slow_init, state.step = (int(v) for v in broadcast_values(
        (state.slow_init, state.step), device, src, group))


def assert_replicas_equal(tensors, device, group=None):
    """Raise on every rank unless ``tensors`` are bit-equal to rank 0's
    (data-parallel ranks must never drift apart); returns how many
    tensors were held."""
    if group is None:
        return 0
    with torch.no_grad():
        ref = [t.clone() for t in tensors]
        broadcast_(ref, 0, group)
        bad = torch.tensor(
            [sum(not torch.equal(a, b) for a, b in zip(ref, tensors))],
            dtype=torch.int64, device=device)
    all_reduce_sum_([bad], group)
    if int(bad):
        raise RuntimeError("%d tensors differ between the ranks" % int(bad))
    return len(tensors)


def barrier(device, group=None):
    """Wait on the host until every rank is here (one all_reduce)."""
    if group is None:
        return
    t = torch.zeros(1, device=device)
    tdist.all_reduce(t, group=group)
    t.item()


def auto_mesh_size(available, batch_size, num_groups):
    """The largest device count up to ``available`` that divides both
    batch dimensions (a copy of ``dasac_tpu/train/loop.py:545-551``)."""
    n = min(available, batch_size, num_groups)
    while n > 1 and (batch_size % n or num_groups % n):
        n -= 1
    return max(1, n)
