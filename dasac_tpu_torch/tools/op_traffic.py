"""Where the SAC step's memory traffic goes, by op: the counterpart of
``dasac_tpu/tools/hlo_traffic.py``'s purpose.

The JAX tool ranks the compiled step's HLO instructions by output-buffer
size.  The port has no HLO: it runs eager ops, and each op's output is a
write to device memory.  So a ``TorchDispatchMode`` records every aten op
of one flagship step (both forwards, both backwards with whatever remat
replays, the optimizer): the bytes of its outputs as writes, the bytes of
its tensor inputs as reads, summed by op.  A view writes and reads
nothing; an in-place op writes the tensors it mutates; an allocation
(``empty*``) writes nothing itself (the op or kernel that fills it does).
The CUDA CE kernels are launched through ``ctypes``, out of the
dispatcher's sight: their reads and writes are added as their own rows.

What differs from the JAX tool: eager PyTorch fuses nothing, so every
intermediate is written and read back, inputs read by a kernel more than
once (an expanded operand, a conv's halo) count once per op, and no cache
is credited: the totals bound the step's device traffic from above.  A
row shows where an elementwise chain moves its bytes; ``--remat convs``
shows what saving only conv outputs drops, and what replaying adds.

It prints one JSON line with the top ``--top`` ops by bytes written (calls,
GB written and read), the totals, the written bytes by dtype, and the
card's name and power limit.  The step is ``tools/flagship.py``'s, one
warm-up step, then the recorded one.

    python -m dasac_tpu_torch.tools.op_traffic [--remat convs] [--top 15]
"""

import argparse
import contextlib
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.ops import ce
from dasac_tpu_torch.tools import flagship
from dasac_tpu_torch.train import steps

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _nbytes(x):
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _dtype_bytes(x):
    out = {}
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor):
            key = str(t.dtype).replace("torch.", "")
            out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


class Traffic(TorchDispatchMode):
    """Bytes read and written by every aten op run while the mode is
    active (``with Traffic() as t:``), in ``t.ops``: op -> ``{"calls",
    "read", "written"}``; ``t.written_by_dtype``: dtype -> bytes."""

    def __init__(self):
        super().__init__()
        self.ops = {}
        self.written_by_dtype = {}

    def add(self, name, read, written):
        """Count one call of ``name``: ``read`` bytes, ``written`` a
        ``{dtype: bytes}``."""
        row = self.ops.setdefault(name, {"calls": 0, "read": 0,
                                         "written": 0})
        row["calls"] += 1
        row["read"] += read
        for dt, b in written.items():
            row["written"] += b
            self.written_by_dtype[dt] = self.written_by_dtype.get(dt, 0) + b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        name = str(func.overloadpacket)
        if (schema.returns and all(r.alias_info is not None
                                   and not r.alias_info.is_write
                                   for r in schema.returns)):
            return out   # a view
        if func.overloadpacket.__name__ in _ALLOCATIONS:
            self.add(name, 0, {})
            return out
        # the tensors it mutates (``Tensor(a!)``), by position or name
        values = dict(zip((a.name for a in schema.arguments), args))
        values.update(kwargs)
        mutated = [values[a.name] for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write
                   and a.name in values]
        fresh = [o for o, r in zip(
            out if isinstance(out, (tuple, list)) else (out,),
            schema.returns) if r.alias_info is None]
        written = _dtype_bytes(mutated)
        for dt, b in _dtype_bytes(fresh).items():
            written[dt] = written.get(dt, 0) + b
        self.add(name, _nbytes((args, kwargs)), written)
        return out

    def totals(self):
        return (sum(r["read"] for r in self.ops.values()),
                sum(r["written"] for r in self.ops.values()))


@contextlib.contextmanager
def _count_ce_kernels(traffic):
    """Add the CUDA CE kernels' bytes to ``traffic`` while active."""
    fwd, bwd = ce._launch_fwd, ce._launch_bwd

    def launch_fwd(x2, lbl):
        out = fwd(x2, lbl)
        traffic.add("ce.nll_fwd (CUDA kernel)", _nbytes((x2, lbl)),
                    _dtype_bytes(out))
        return out

    def launch_bwd(x2, lbl, g):
        out = bwd(x2, lbl, g)
        traffic.add("ce.nll_bwd (CUDA kernel)", _nbytes((x2, lbl, g)),
                    _dtype_bytes(out))
        return out

    ce._launch_fwd, ce._launch_bwd = launch_fwd, launch_bwd
    try:
        yield
    finally:
        ce._launch_fwd, ce._launch_bwd = fwd, bwd


def record(fn):
    """Run ``fn()`` under a :class:`Traffic` (the CE kernels counted too);
    returns the ``Traffic``."""
    traffic = Traffic()
    with _count_ce_kernels(traffic), traffic:
        fn()
    return traffic


def report(traffic, top):
    """The JSON record: the ``top`` ops by bytes written, the totals and
    the written bytes by dtype."""
    read, written = traffic.totals()
    rows = sorted(traffic.ops.items(), key=lambda kv: -kv[1]["written"])
    return dict(
        top=[dict(op=k, calls=r["calls"], written_gb=r["written"] / 1e9,
                  read_gb=r["read"] / 1e9,
                  written_share=r["written"] / max(written, 1))
             for k, r in rows[:top]],
        total_read_gb=read / 1e9, total_written_gb=written / 1e9,
        written_gb_by_dtype={k: v / 1e9 for k, v in sorted(
            traffic.written_by_dtype.items(), key=lambda kv: -kv[1])},
        ops=len(traffic.ops),
        calls=sum(r["calls"] for r in traffic.ops.values()))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    flagship.add_step_args(ap)
    ap.add_argument("--remat", choices=["none", "block", "convs"],
                    default="none")
    ap.add_argument("--top", type=int, default=15)
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Print and return the record of one step; ``device`` defaults to
    CUDA (raises when there is none)."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    state = flagship.build_state(args, device, remat=args.remat)
    step = steps.make_sac_step(flagship.step_config(args), device=device)
    batch = flagship.random_batch(args, device, np.random.RandomState(0))
    gen = torch.Generator(device=device).manual_seed(0)
    step(state, batch, gen)   # warm-up: lazy init, cuDNN's choices
    if device.type == "cuda":
        torch.cuda.synchronize()
    traffic = record(lambda: step(state, batch, gen))
    out = dict(report(traffic, args.top), remat=args.remat,
               card=flagship.device_label(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
