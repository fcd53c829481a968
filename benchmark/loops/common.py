"""What the loops share: the port's configuration from the cell's keys,
the program's model holding the benchmark's weights, the reference's
weights, the device, and the plain count."""

import dataclasses
import gc

import torch

from benchmark import counts, inputs, peaks
from benchmark.reference import steps as ref_steps

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Ctx:
    cell: object            # harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float               # the process's start, perf_counter
    keys: dict              # harness.cfg_keys(cell)
    program_dtype: str = None   # None: the configuration's (tests: f32)
    model_kw: dict = dataclasses.field(default_factory=dict)  # tests: depth

    @property
    def arch(self):
        return self.keys["MODEL.ARCH"]

    @property
    def num_classes(self):
        return self.cell.config["num_classes"]


def port_cfg(ctx):
    """The port's global config reset to its defaults and given the
    cell's keys, checked against the precision the configuration states
    (a run that departs from it is no sound run)."""
    from dasac_tpu_torch.core import config

    config.reset_cfg()
    flat = []
    for k, v in ctx.keys.items():
        flat += [k, repr(v) if not isinstance(v, str) else v]
    config.merge_cfg_from_list(flat)
    cfg = config.cfg
    stated = ctx.cell.config["precision"]
    for key, want in stated.items():
        have = cfg.TPU[key]
        if have != want:
            raise SystemExit("the port runs TPU.%s=%s, the configuration "
                             "states %s" % (key, have, want))
    return cfg


def reference_weights(ctx, device=None):
    """The starting state dict drawn from the seed, in the reference
    model's entry order."""
    device = device or ctx.device
    spec = ref_steps.init_specs(ctx.arch, ctx.num_classes, **ctx.model_kw)
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in
                  ref_steps.load_arch(ctx.arch).Model(
                      ctx.num_classes, **ctx.model_kw).state_dict().items()}
    return inputs.make_weights(spec, shapes, ctx.seed, device)


def program_model(ctx, cfg, weights):
    """The port's model of the cell's arch in the compute dtype, built on
    the meta device and given ``weights``."""
    from dasac_tpu_torch.nn.factory import build_model

    dtype = _DTYPES[ctx.program_dtype or cfg.TPU.COMPUTE_DTYPE]
    with torch.device("meta"):
        model = build_model(ctx.arch, ctx.num_classes, dtype=dtype,
                            device="meta", **ctx.model_kw)
    model.to_empty(device=ctx.device)
    model.load_state_dict(weights, strict=True)
    return model


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    """The allocator's peak on ``device`` (0 off the card)."""
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_mode():
    """float32 convolutions and products without TF32, the cuDNN
    heuristics (no autotuning: the reference runs once)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def card(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def count(ctx, passes):
    """The plain count of one unit of work: ``passes(model, prec)`` runs
    it on the reference model on the meta device in bf16, the served
    type."""
    from benchmark.reference.layers import Precision

    with torch.device("meta"):
        model = ref_steps.load_arch(ctx.arch).Model(ctx.num_classes,
                                                    **ctx.model_kw)
    c = counts.Count()
    with torch.device("meta"), c:
        passes(model, Precision(torch.bfloat16))
    return c


def readings(ctx, trace, units_per_s, c):
    from benchmark.harness import Readings

    name = card(ctx.device)
    pf, pb = peaks.bf16_flops(name), peaks.hbm_bytes(name)
    if pf is None:
        raise SystemExit("no peak for the card %r" % name)
    return Readings(trace=trace, units_per_s=units_per_s,
                    flops_per_unit=c.flops,
                    conv_min_s_per_unit=c.conv_min_s(pf, pb),
                    peak_flops=pf)
