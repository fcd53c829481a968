"""The rank side of ``tests/test_torch_dist.py``: what each process of its
2-rank gloo world runs.  It imports torch and the port only, so a spawned
rank starts without loading JAX; the inputs arrive as numpy arrays and the
results leave as a ``torch.save`` file per rank.
"""

import os

import numpy as np
import torch

from dasac_tpu_torch.aug import pipelines as tpipe
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn import functional as tF
from dasac_tpu_torch.nn.convert import train_state_from_jax
from dasac_tpu_torch.nn.layers import SyncBatchNorm
from dasac_tpu_torch.nn.tiny import TinySeg
from dasac_tpu_torch.train import cli
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train import steps as tsteps

WORLD = 2
C = 19
WIDTH = 8
H, W = 64, 64
B_SRC, B_TGT = 4, 4     # global batches: 2 frames a rank
G, T = 2, 2             # target groups (1 a rank) of T views
ITERS = 2


class Tiny(TinySeg):
    """The port's ``TinySeg`` without its dropout (the two packages draw
    dropout masks from different generators)."""

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        h, w = x.shape[1], x.shape[2]
        y = x.permute(0, 3, 1, 2)
        y = torch.relu(self.bn_a(self.conv_a(y), not update_stats))
        y = torch.relu(self.bn_b(self.conv_b(y), not update_stats))
        logits = self.aspp(y).float().permute(0, 2, 3, 1)
        return logits, tF.resize_bilinear_align_corners(logits, (h, w))


class MC:
    LR = 0.01
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


class MCAbn(MC):
    LR = 2.5e-4     # configs/deeplabv2_resnet101.yaml


def sac_scfg(mod, ce_impl):
    return mod.StepConfig(
        num_classes=C, crop_hw=(H, W), group_size=T, lr_target=0.1,
        net_momentum=0.99, net_momentum_iter=1, run_conf_lower=0.01,
        ce_impl=ce_impl)


def abn_scfg(mod, ce_impl):
    return mod.StepConfig(num_classes=C, crop_hw=(H, W), ce_impl=ce_impl)


def eval_scfg(mod):
    return mod.StepConfig(
        num_classes=C, crop_hw=(H, W), group_size=T, run_conf_lower=0.01,
        guided_hflip=True, tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2)


def shard(a, rank):
    n = a.shape[0] // WORLD
    return a[rank * n:(rank + 1) * n]


def _t(a):
    return torch.from_numpy(np.array(a))


def _draws(d):
    return {k: (_draws(v) if isinstance(v, dict) else _t(v))
            for k, v in d.items()}


def _port_state(inp, mc, group, teacher=None, running_conf=None):
    model = Tiny(num_classes=C, width=WIDTH, group=group)
    state = create_train_state(
        model, toptim.build_optimizer(mc, "tiny", model), C, device="cpu")
    t = teacher or inp["student"]
    train_state_from_jax(dict(
        params=inp["student"]["params"],
        batch_stats=inp["student"]["batch_stats"],
        teacher_params=t["params"], teacher_stats=t["batch_stats"],
        running_conf=(np.zeros(C, np.float32) if running_conf is None
                      else running_conf),
        slow_init=0.0 if teacher is None else 1.0, step=0), "tiny", state)
    return state


def _state_dict(state):
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "teacher": {k: v.clone() for k, v in
                        {**state.teacher_params,
                         **state.teacher_stats}.items()},
            "running_conf": state.running_conf.clone()}


def _equal_on_all_ranks(state, group):
    return dist.assert_replicas_equal(
        dist.state_tensors(state, "cpu", group=group), "cpu", group)


def rank_checks(rank, inp, group):
    """This rank's share of every module check; returns what the test
    holds against the shard_map reference."""
    out = {}
    # SyncBatchNorm: live statistics of the two shards together
    bn_x, bn_w = (shard(a, rank) for a in inp["bn"])
    bn = SyncBatchNorm(WIDTH, group=group)
    p = inp["student"]
    with torch.no_grad():
        bn.weight.copy_(_t(p["params"]["bn_a"]["scale"]))
        bn.bias.copy_(_t(p["params"]["bn_a"]["bias"]))
        bn.running_mean.copy_(_t(p["batch_stats"]["bn_a"]["mean"]))
        bn.running_var.copy_(_t(p["batch_stats"]["bn_a"]["var"]))
    x = _t(bn_x).requires_grad_(True)
    y = bn(x.permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
    (y * _t(bn_w)).sum().backward()
    out["bn"] = dict(y=y.detach(), mean=bn.running_mean.clone(),
                     var=bn.running_var.clone(), gx=x.grad,
                     gscale=bn.weight.grad, gbias=bn.bias.grad,
                     count=int(bn.num_batches_tracked))

    # ABN frames step
    state = _port_state(inp, MCAbn, group)
    step = tsteps.make_abn_frames_step(abn_scfg(tsteps, "kernel"),
                                       group=group)
    frames = [_t(shard(a, rank)) for a in (*inp["src"], *inp["tgt"])]
    out["abn_metrics"] = [
        {k: float(v) for k, v in step(state, *frames).items()}
        for _ in range(ITERS)]
    out["abn"] = _state_dict(state)
    out["abn_equal"] = _equal_on_all_ranks(state, group)

    # SAC views step
    state = _port_state(inp, MC, group)
    step = tsteps.make_sac_views_step(sac_scfg(tsteps, "kernel"),
                                      group=group)
    src_x, src_y = (_t(shard(a, rank)) for a in inp["src"])
    views = tpipe.TargetViews(*(_t(shard(a, rank)) for a in inp["views"]))
    out["sac_metrics"] = [
        {k: v.clone() for k, v in step(state, src_x, src_y, views).items()}
        for _ in range(ITERS)]
    out["sac"] = _state_dict(state)
    out["sac_equal"] = _equal_on_all_ranks(state, group)

    # eval steps, the target augmentation drawn as this rank's shard of
    # the JAX step draws it
    state = _port_state(inp, MC, group, teacher=inp["teacher"],
                        running_conf=inp["running_conf"])
    scfg = eval_scfg(tsteps)
    out["eval"] = tsteps.make_eval_step(scfg, "cpu", group=group)(
        state, *(shard(a, rank) for a in inp["ev"]))
    draws = _draws(inp["te_draws"][rank])
    sample = tpipe.sample_target_draws
    tpipe.sample_target_draws = lambda *a, **k: draws
    try:
        out["target_eval"] = tsteps.make_target_eval_step(
            scfg, "cpu", group=group)(
            state, *(shard(a, rank) for a in inp["te"]), torch.Generator())
    finally:
        tpipe.sample_target_draws = sample
    return out


def world_main(rank, addr, out_dir, inp, resume_argv, resume_port):
    """One rank: the module checks in a world of 2, then ``resume_argv``
    through the train CLI as a torchrun-style launch of the same 2 ranks
    (``--multiprocessing-distributed``, the environment set here)."""
    dist.init(dist.Launch(addr, WORLD, rank, rank), torch.device("cpu"))
    try:
        out = rank_checks(rank, inp, dist.group())
    finally:
        dist.destroy()
    torch.save(out, os.path.join(out_dir, "rank%d.pt" % rank))
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(resume_port),
                      WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    cli.main(resume_argv + ["--multiprocessing-distributed"], device="cpu")
