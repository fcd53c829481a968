"""The rank side of ``tests/test_torch_gspmd.py``: what each process of its
4-rank gloo world runs.  It imports torch and the port only, so a spawned
rank starts without loading JAX; the inputs arrive as numpy arrays and the
results leave as a ``torch.save`` file per rank.
"""

import os

import numpy as np
import torch

from dasac_tpu_torch.aug import pipelines as tpipe
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.mesh import TrainLayout, train_groups
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import train_state_from_jax
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train import steps as tsteps
from dasac_tpu_torch.nn import functional as tF
from dasac_tpu_torch.nn import spatial
from dasac_tpu_torch.nn.tiny import TinySeg
from tests.torch_dist_ranks import MC, MCAbn, _draws, _state_dict, _t

WORLD = 4
C = 19
WIDTH = 8
H, W = 64, 64           # (a): tests/test_torch_dist.py's frames
HB, WB = 42, 40         # (b): 42 rows do not split evenly over 4 ranks
B_SRC, G, T = 4, 2, 2   # global batches: 4 frames, 2 groups of 2 views
ITERS = 2
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
R101 = "deeplabv2_resnet101"
SHALLOW = (1, 1, 1, 1)

# (a): (step, model, layout, remat) held against JAX's gspmd-jitted step
JAX_CASES = [("sac", "tiny", "2x2", "none"), ("sac", "tiny", "1x4", "none"),
             ("abn", "tiny", "2x2", "none"), ("sac", "r101", "2x2", "block"),
             ("abn", "r101", "2x2", "block"), ("eval", "tiny", "2x2", "none"),
             ("target_eval", "tiny", "2x2", "none")]
# (b): held against the port's own one-process global step, from raw
# batches through the step's own draws; (c): the none twin of an (a) case
OWN_CASES = [("sac", "tiny", "1x4", "none"), ("sac", "r101", "2x2", "convs"),
             ("abn", "r101", "1x4", "convs"), ("abn", "r101", "2x2", "none")]


class Tiny(TinySeg):
    """The port's ``TinySeg`` without its dropout (the two packages draw
    dropout masks from different generators)."""

    def forward(self, x, train=False, update_stats=False, generator=None,
                upsample=True):
        h, w = spatial.frame_hw(x)
        y = x.permute(0, 3, 1, 2)
        y = torch.relu(self.bn_a(self.conv_a(y), not update_stats))
        y = torch.relu(self.bn_b(self.conv_b(y), not update_stats))
        logits = self.aspp(y).float().permute(0, 2, 3, 1)
        if not upsample:
            return logits, None
        return logits, tF.resize_bilinear_align_corners(logits, (h, w))


def sac_scfg(mod, ce_impl, hw=(H, W)):
    return mod.StepConfig(
        num_classes=C, crop_hw=hw, group_size=T, lr_target=0.1,
        net_momentum=0.99, net_momentum_iter=1, run_conf_lower=0.01,
        ce_impl=ce_impl)


def abn_scfg(mod, ce_impl, hw=(H, W)):
    return mod.StepConfig(num_classes=C, crop_hw=hw, ce_impl=ce_impl)


def eval_scfg(mod):
    return mod.StepConfig(
        num_classes=C, crop_hw=(H, W), group_size=T, run_conf_lower=0.01,
        guided_hflip=True, tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2)


def own_scfg(kind):
    """(b)'s step config: the port's draws, with jitter and greyscale."""
    if kind == "abn":
        return abn_scfg(tsteps, "kernel", (HB, WB))._replace(src_jitter=0.4)
    return sac_scfg(tsteps, "kernel", (HB, WB))._replace(
        tgt_jitter=0.4, tgt_greyscale=0.2)


def own_batch():
    """(b)'s raw global batch, uint8: 4 source frames a little larger than
    the crop, 2 target frames at it."""
    rng = np.random.RandomState(3)
    return (rng.randint(0, 256, (B_SRC, HB + 6, WB + 8, 3)).astype(np.uint8),
            rng.randint(0, C, (B_SRC, HB + 6, WB + 8)).astype(np.uint8),
            rng.randint(0, 256, (G, HB, WB, 3)).astype(np.uint8),
            rng.randint(0, C, (G, HB, WB)).astype(np.uint8))


def own_state(model, remat="none", group=None):
    """(b)'s state: the port's own random weights from seed 0 (the tiny
    arch with its dropout)."""
    kw = dict(width=WIDTH) if model == "tiny" else dict(layers=SHALLOW)
    arch = "tiny" if model == "tiny" else R101
    m = build_model(arch, C, remat=remat, device="cpu", group=group,
                    generator=torch.Generator().manual_seed(0), **kw)
    return create_train_state(m, toptim.build_optimizer(MC, arch, m), C,
                              device="cpu")


def run_own(kind, state, batch, step):
    """(b)'s steps from a generator seeded 5: 2 SAC steps (lazy init, then
    EMA) or 1 ABN step; the metrics of each."""
    gen = torch.Generator().manual_seed(5)
    n = ITERS if kind == "sac" else 1
    return [{k: v.detach().clone() for k, v in step(state, batch, gen).items()}
            for _ in range(n)]


def part(a, groups):
    n = a.shape[0] // groups.n_data
    return a[groups.d * n:(groups.d + 1) * n]


def _port_state(inp, model, remat, group, mc, teacher=None,
                running_conf=None):
    if model == "tiny":
        net, arch = Tiny(num_classes=C, width=WIDTH, group=group), "tiny"
    else:
        net = build_model(R101, C, remat=remat, device="cpu", group=group,
                          layers=SHALLOW)
        arch = R101
    state = create_train_state(
        net, toptim.build_optimizer(mc, arch, net), C, device="cpu")
    v = inp["vars"][model]
    t = teacher or v["student"]
    train_state_from_jax(dict(
        params=v["student"]["params"],
        batch_stats=v["student"]["batch_stats"],
        teacher_params=t["params"], teacher_stats=t["batch_stats"],
        running_conf=(np.zeros(C, np.float32) if running_conf is None
                      else running_conf),
        slow_init=0.0 if teacher is None else 1.0, step=0), arch, state)
    return state


def _calls_since(calls0):
    return {k: dist.CALLS[k] - v for k, v in calls0.items()}


def jax_case(inp, case, groups):
    """This rank's share of one (a) case."""
    kind, model, _, remat = case
    g = groups.world
    if kind in ("sac", "abn"):
        state = _port_state(inp, model, remat, g,
                            MC if kind == "sac" else MCAbn)
        calls0 = dict(dist.CALLS)
        if kind == "sac":
            step = tsteps.make_gspmd_sac_views_step(
                sac_scfg(tsteps, "kernel"), groups)
            src = [_t(part(a, groups)) for a in inp["src"]]
            views = tpipe.TargetViews(*(_t(part(a, groups))
                                        for a in inp["views"]))
            metrics = [step(state, *src, views) for _ in range(ITERS)]
        else:
            step = tsteps.make_gspmd_abn_frames_step(
                abn_scfg(tsteps, "kernel"), groups)
            frames = [_t(part(a, groups)) for a in (*inp["src"], *inp["tgt"])]
            metrics = [step(state, *frames) for _ in range(ITERS)]
        return dict(metrics=[{k: v.clone() for k, v in m.items()}
                             for m in metrics],
                    state=_state_dict(state), calls=_calls_since(calls0),
                    equal=_equal(state, g))
    state = _port_state(inp, model, remat, g, MC, teacher=inp["teacher"],
                        running_conf=inp["running_conf"])
    scfg = eval_scfg(tsteps)
    if kind == "eval":
        return tsteps.make_gspmd_eval_step(scfg, groups, "cpu")(
            state, *(part(a, groups) for a in inp["ev"]))
    # the global batch's draws: JAX's, from the step's key
    draws = _draws(inp["te_draws"])
    sample = tpipe.sample_target_draws
    tpipe.sample_target_draws = lambda *a, **k: draws
    try:
        return tsteps.make_gspmd_target_eval_step(scfg, groups, "cpu")(
            state, *(part(a, groups) for a in inp["te"]), torch.Generator())
    finally:
        tpipe.sample_target_draws = sample


def own_case(case, groups):
    """This rank's share of one (b) case: its data slice of the raw batch
    through the gspmd step."""
    kind, model, _, remat = case
    state = own_state(model, remat, groups.world)
    make = (tsteps.make_gspmd_sac_step if kind == "sac"
            else tsteps.make_gspmd_abn_step)
    calls0 = dict(dist.CALLS)
    metrics = run_own(kind, state, tuple(part(a, groups)
                                         for a in own_batch()),
                      make(own_scfg(kind), groups, "cpu"))
    return dict(metrics=metrics, state=_state_dict(state),
                calls=_calls_since(calls0), equal=_equal(state, groups.world))


def _equal(state, group):
    return dist.assert_replicas_equal(
        dist.state_tensors(state, "cpu", group=group), "cpu", group)


def world_main(rank, addr, out_dir, inp):
    """One rank: the groups of both layouts (every rank builds every group
    in the same order), then every case."""
    torch.set_num_threads(1)
    dist.init(dist.Launch(addr, WORLD, rank, rank), torch.device("cpu"))
    try:
        groups = {name: train_groups(TrainLayout(*lay, True), rank,
                                     dist.group())
                  for name, lay in LAYOUTS.items()}
        out = {"jax": {c: jax_case(inp, c, groups[c[2]]) for c in JAX_CASES},
               "own": {c: own_case(c, groups[c[2]]) for c in OWN_CASES},
               "coords": {k: (g.d, g.s) for k, g in groups.items()}}
    finally:
        dist.destroy()
    torch.save(out, os.path.join(out_dir, "rank%d.pt" % rank))
