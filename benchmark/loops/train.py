"""Training traffic: a closed loop of the port's SAC or ABN train step
(``traffic["stage"]``) on a pool of loader-size batches made on the
device.

Set-up builds the train state once and drives it through its first
``CHECKED`` steps by the window's own call and feed, on batches that all
differ; the losses of those steps, the first step's gradient as the
optimizer got it (its momentum buffer less the weight decay) and the
change of every tensor after them are kept.  The window then runs the
same step on the same state for ``--seconds``.  Once it has closed and
the program is freed, the plain reference runs the same steps from the
same weights, inputs and generator seed in float32, and the two are
compared."""

import time

import torch

from benchmark import inputs
from benchmark.loops import common
from benchmark.harness import Record
from benchmark.reference import steps as ref_steps
from benchmark.reference.layers import REFERENCE

CHECKED = 3
TRACE_STEPS = 3
# the step's losses, by the port's metric name -> the name compared
LOSSES = {"sac": {"src_loss_ce": "src_ce", "self_ce": "self_ce"},
          "abn": {"src_loss_ce": "src_ce", "loss_ce": "tgt_ce"}}
# a leaf whose reference gradient is under this share of the median
# leaf's is moved by round-off alone and not compared
TINY_GRAD = 1e-3


def _sgd_grads(opt, names, p0):
    """name -> the first step's gradient as the optimizer got it: torch
    SGD's first momentum buffer is the gradient plus the decay."""
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            buf = opt.state[p]["momentum_buffer"]
            out[names[id(p)]] = buf - group["weight_decay"] * p0[
                names[id(p)]]
    return out


def _host(tensors):
    return {k: v.detach().float().cpu() for k, v in tensors.items()}


def _norms(tensors):
    keys = list(tensors)
    vals = torch.stack(torch._foreach_norm(
        [tensors[k].float() for k in keys])).tolist()
    return dict(zip(keys, vals))


def _deltas(model, p0):
    return {k: v.float() - p0[k] for k, v in model.state_dict().items()
            if v.is_floating_point()}


# each tensor kept, the name of its leaves' norms, the number compared
TENSORS = (("g1", "grads", "grad"), ("d3", "changes", "change"))


def _readings(losses, g1, d3):
    """The checked steps' losses; the first gradient and the change over
    the steps, each leaf on the host, and their norms."""
    return dict(losses=losses, g1=g1, d3=d3, grads=_norms(g1),
                changes=_norms(d3))


def _losses(m, stage):
    return {name: float(m[k]) for k, name in LOSSES[stage].items()}


def program_setup(ctx):
    """The program's state driven through its checked steps: returns
    (step, state, pool, generator, readings)."""
    from dasac_tpu_torch.core.device import autotune_convolutions
    from dasac_tpu_torch.core.state import create_train_state
    from dasac_tpu_torch.train import optim, steps

    cfg = common.port_cfg(ctx)
    scfg = steps.step_config_from_cfg(cfg)
    autotune_convolutions(ctx.device)
    weights = common.reference_weights(ctx)
    model = common.program_model(ctx, cfg, weights)
    opt = optim.build_optimizer(cfg.MODEL, ctx.arch, model)
    state = create_train_state(model, opt, ctx.num_classes, ctx.device)
    make = {"sac": steps.make_sac_step, "abn": steps.make_abn_step}
    stage = ctx.cell.traffic["stage"]
    step = make[stage](scfg, ctx.device)
    pool = inputs.train_pool(ctx.seed, ctx.cell.traffic, ctx.num_classes,
                             ctx.device)
    gen = inputs.generator(ctx.seed, "step", ctx.device)
    names = {id(p): k for k, p in model.named_parameters()}
    losses, g1 = [], None
    for k in range(CHECKED):
        losses.append(_losses(step(state, pool[k], gen), stage))
        if k == 0:
            g1 = _host(_sgd_grads(opt, names, weights))
    reads = _readings(losses, g1, _host(_deltas(model, weights)))
    del weights
    return step, state, pool, gen, reads


def reference_readings(ctx, prec=REFERENCE, half=False, altered=False):
    """The reference's readings of the checked steps in ``prec``; with
    ``half`` on the first half of each batch only, with ``altered`` its
    first leaf moved by its mean magnitude after each step (planted
    faults)."""
    common.reference_mode()
    algo = ref_steps.Algo(ctx.keys)
    weights = common.reference_weights(ctx)
    model = ref_steps.build_model(ctx.arch, ctx.num_classes, weights,
                                  ctx.device, **ctx.model_kw)
    st = ref_steps.TrainState(model, algo, ctx.num_classes)
    stage = ctx.cell.traffic["stage"]
    fn = {"sac": ref_steps.sac_step, "abn": ref_steps.abn_step}[stage]
    pool = inputs.train_pool(ctx.seed, ctx.cell.traffic, ctx.num_classes,
                             ctx.device)[:CHECKED]
    gen = inputs.generator(ctx.seed, "step", ctx.device)
    names = {id(p): k for k, p in model.named_parameters()}
    losses, g1 = [], None
    for k in range(CHECKED):
        batch = pool[k]
        if half:
            batch = tuple(t[:max(1, t.shape[0] // 2)] for t in batch)
        losses.append(_losses(fn(st, batch, gen, prec), stage))
        if altered:
            with torch.no_grad():
                p = next(iter(model.parameters()))
                p.add_(p.abs().mean())
        if k == 0:
            g1 = _host(_sgd_grads(st.opt, names, weights))
    reads = _readings(losses, g1, _host(_deltas(model, weights)))
    del st, model, weights, pool
    common.free()
    return reads


def _leaf_gaps(prog, ref, keep):
    """leaf -> its gap of norms, against the larger of the reference's
    norm of that leaf and of the median leaf."""
    med = sorted(ref[k] for k in keep)[len(keep) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-30)


def _kept(ref):
    """The leaves compared, by the name of their norms: leaves whose
    reference gradient is under ``TINY_GRAD`` of the median leaf's move
    by round-off alone and are left out; buffers (BN statistics) are kept
    whatever their gradient."""
    gmed = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    moved = [k for k, v in ref["grads"].items() if v >= TINY_GRAD * gmed]
    keep = [k for k in ref["changes"]
            if k not in ref["grads"] or k in moved]
    return {"grads": moved, "changes": keep}


def leaf_gaps(prog, ref):
    """Norms' name -> leaf -> its gap of norms (``_leaf_gaps``)."""
    keep = _kept(ref)
    return {n: _leaf_gaps(prog[n], ref[n], keep[n]) for _, n, _ in TENSORS}


def leaf_diffs(prog, ref):
    """Norms' name -> leaf -> the norm of the difference of the leaf,
    against the larger of the reference's norm of that leaf and of the
    median leaf: first order in an error where the gap of norms is second
    order in the part of it across the reference."""
    keep, out = _kept(ref), {}
    for t, n, _ in TENSORS:
        med = sorted(ref[n][k] for k in keep[n])[len(keep[n]) // 2]
        diff = _norms({k: prog[t][k] - ref[t][k] for k in keep[n]})
        out[n] = {k: diff[k] / max(ref[n][k], med, 1e-30) for k in keep[n]}
    return out


def compare(prog, ref):
    """The numbers that can be compared: for each loss (``src_ce``,
    ``self_ce`` or ``tgt_ce``) the largest relative gap over the checked
    steps, and with ``1`` appended the first step's; ``grad``, the worst
    leaf's gap of norms of the first gradient, ``change`` of the change
    over the checked steps; each with ``_med`` the median leaf's, with ``_diff`` the worst
    leaf's norm of the difference and ``_diff_med`` the median leaf's.
    The cell's limits file names those it holds."""
    out = {}
    for k, v in ref["losses"][0].items():
        out[k] = max(_rel(p[k], r[k])
                     for p, r in zip(prog["losses"], ref["losses"]))
        out[k + "1"] = _rel(prog["losses"][0][k], v)
    gaps, diffs = leaf_gaps(prog, ref), leaf_diffs(prog, ref)
    for _, n, name in TENSORS:
        for suffix, d in (("", gaps[n]), ("_diff", diffs[n])):
            v = sorted(d.values())
            out[name + suffix] = v[-1]
            out[name + suffix + "_med"] = v[len(v) // 2]
    return out


def _passes(ctx, stage):
    """The plain count's unit: one step's forwards and backwards."""
    crop = tuple(ctx.keys["DATASET.CROP_SIZE"])
    src = ctx.cell.traffic["source"]["frames"]
    views = ctx.cell.traffic["target"]["frames"] * (
        ctx.keys["TRAIN.GROUP_SIZE"] if stage == "sac" else 1)

    def run(model, prec):
        x_src = torch.zeros((src, *crop, 3))
        x_tgt = torch.zeros((views, *crop, 3))
        if stage == "sac":
            with torch.no_grad():
                model(x_tgt, prec)                          # teacher
            for x in (x_src, x_tgt):                        # student
                model(x, prec, train=True)[1].float().sum().backward()
        else:
            model(x_src, prec, live=True, train=True)[1].float().sum(
            ).backward()
            with torch.no_grad():
                model(x_tgt, prec, live=True, train=True)
    return run


def run(ctx):
    stage = ctx.cell.traffic["stage"]
    step, state, pool, gen, prog = program_setup(ctx)
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    frames = ctx.cell.traffic["source"]["frames"]
    out, i = [], CHECKED
    t_start = time.perf_counter()
    while True:
        m = step(state, pool[i % len(pool)], gen)
        out.append(torch.stack([m[k].float() for k in LOSSES[stage]]))
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    common.sync(ctx.device)
    window_s = time.perf_counter() - t_start
    n = len(out)
    failed = int((~torch.isfinite(torch.stack(out))).any(dim=1).sum())

    reads = None
    if ctx.trace:
        from benchmark import trace

        def one():
            nonlocal i
            step(state, pool[i % len(pool)], gen)
            i += 1

        t = trace.record(one, TRACE_STEPS)
        reads = common.readings(ctx, t, n / window_s, common.count(
            ctx, _passes(ctx, stage)))
    peak = common.peak_bytes(ctx.device)
    del step, state, pool, gen, out, m
    common.free()

    ref = reference_readings(ctx)
    lim = ctx.cell.limits
    got = compare(prog, ref)
    checks = {k: (got[k], lim[k]) for k in lim}
    return Record(setup_s=setup_s,
                  end_to_end={"train_img_s": n * frames / window_s,
                              "peak_gb": peak / 1e9, "setup_s": setup_s},
                  attempted=n, failed=failed, peak_bytes=peak,
                  checks=checks, readings=reads)
