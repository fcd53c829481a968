"""Stage breakdown of the SAC train step on the card (counterpart of
``dasac_tpu/tools/profile_step.py``).

Times each stage of the flagship step in isolation:
  aug        device-side source + target augmentation
  teacher    teacher forward (no grad) on the clean views
  refine     warp -> pool -> unwarp + running confidence + pseudo-labels
  src_grad   source CE forward + backward
  tgt_grad   target focal-CE forward + backward
  full       the complete step (reference point)

Each stage is one function of the port's own step pieces
(``train/steps.py``, ``sac/``), run once to warm up and then ``--iters``
times, each call between two CUDA events; its median prints as one JSON
line ``{"stage", "ms", "card"}``.  The step is ``tools/flagship.py``'s
(``bench.py``'s sizes and modes); random weights from seed 0 and uint8
noise from ``RandomState(0)`` already on the card.  ``main`` returns
``{stage: ms}``.  With ``device="cpu"`` it runs on the CPU and times with
the host clock.

    python -m dasac_tpu_torch.tools.profile_step [--remat convs] [--iters 5]
"""

import argparse
import json

import numpy as np
import torch
from torch.func import functional_call

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.sac import core as sac_core
from dasac_tpu_torch.sac import refine as sac_refine
from dasac_tpu_torch.tools import flagship
from dasac_tpu_torch.train import steps

STAGES = ("aug", "teacher", "refine", "src_grad", "tgt_grad", "full")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    flagship.add_step_args(ap)
    ap.add_argument("--remat", choices=["none", "block", "convs"],
                    default="none")
    ap.add_argument("--refine-dtype", choices=["float32", "bfloat16"],
                    default="bfloat16")
    ap.add_argument("--refine-res", choices=["full", "stride8"],
                    default="stride8")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=None,
                    help="subset of stages to run")
    ap.add_argument("--resize-method", choices=["matmul", "gather"],
                    default="matmul",
                    help="accepted for dasac_tpu's command lines; no effect "
                         "(XLA's resize formulation; the port has one)")
    return ap.parse_args(argv)


def stage_fns(args, device):
    """``{stage: fn}``, each a no-argument call of one stage on the same
    state, inputs and generator seed."""
    scfg = flagship.step_config(args, args.refine_dtype, args.refine_res)
    state = flagship.build_state(args, device, remat=args.remat)
    model = state.model
    batch = flagship.random_batch(args, device, np.random.RandomState(0))
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = steps._DTYPES[scfg.refine_dtype]

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    def aug():
        return steps.augment_sac(scfg, gen(), batch)

    src_frames, src_lbls, views = aug()
    teacher_tensors = {**state.teacher_params, **state.teacher_stats}

    @torch.no_grad()
    def teacher():
        return functional_call(model, teacher_tensors, (views.frames_clean,),
                               dict(train=False, update_stats=False))[0]

    t_logits = teacher()

    @torch.no_grad()
    def refine():
        refined, diags = sac_refine.refine(
            t_logits, views.affine, views.affine_inv, views.padding,
            group_size=scfg.group_size, pool=scfg.pool,
            pool_on=scfg.pool_on, compute_dtype=rd, res=scfg.refine_res)
        rc = sac_core.update_running_conf(
            state.running_conf, diags["teacher_probs"], scfg.stat_momentum,
            scfg.threshold_beta)
        pseudo, conf, _ = sac_core.pseudo_labels(
            refined, views.padding, rc, upper=scfg.run_conf_upper,
            lower=scfg.run_conf_lower, threshold_beta=scfg.threshold_beta,
            discount=scfg.conf_discount, compute_dtype=rd_pl)
        return pseudo, conf, rc

    pseudo, conf, rc = refine()

    def src_grad():
        model.zero_grad(set_to_none=True)
        _, up = model(src_frames, train=True, update_stats=False,
                      generator=gen())
        sac_core.cross_entropy_mean(up, src_lbls,
                                    impl=scfg.ce_impl).backward()

    def tgt_grad():
        model.zero_grad(set_to_none=True)
        _, up = model(views.frames_aug, train=True, update_stats=False,
                      generator=gen())
        loss, _ = sac_core.focal_ce(up, pseudo, conf, rc, p=scfg.focal_p,
                                    use_conf=scfg.use_conf_loss,
                                    impl=scfg.ce_impl)
        loss.backward()

    full_step = steps.make_sac_step(scfg, device=device)

    def full():
        full_step(state, batch, gen())

    return {"aug": aug, "teacher": teacher, "refine": refine,
            "src_grad": src_grad, "tgt_grad": tgt_grad, "full": full}


def main(argv=None, device=None):
    """Print and return ``{stage: median ms}``; ``device`` defaults to
    CUDA (raises when there is none)."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    card = flagship.device_label(device)
    fns = stage_fns(args, device)
    results = {}
    for name in args.stages or STAGES:
        results[name] = flagship.median_ms(fns[name], device, args.iters)
        print(json.dumps({"stage": name, "ms": results[name], "card": card,
                          "remat": args.remat}), flush=True)
    return results


if __name__ == "__main__":
    main()
