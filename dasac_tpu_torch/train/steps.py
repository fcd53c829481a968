"""Train and eval steps (counterpart of ``dasac_tpu/train/steps.py``).

SAC step: device-side augmentation, teacher EMA / lazy init, no-grad
teacher forward + multi-view refinement, pseudo-labels, then the source
backward and the target backward (gradients accumulate in ``.grad``, as in
the reference trainer, train.py:130-233) and one optimizer step.  Only one
branch's activations are alive at a time.

ABN (source-only baseline) step: source CE with live BN, one optimizer
step, then a no-grad target forward that only refreshes the BN statistics
(reference train.py:273-289).

Eval steps: normalized forward -> argmax -> confusion, for the student or
teacher, for the reference's four target-group layers, and the full
target-branch outputs for visualisation.

Data parallel: a step built with a process ``group`` is one rank's share
of the global step, as ``dasac_tpu``'s steps built with ``axis_name`` are
one shard's.  Each rank's loss is the mean over its own shard; the
gradients are averaged over the ranks after both backwards and before the
optimizer step, in one flat all-reduce; the metrics are averaged in one
small all-reduce; the running confidence averages the batch mean over the
ranks; confusions are summed.  The model's BN layers were built with the
same group (``nn.factory.build_model``).  Without a group nothing is
communicated.
"""

from typing import NamedTuple, Tuple

import torch
from torch.func import functional_call

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.aug import pipelines
from dasac_tpu_torch.aug.warp import warp_affine
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.sac import core as sac_core
from dasac_tpu_torch.sac import refine as sac_refine
from dasac_tpu_torch.train.metrics import confusion_matrix

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class StepConfig(NamedTuple):
    """Hyperparameters of the step."""

    num_classes: int = 19
    crop_hw: Tuple[int, int] = (512, 1024)
    group_size: int = 4
    # optimization
    lr_target: float = 1.0
    target_only: bool = False
    # teacher / prior
    net_momentum: float = 0.99
    net_momentum_iter: int = 100
    stat_momentum: float = 0.99
    threshold_beta: float = 1e-3
    conf_discount: bool = True
    pool: str = "avg_pool"
    pool_on: bool = True
    # "bfloat16" runs the no-grad teacher refine/pseudo-label chain in bf16
    refine_dtype: str = "float32"
    # "bfloat16" computes the CE log-softmax in bf16 (logsoftmax impl only)
    loss_dtype: str = "float32"
    # "kernel": the fused ops/ce.py kernel pair (softmax recomputed in
    # backward); "logsoftmax": the plain formula
    ce_impl: str = "kernel"
    # "stride8" runs the teacher refine chain at the logits' stride-8 grid
    # and upsamples the pooled result once
    refine_res: str = "full"
    focal_p: int = 3
    use_conf_loss: bool = True  # MODEL.LOSS == focal_ce_conf
    run_conf_upper: float = 0.75
    run_conf_lower: float = 0.2
    # source augmentation
    src_scale: Tuple[float, float] = (0.5, 1.5)
    src_hflip: bool = True
    src_jitter: float = 0.0
    src_blur: bool = False
    src_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    src_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # target augmentation
    target_scale: Tuple[float, float] = (1.0, 1.1)
    zoom: Tuple[float, float] = (0.5, 1.2)
    group_hflip: bool = True
    guided_hflip: bool = True
    tgt_blur: bool = True
    tgt_jitter: float = 0.0
    tgt_greyscale: float = 0.0
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


_CE_IMPLS = {"pallas": "kernel", "xla": "logsoftmax"}


def step_config_from_cfg(cfg):
    """A :class:`StepConfig` from a config with the reference YAML's
    attribute schema (``cfg.DATASET``, ``cfg.MODEL``, ``cfg.TRAIN``,
    ``cfg.TPU``; any object with those attributes).  ``TPU.CE_IMPL`` maps
    ``"pallas"`` to ``"kernel"`` and ``"xla"`` to ``"logsoftmax"``.  The
    JAX ``StepConfig`` field ``ckpt_loss`` (``TPU.CKPT_LOSS``, loss
    rematerialization under XLA) has no counterpart here: the kernel CE
    keeps no log-softmax residual, and the port does not read it."""
    d = cfg.DATASET
    m = cfg.MODEL
    if d.RENORM_SOURCE:
        src_mean, src_std = pipelines.renorm_stats(
            d.MEAN, d.STD, d.SOURCE_MEAN, d.SOURCE_STD,
            d.TARGET_MEAN, d.TARGET_STD)
    else:
        src_mean, src_std = tuple(d.MEAN), tuple(d.STD)
    if cfg.TPU.CE_IMPL not in _CE_IMPLS:
        raise ValueError("TPU.CE_IMPL must be one of %s, got %r"
                         % (sorted(_CE_IMPLS), cfg.TPU.CE_IMPL))
    return StepConfig(
        num_classes=19,
        crop_hw=tuple(d.CROP_SIZE),
        group_size=cfg.TRAIN.GROUP_SIZE,
        lr_target=m.LR_TARGET,
        target_only=cfg.TRAIN.TARGET_ONLY,
        net_momentum=m.NET_MOMENTUM,
        net_momentum_iter=m.NET_MOMENTUM_ITER,
        stat_momentum=m.STAT_MOMENTUM,
        threshold_beta=m.THRESHOLD_BETA,
        conf_discount=m.CONF_DISCOUNT,
        pool=m.CONF_POOL,
        pool_on=m.CONF_POOL_ON,
        refine_dtype=cfg.TPU.REFINE_DTYPE,
        loss_dtype=cfg.TPU.LOSS_DTYPE,
        ce_impl=_CE_IMPLS[cfg.TPU.CE_IMPL],
        refine_res=cfg.TPU.REFINE_RES,
        focal_p=m.FOCAL_P,
        use_conf_loss=(m.LOSS == "focal_ce_conf"),
        run_conf_upper=m.RUN_CONF_UPPER,
        run_conf_lower=m.RUN_CONF_LOWER,
        src_scale=(d.SCALE_FROM, d.SCALE_TO),
        src_hflip=d.RND_HFLIP,
        # reference quirk reproduced: gate on SRC_RND_JITTER, strength from
        # RND_JITTER (dataloader_seg.py:84-85)
        src_jitter=(d.RND_JITTER if d.SRC_RND_JITTER > 0 else 0.0),
        src_blur=d.SRC_RND_BLUR,
        src_mean=src_mean,
        src_std=src_std,
        target_scale=tuple(d.TARGET_SCALE),
        zoom=tuple(d.RND_ZOOM),
        group_hflip=d.RND_HFLIP,
        guided_hflip=d.GUIDED_HFLIP,
        tgt_blur=d.RND_BLUR,
        tgt_jitter=d.RND_JITTER,
        tgt_greyscale=d.RND_GREYSCALE,
        mean=tuple(d.MEAN),
        std=tuple(d.STD),
    )


def _to_device(device, *arrays):
    return tuple(torch.as_tensor(a).to(device, non_blocking=True)
                 for a in arrays)


def augment_target(scfg, generator, images, labels):
    """The target groups' views under ``scfg``'s target augmentation."""
    return pipelines.augment_target_groups(
        generator, images, labels, group_size=scfg.group_size,
        target_scale=scfg.target_scale, zoom=scfg.zoom,
        group_hflip=scfg.group_hflip, guided_hflip=scfg.guided_hflip,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale, mean=scfg.mean, std=scfg.std)


def _average_grads(model, group):
    """``dasac_tpu``'s ``_pmean(grads)``: every rank's ``.grad`` becomes the
    mean over the ranks, in one flat all-reduce."""
    dist.all_reduce_mean_([p.grad for p in model.parameters()
                           if p.grad is not None], group)


def _average_metrics(metrics, group):
    dist.all_reduce_mean_(list(metrics.values()), group)
    return metrics


def make_sac_step(scfg: StepConfig, device=None, group=None):
    """Returns ``step(state, batch, generator) -> metrics``.

    ``batch`` = (src_images u8 [B,H0,W0,3], src_labels [B,H0,W0],
                 tgt_images u8 [G,H,W,3],  tgt_labels [G,H,W]) as tensors
    or numpy arrays; they are moved to ``device`` (default CUDA; raises when
    there is none), which must be the state's.  ``generator`` is a
    ``torch.Generator`` on that device; it draws the augmentation.  The
    state is updated in place.  ``group``: see the module's docstring.
    """
    device = resolve_device(device)
    views_step = make_sac_views_step(scfg, group=group)

    def step(state, batch, generator):
        src_images, src_labels, tgt_images, tgt_labels = _to_device(
            device, *batch)
        src_frames, src_lbls = pipelines.augment_source_batch(
            generator, src_images, src_labels, crop_hw=scfg.crop_hw,
            scale_range=scfg.src_scale, hflip=scfg.src_hflip,
            jitter=scfg.src_jitter, blur=scfg.src_blur,
            mean=scfg.src_mean, std=scfg.src_std)
        views = augment_target(scfg, generator, tgt_images, tgt_labels)
        return views_step(state, src_frames, src_lbls, views, generator)

    return step


def make_sac_views_step(scfg: StepConfig, debug=False, group=None):
    """The SAC iteration on PRE-AUGMENTED inputs.

    ``views_step(state, src_frames, src_lbls, views, generator=None)`` with
    ``src_frames`` already normalized/cropped and ``views`` a
    :class:`~dasac_tpu_torch.aug.pipelines.TargetViews`; ``generator``
    drives the student's dropout (where the arch has any).  Updates
    ``state`` in place and returns the metrics dict (device tensors).

    With ``debug=True`` the metrics also carry the pseudo-labels, teacher
    confidence, refined probabilities and the summed gradients (by
    parameter name); ``debug="light"`` adds only the pseudo-labels and
    running_conf.
    """
    # refine-chain precision: None = f32 interpolation (reference-exact)
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = _DTYPES[scfg.refine_dtype]
    ld = _DTYPES[scfg.loss_dtype]

    def views_step(state, src_frames, src_lbls, views, generator=None):
        model, opt = state.model, state.optimizer

        # ---- teacher EMA / lazy init (sac.py:70-102, train.py:294) --------
        # the lazy init runs whenever it has not happened yet (our step
        # counter is global, the reference's per epoch)
        do_update = (state.step % scfg.net_momentum_iter == 0
                     or not state.slow_init)
        student = {**state.student_params(), **state.student_stats()}
        teacher = {**state.teacher_params, **state.teacher_stats}
        names = list(teacher)
        with torch.no_grad():
            slow_init, running_conf, teacher_diff = \
                sac_core.maybe_update_teacher(
                    [teacher[k] for k in names],
                    [student[k].detach() for k in names],
                    state.slow_init, state.running_conf,
                    momentum=scfg.net_momentum,
                    threshold_beta=scfg.threshold_beta, do_update=do_update)

            # ---- teacher branch on clean views (no grad) ------------------
            t_logits, _ = functional_call(
                model, teacher, (views.frames_clean,),
                dict(train=False, update_stats=False))
            refined, diags = sac_refine.refine(
                t_logits, views.affine, views.affine_inv, views.padding,
                group_size=scfg.group_size, pool=scfg.pool,
                pool_on=scfg.pool_on, compute_dtype=rd, res=scfg.refine_res)
            running_conf = sac_core.update_running_conf(
                running_conf, diags["teacher_probs"], scfg.stat_momentum,
                scfg.threshold_beta, group=group)
            pseudo, conf, _ = sac_core.pseudo_labels(
                refined, views.padding, running_conf,
                upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
                threshold_beta=scfg.threshold_beta,
                discount=scfg.conf_discount, compute_dtype=rd_pl)
            del t_logits, diags
            if not debug or debug == "light":
                del refined

        # ---- source backward, then target backward (grads accumulate) ----
        # student forwards run in train mode (dropout on); BN stays frozen
        opt.zero_grad(set_to_none=True)
        if scfg.target_only:
            ce_src = torch.zeros((), device=running_conf.device)
        else:
            _, src_up = model(src_frames, train=True, update_stats=False,
                              generator=generator)
            ce_src = sac_core.cross_entropy_mean(
                src_up, src_lbls, compute_dtype=ld, impl=scfg.ce_impl)
            ce_src.backward()
            del src_up
        _, tgt_up = model(views.frames_aug, train=True, update_stats=False,
                          generator=generator)
        self_ce, per_class = sac_core.focal_ce(
            tgt_up, pseudo, conf, running_conf, p=scfg.focal_p,
            use_conf=scfg.use_conf_loss, compute_dtype=ld, impl=scfg.ce_impl)
        (scfg.lr_target * self_ce).backward()
        del tgt_up
        _average_grads(model, group)

        grads = None
        if debug and debug != "light":
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()}
        opt.step()

        state.running_conf = running_conf
        state.slow_init = slow_init
        state.step += 1
        metrics = _average_metrics({
            "src_loss_ce": ce_src.detach(),
            "self_ce": self_ce.detach(),
            "teacher_diff": teacher_diff,
            "pseudo_cover": (pseudo != sac_core.IGNORE).float().mean(),
            "self_ce_per_class": per_class,
        }, group)
        if debug:
            metrics.update(pseudo=pseudo, running_conf=running_conf)
            if debug != "light":
                metrics.update(conf=conf, refined=refined, grads=grads)
        return metrics

    return views_step


# ---------------------------------------------------------------------------
# ABN baseline step
# ---------------------------------------------------------------------------

def make_abn_step(scfg: StepConfig, device=None, group=None):
    """ABN: source CE training with live BN + a target stats-only pass.

    Returns ``step(state, batch, generator) -> metrics`` with ``batch`` =
    (src_images u8 [B,H0,W0,3], src_labels [B,H0,W0], tgt_images u8
    [Bt,Ht,Wt,3], tgt_labels [Bt,Ht,Wt]) at the loader's sizes, moved to
    ``device`` (default CUDA; raises when there is none).  The baseline's
    target loader is a plain source-style dataset (reference
    datasets/__init__.py:51-53), so the target frames go through the
    SOURCE pipeline (source scale range, jitter, blur) with the standard
    ``mean``/``std``, not the renormalized source statistics.  The teacher
    tensors and ``running_conf`` are left as they are.  ``group``: see the
    module's docstring.
    """
    device = resolve_device(device)
    frames_step = make_abn_frames_step(scfg, group=group)

    def step(state, batch, generator):
        return frames_step(state, *augment_abn(scfg, generator,
                                               _to_device(device, *batch)),
                           generator)

    return step


def augment_abn(scfg: StepConfig, generator, batch):
    """The ABN step's augmentation: ``batch`` = (src_images, src_labels,
    tgt_images, tgt_labels) on one device -> (src_frames, src_lbls,
    tgt_frames, tgt_lbls).  Both halves go through the source pipeline; the
    source frames are normalized with ``src_mean``/``src_std``, the target
    frames with the standard ``mean``/``std``."""
    out = ()
    for images, labels, mean, std in (
            (*batch[:2], scfg.src_mean, scfg.src_std),
            (*batch[2:], scfg.mean, scfg.std)):
        out += pipelines.augment_source_batch(
            generator, images, labels, crop_hw=scfg.crop_hw,
            scale_range=scfg.src_scale, hflip=scfg.src_hflip,
            jitter=scfg.src_jitter, blur=scfg.src_blur, mean=mean, std=std)
    return out


def make_abn_frames_step(scfg: StepConfig, group=None):
    """The ABN iteration on PRE-AUGMENTED inputs:
    ``frames_step(state, src_frames, src_lbls, tgt_frames, tgt_lbls,
    generator=None) -> {"src_loss_ce", "loss_ce"}``, updating ``state`` in
    place.

    The order is the JAX version's: the source forward in train mode
    (updating the BN running statistics), its backward and the optimizer
    step; then the target forward with the UPDATED parameters, starting
    from the statistics the source pass left, under ``torch.no_grad()``
    (its CE is a metric).  Every BN's ``num_batches_tracked`` grows by 2 a
    step (the JAX state has no such counter).
    """

    def frames_step(state, src_frames, src_lbls, tgt_frames, tgt_lbls,
                    generator=None):
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        _, src_up = model(src_frames, train=True, update_stats=True,
                          generator=generator)
        ce_src = sac_core.cross_entropy_mean(src_up, src_lbls,
                                             impl=scfg.ce_impl)
        ce_src.backward()
        del src_up
        _average_grads(model, group)
        opt.step()

        # target pass: BN statistics only, no gradient (train.py:286-289)
        with torch.no_grad():
            _, tgt_up = model(tgt_frames, train=True, update_stats=True,
                              generator=generator)
            ce_tgt = sac_core.cross_entropy_mean(tgt_up, tgt_lbls,
                                                 impl=scfg.ce_impl)
        state.step += 1
        return _average_metrics({"src_loss_ce": ce_src.detach(),
                                 "loss_ce": ce_tgt}, group)

    return frames_step


# ---------------------------------------------------------------------------
# evaluation steps
# ---------------------------------------------------------------------------

def _eval_forward(state, x, teacher=False):
    """(logits, logits_up) of the student, or of the teacher's tensors, with
    frozen BN."""
    kw = dict(train=False, update_stats=False)
    if teacher:
        return functional_call(
            state.model, {**state.teacher_params, **state.teacher_stats},
            (x,), kw)
    return state.model(x, **kw)


def make_eval_step(scfg: StepConfig, device=None, teacher=False,
                   group=None):
    """Plain eval: ``step(state, images_u8 [B,H,W,3], labels [B,H,W]) ->
    int64 confusion [C, C]`` (normalized forward -> argmax -> confusion),
    for the student or, with ``teacher``, the teacher's tensors.  Inputs
    move to ``device`` (default CUDA; raises when there is none).  With a
    process ``group`` the confusion is summed over its ranks."""
    device = resolve_device(device)

    @torch.no_grad()
    def step(state, images_u8, labels):
        images_u8, labels = _to_device(device, images_u8, labels)
        x = P.normalize(images_u8.float() / 255.0, scfg.mean, scfg.std)
        _, up = _eval_forward(state, x, teacher)
        conf = confusion_matrix(up.argmax(-1), labels, scfg.num_classes)
        dist.all_reduce_sum_([conf], group)
        return conf

    return step


def make_target_eval_step(scfg: StepConfig, device=None, group=None):
    """Target-group eval: ``step(state, tgt_images u8 [G,H,W,3],
    tgt_labels [G,H,W], generator) -> {layer: int64 confusion [C, C]}`` for
    the reference's four layers (logits_up / teacher_init /
    teacher_refined / teacher_labels, train.py:388).

    The refine/pseudo-label chain runs with the training ``refine_res`` /
    ``refine_dtype``, so teacher_refined/teacher_labels measure the labels
    training consumes.  ``generator`` draws the target augmentation.  With
    a process ``group`` the confusions are summed over its ranks (one
    all-reduce)."""
    device = resolve_device(device)
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = _DTYPES[scfg.refine_dtype]
    c = scfg.num_classes

    @torch.no_grad()
    def step(state, tgt_images, tgt_labels, generator):
        images, labels = _to_device(device, tgt_images, tgt_labels)
        views = augment_target(scfg, generator, images, labels)
        _, student_up = _eval_forward(state, views.frames_aug)
        t_logits, t_up = _eval_forward(state, views.frames_clean, True)
        refined, _ = sac_refine.refine(
            t_logits, views.affine, views.affine_inv, views.padding,
            group_size=scfg.group_size, pool=scfg.pool, pool_on=scfg.pool_on,
            compute_dtype=rd, res=scfg.refine_res)
        pseudo, _, _ = sac_core.pseudo_labels(
            refined, views.padding, state.running_conf,
            upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
            threshold_beta=scfg.threshold_beta, discount=scfg.conf_discount,
            compute_dtype=rd_pl)
        confs = {
            "logits_up": confusion_matrix(student_up.argmax(-1),
                                          views.labels, c),
            "teacher_init": confusion_matrix(t_up.argmax(-1), views.labels,
                                             c),
            "teacher_refined": confusion_matrix(refined.argmax(-1),
                                                views.labels, c),
            "teacher_labels": confusion_matrix(pseudo, views.labels, c),
        }
        dist.all_reduce_sum_(list(confs.values()), group)
        return confs

    return step


def make_visual_step(scfg: StepConfig, device=None):
    """Full target-branch outputs for visualisation panels (the reference's
    TB diagnostics, base_trainer.py:118-191): ``step(state, tgt_images,
    tgt_labels, generator) -> (views, refined_probs, pseudo_labels,
    student_logits_up, diags)``; ``diags`` holds ``teacher_aligned`` (the
    teacher's probability maps warped into the reference frame) and
    ``frames_aligned`` (the clean frames warped the same way) when the
    views are pooled.

    The refine chain is always the full-resolution f32 one, whatever
    ``refine_res``/``refine_dtype`` say: the panels need the full-resolution
    aligned maps, which the stride-8 chain does not form."""
    device = resolve_device(device)

    @torch.no_grad()
    def step(state, tgt_images, tgt_labels, generator):
        images, labels = _to_device(device, tgt_images, tgt_labels)
        views = augment_target(scfg, generator, images, labels)
        t_logits, _ = _eval_forward(state, views.frames_clean, True)
        refined, rdiags = sac_refine.refine(
            t_logits, views.affine, views.affine_inv, views.padding,
            group_size=scfg.group_size, pool=scfg.pool, pool_on=scfg.pool_on)
        pseudo, _, _ = sac_core.pseudo_labels(
            refined, views.padding, state.running_conf,
            upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
            threshold_beta=scfg.threshold_beta, discount=scfg.conf_discount)
        _, student_up = _eval_forward(state, views.frames_aug)
        diags = {}
        if "teacher_aligned" in rdiags:
            diags["teacher_aligned"] = rdiags["teacher_aligned"]
            diags["frames_aligned"] = warp_affine(views.frames_clean,
                                                  views.affine)
        return views, refined, pseudo, student_up, diags

    return step
