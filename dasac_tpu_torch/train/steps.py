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

Spans (``utils/spans.py``, recorded only under a profiler or
``spans.recording()``): ``step.sac`` encloses a whole SAC step call, with
``aug`` (the batch's copy to the device and ``augment_sac``), ``ema``
(``_update_teacher``), ``teacher`` (the teacher forward), ``refine``
(refine, running confidence, pseudo-labels), ``src_grad`` and ``tgt_grad``
(each branch's forward, loss and backward) and ``optim`` (the gradients'
average, the optimizer step, the metrics) inside; ``step.abn`` encloses an
ABN step call, with ``aug``, ``src_grad``, ``optim`` and ``tgt_stats``
(the target pass and the metrics) inside.  The gspmd steps have the same
spans at the same places.

gspmd (``TPU.PARTITION`` gspmd, the ``make_gspmd_*`` builders; the
counterpart of ``dasac_tpu``'s ``gspmd_train_step`` and its siblings):
the ranks of a ``(data, sp)`` world (``core.mesh.TrainGroups``) run the
GLOBAL-batch step together.  Rank ``(d, s)`` holds data slice ``d`` of
the batch as whole frames; the augmentation draws cover the global batch
from the one generator every rank holds, and slice ``d`` is applied
(dropout masks too, ``nn.layers.batch_slice``), so the ``sp`` ranks of a
slice hold the same frames.  Each forward runs on this rank's rows
``spatial.split(H, n_sp, s)`` of them (``nn/spatial.py``); the teacher's
stride-8 logits are all-gathered over ``sp``, refined on whole frames,
and the pseudo-labels and confidences cut to this rank's rows.  The
losses are this rank's shares (``sac.core.Share``: local means times
the rank's share of the pixels), the gradients are SUMMED over the
world, the metrics are the sums of the shares, and the eval confusions
count each rank's own rows, summed over the world.  In a world of one
the steps are bit-equal to the one-process steps.
"""

import contextlib
from typing import NamedTuple, Tuple

import torch
from torch.func import functional_call

from dasac_tpu_torch.aug import photometric as P
from dasac_tpu_torch.aug import pipelines
from dasac_tpu_torch.aug.warp import warp_affine
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core.device import resolve_device
from dasac_tpu_torch.nn import layers, spatial
from dasac_tpu_torch.sac import core as sac_core
from dasac_tpu_torch.sac import refine as sac_refine
from dasac_tpu_torch.train.metrics import confusion_matrix
from dasac_tpu_torch.utils.spans import span

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


def augment_target(scfg, generator, images, labels, part=None):
    """The target groups' views under ``scfg``'s target augmentation
    (``part``: see ``aug/pipelines.py``)."""
    return pipelines.augment_target_groups(
        generator, images, labels, group_size=scfg.group_size,
        target_scale=scfg.target_scale, zoom=scfg.zoom,
        group_hflip=scfg.group_hflip, guided_hflip=scfg.guided_hflip,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale, mean=scfg.mean, std=scfg.std,
        part=part)


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
        with span("step.sac", device):
            with span("aug"):
                inputs = augment_sac(scfg, generator,
                                     _to_device(device, *batch))
            return views_step(state, *inputs, generator)

    return step


def augment_sac(scfg: StepConfig, generator, batch, part=None):
    """The SAC step's augmentation: ``batch`` = (src_images, src_labels,
    tgt_images, tgt_labels) on one device -> (src_frames, src_lbls,
    views); ``part``: see ``aug/pipelines.py``."""
    src_images, src_labels, tgt_images, tgt_labels = batch
    src_frames, src_lbls = pipelines.augment_source_batch(
        generator, src_images, src_labels, crop_hw=scfg.crop_hw,
        scale_range=scfg.src_scale, hflip=scfg.src_hflip,
        jitter=scfg.src_jitter, blur=scfg.src_blur,
        mean=scfg.src_mean, std=scfg.src_std, part=part)
    views = augment_target(scfg, generator, tgt_images, tgt_labels, part)
    return src_frames, src_lbls, views


def _update_teacher(state, scfg):
    """The teacher EMA / lazy init (sac.py:70-102, train.py:294): the
    teacher's tensors by name, then ``maybe_update_teacher``'s
    ``(slow_init, running_conf, teacher_diff)``.  The lazy init runs
    whenever it has not happened yet (the step counter is global, the
    reference's per epoch)."""
    do_update = (state.step % scfg.net_momentum_iter == 0
                 or not state.slow_init)
    student = {**state.student_params(), **state.student_stats()}
    teacher = {**state.teacher_params, **state.teacher_stats}
    names = list(teacher)
    with torch.no_grad():
        return (teacher, *sac_core.maybe_update_teacher(
            [teacher[k] for k in names],
            [student[k].detach() for k in names],
            state.slow_init, state.running_conf,
            momentum=scfg.net_momentum,
            threshold_beta=scfg.threshold_beta, do_update=do_update))


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

        with span("ema"):
            teacher, slow_init, running_conf, teacher_diff = (
                _update_teacher(state, scfg))
        with torch.no_grad():
            # ---- teacher branch on clean views (no grad) ------------------
            with span("teacher"):
                t_logits, _ = functional_call(
                    model, teacher, (views.frames_clean,),
                    dict(train=False, update_stats=False))
            with span("refine"):
                refined, diags = sac_refine.refine(
                    t_logits, views.affine, views.affine_inv, views.padding,
                    group_size=scfg.group_size, pool=scfg.pool,
                    pool_on=scfg.pool_on, compute_dtype=rd,
                    res=scfg.refine_res)
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
        with span("src_grad"):
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
        with span("tgt_grad"):
            _, tgt_up = model(views.frames_aug, train=True,
                              update_stats=False, generator=generator)
            self_ce, per_class = sac_core.focal_ce(
                tgt_up, pseudo, conf, running_conf, p=scfg.focal_p,
                use_conf=scfg.use_conf_loss, compute_dtype=ld,
                impl=scfg.ce_impl)
            (scfg.lr_target * self_ce).backward()
            del tgt_up
        with span("optim"):
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
        with span("step.abn", device):
            with span("aug"):
                inputs = augment_abn(scfg, generator,
                                     _to_device(device, *batch))
            return frames_step(state, *inputs, generator)

    return step


def augment_abn(scfg: StepConfig, generator, batch, part=None):
    """The ABN step's augmentation: ``batch`` = (src_images, src_labels,
    tgt_images, tgt_labels) on one device -> (src_frames, src_lbls,
    tgt_frames, tgt_lbls).  Both halves go through the source pipeline; the
    source frames are normalized with ``src_mean``/``src_std``, the target
    frames with the standard ``mean``/``std``.  ``part``: see
    ``aug/pipelines.py``."""
    out = ()
    for images, labels, mean, std in (
            (*batch[:2], scfg.src_mean, scfg.src_std),
            (*batch[2:], scfg.mean, scfg.std)):
        out += pipelines.augment_source_batch(
            generator, images, labels, crop_hw=scfg.crop_hw,
            scale_range=scfg.src_scale, hflip=scfg.src_hflip,
            jitter=scfg.src_jitter, blur=scfg.src_blur, mean=mean, std=std,
            part=part)
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
        with span("src_grad"):
            opt.zero_grad(set_to_none=True)
            _, src_up = model(src_frames, train=True, update_stats=True,
                              generator=generator)
            ce_src = sac_core.cross_entropy_mean(src_up, src_lbls,
                                                 impl=scfg.ce_impl)
            ce_src.backward()
            del src_up
        with span("optim"):
            _average_grads(model, group)
            opt.step()

        # target pass: BN statistics only, no gradient (train.py:286-289)
        with span("tgt_stats"):
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


# ---------------------------------------------------------------------------
# gspmd: the global-batch steps over a (data, sp) world
# ---------------------------------------------------------------------------

class Global:
    """This rank's place in a gspmd world (``groups``: a
    ``core.mesh.TrainGroups``): its data slice and rows of the global
    batch."""

    def __init__(self, groups):
        self.groups = groups
        self.part = (groups.n_data, groups.d)
        self.sharded = (spatial.Sharded(groups.sp) if groups.n_sp > 1
                        else None)

    @contextlib.contextmanager
    def frame(self):
        """The context of one forward on this rank's rows: yields the
        ``spatial.Frame`` (``None`` for whole frames)."""
        with layers.batch_slice(*self.part), (
                self.sharded.frame() if self.sharded is not None
                else contextlib.nullcontext()) as f:
            yield f

    def run(self, fn, x):
        """``fn`` of this rank's rows of the whole frames ``x``."""
        with self.frame() as f:
            return fn(x if f is None else f.shard(x, 1))

    def rows(self, x):
        """This rank's rows of the whole frames ``x`` (rows on axis 1)."""
        if self.sharded is None:
            return x
        lo, hi = self.sharded.own(x.shape[1])
        return x.narrow(1, lo, hi - lo)

    def share(self, whole):
        """The ``sac.core.Share`` of this rank's rows of the slice
        ``whole`` (``[B, H, ...]``) of the global batch."""
        g = self.groups
        h = whole.shape[1]
        lo, hi = spatial.split(h, g.n_sp, g.s)
        views = 1.0 / g.n_data
        return sac_core.Share(g.world, views * ((hi - lo) / h), views,
                              g.data)

    def sum(self, tensors):
        """The metrics: each rank's shares, summed over the world."""
        out = {k: v.detach().clone() for k, v in tensors.items()}
        dist.all_reduce_sum_(list(out.values()), self.groups.world)
        return out


def _teacher_forward(glob, model, teacher, frames, upsample):
    """The teacher's forward on this rank's rows of the whole frames: its
    stride-8 logits all-gathered over ``sp`` (whole frames), and the
    upsampled logits of this rank's rows (``None`` without
    ``upsample``)."""
    kw = dict(train=False, update_stats=False, upsample=upsample)
    with glob.frame() as f:
        x = frames if f is None else f.shard(frames, 1)
        logits, up = functional_call(model, teacher, (x,), kw)
        if f is not None:
            logits = f.all_gather(logits, 1, f.rows(logits, 1))
    return logits, up


def make_gspmd_sac_step(scfg: StepConfig, groups, device=None):
    """:func:`make_sac_step` over a gspmd world: ``batch`` is this rank's
    data slice (``groups.d``) of the global batch, whole frames."""
    device = resolve_device(device)
    glob = Global(groups)
    views_step = make_gspmd_sac_views_step(scfg, groups)

    def step(state, batch, generator):
        with span("step.sac", device):
            with span("aug"):
                inputs = augment_sac(scfg, generator,
                                     _to_device(device, *batch), glob.part)
            return views_step(state, *inputs, generator)

    return step


def make_gspmd_sac_views_step(scfg: StepConfig, groups):
    """:func:`make_sac_views_step` over a gspmd world: the inputs are this
    rank's data slice of the pre-augmented global batch (whole frames);
    every rank computes the global step's update (the module's
    docstring)."""
    glob = Global(groups)
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = _DTYPES[scfg.refine_dtype]
    ld = _DTYPES[scfg.loss_dtype]

    def views_step(state, src_frames, src_lbls, views, generator=None):
        model, opt = state.model, state.optimizer
        with span("ema"):
            teacher, slow_init, running_conf, teacher_diff = (
                _update_teacher(state, scfg))
        with torch.no_grad():
            with span("teacher"):
                t_logits, _ = _teacher_forward(glob, model, teacher,
                                               views.frames_clean, False)
            with span("refine"):
                refined, diags = sac_refine.refine(
                    t_logits, views.affine, views.affine_inv, views.padding,
                    group_size=scfg.group_size, pool=scfg.pool,
                    pool_on=scfg.pool_on, compute_dtype=rd,
                    res=scfg.refine_res)
                probs = diags["teacher_probs"]
                running_conf = sac_core.update_running_conf(
                    running_conf, glob.rows(probs), scfg.stat_momentum,
                    scfg.threshold_beta, share=glob.share(probs))
                pseudo, conf, _ = sac_core.pseudo_labels(
                    refined, views.padding, running_conf,
                    upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
                    threshold_beta=scfg.threshold_beta,
                    discount=scfg.conf_discount, compute_dtype=rd_pl)
                share = glob.share(pseudo)
                pseudo, conf = glob.rows(pseudo), glob.rows(conf)
            del t_logits, diags, refined, probs

        # ---- source backward, then target backward, on this rank's rows --
        kw = dict(train=True, update_stats=False, generator=generator)
        with span("src_grad"):
            opt.zero_grad(set_to_none=True)
            if scfg.target_only:
                ce_src = torch.zeros((), device=running_conf.device)
            else:
                _, src_up = glob.run(lambda x: model(x, **kw), src_frames)
                ce_src = sac_core.cross_entropy_mean(
                    src_up, glob.rows(src_lbls), compute_dtype=ld,
                    impl=scfg.ce_impl, share=glob.share(src_lbls))
                ce_src.backward()
                del src_up
        with span("tgt_grad"):
            _, tgt_up = glob.run(lambda x: model(x, **kw), views.frames_aug)
            self_ce, per_class = sac_core.focal_ce(
                tgt_up, pseudo, conf, running_conf, p=scfg.focal_p,
                use_conf=scfg.use_conf_loss, compute_dtype=ld,
                impl=scfg.ce_impl, share=share)
            (scfg.lr_target * self_ce).backward()
            del tgt_up
        with span("optim"):
            dist.all_reduce_sum_grads_(model.parameters(), groups.world)
            opt.step()

            state.running_conf = running_conf
            state.slow_init = slow_init
            state.step += 1
            metrics = glob.sum({
                "src_loss_ce": ce_src,
                "self_ce": self_ce,
                "pseudo_cover": (pseudo != sac_core.IGNORE).float().mean()
                                * share.frac,
                "self_ce_per_class": per_class,
            })
        metrics["teacher_diff"] = teacher_diff   # the same on every rank
        return metrics

    return views_step


def make_gspmd_abn_step(scfg: StepConfig, groups, device=None):
    """:func:`make_abn_step` over a gspmd world: ``batch`` is this rank's
    data slice of the global batch."""
    device = resolve_device(device)
    glob = Global(groups)
    frames_step = make_gspmd_abn_frames_step(scfg, groups)

    def step(state, batch, generator):
        with span("step.abn", device):
            with span("aug"):
                inputs = augment_abn(scfg, generator,
                                     _to_device(device, *batch), glob.part)
            return frames_step(state, *inputs, generator)

    return step


def make_gspmd_abn_frames_step(scfg: StepConfig, groups):
    """:func:`make_abn_frames_step` over a gspmd world, on this rank's
    data slice of the pre-augmented global batch: the live BN statistics
    are those of the global batch (sums and counts over the world under
    ``sp``), the source loss this rank's share, the gradients summed."""
    glob = Global(groups)

    def frames_step(state, src_frames, src_lbls, tgt_frames, tgt_lbls,
                    generator=None):
        model, opt = state.model, state.optimizer
        kw = dict(train=True, update_stats=True, generator=generator)
        with span("src_grad"):
            opt.zero_grad(set_to_none=True)
            _, src_up = glob.run(lambda x: model(x, **kw), src_frames)
            ce_src = sac_core.cross_entropy_mean(
                src_up, glob.rows(src_lbls), impl=scfg.ce_impl,
                share=glob.share(src_lbls))
            ce_src.backward()
            del src_up
        with span("optim"):
            dist.all_reduce_sum_grads_(model.parameters(), groups.world)
            opt.step()

        with span("tgt_stats"):
            with torch.no_grad():
                _, tgt_up = glob.run(lambda x: model(x, **kw), tgt_frames)
                ce_tgt = sac_core.cross_entropy_mean(
                    tgt_up, glob.rows(tgt_lbls), impl=scfg.ce_impl,
                    share=glob.share(tgt_lbls))
            state.step += 1
            return glob.sum({"src_loss_ce": ce_src, "loss_ce": ce_tgt})

    return frames_step


def make_gspmd_eval_step(scfg: StepConfig, groups, device=None,
                         teacher=False):
    """:func:`make_eval_step` over a gspmd world: this rank's data slice
    of the global batch; the confusion counts this rank's rows, summed
    over the world."""
    device = resolve_device(device)
    glob = Global(groups)

    @torch.no_grad()
    def step(state, images_u8, labels):
        images_u8, labels = _to_device(device, images_u8, labels)
        x = P.normalize(images_u8.float() / 255.0, scfg.mean, scfg.std)
        _, up = glob.run(lambda xs: _eval_forward(state, xs, teacher), x)
        conf = confusion_matrix(up.argmax(-1), glob.rows(labels),
                                scfg.num_classes)
        dist.all_reduce_sum_([conf], groups.world)
        return conf

    return step


def make_gspmd_target_eval_step(scfg: StepConfig, groups, device=None):
    """:func:`make_target_eval_step` over a gspmd world: the draws of the
    global batch's augmentation, this rank's slice applied; the forwards
    on this rank's rows, the refine chain on whole frames; every
    confusion counts this rank's rows, summed over the world."""
    device = resolve_device(device)
    glob = Global(groups)
    rd = torch.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = _DTYPES[scfg.refine_dtype]
    c = scfg.num_classes

    @torch.no_grad()
    def step(state, tgt_images, tgt_labels, generator):
        images, labels = _to_device(device, tgt_images, tgt_labels)
        views = augment_target(scfg, generator, images, labels, glob.part)
        _, student_up = glob.run(lambda xs: _eval_forward(state, xs),
                                 views.frames_aug)
        t_logits, t_up = _teacher_forward(
            glob, state.model, {**state.teacher_params, **state.teacher_stats},
            views.frames_clean, True)
        refined, _ = sac_refine.refine(
            t_logits, views.affine, views.affine_inv, views.padding,
            group_size=scfg.group_size, pool=scfg.pool, pool_on=scfg.pool_on,
            compute_dtype=rd, res=scfg.refine_res)
        pseudo, _, _ = sac_core.pseudo_labels(
            refined, views.padding, state.running_conf,
            upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
            threshold_beta=scfg.threshold_beta, discount=scfg.conf_discount,
            compute_dtype=rd_pl)
        lbl = glob.rows(views.labels)
        confs = {
            "logits_up": confusion_matrix(student_up.argmax(-1), lbl, c),
            "teacher_init": confusion_matrix(t_up.argmax(-1), lbl, c),
            "teacher_refined": confusion_matrix(
                glob.rows(refined.argmax(-1)), lbl, c),
            "teacher_labels": confusion_matrix(glob.rows(pseudo), lbl, c),
        }
        dist.all_reduce_sum_(list(confs.values()), groups.world)
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
