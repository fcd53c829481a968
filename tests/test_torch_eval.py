"""The port's metrics and eval steps (dasac_tpu_torch/train/metrics.py and
the eval builders of train/steps.py) against dasac_tpu on the CPU.

Metrics: random predictions and labels (10% ignored); the port's int64
confusion equals the JAX float confusion exactly; tp/fp/fn, IoU, precision,
recall and mean IoU within 1e-6 (the port divides in float64, JAX in
float32).

Eval steps: the tiny arch (the same weights on both sides, carried across
with ``train_state_from_jax``), 32x48 frames, 19 classes, f32 weights, a
teacher distinct from the student and a non-trivial ``running_conf``.  The
target augmentation of both sides uses the draws ``jax.random`` made (the
port's sampler is replaced by them).  Each side's confusions are formed
from the same (prediction, label) pairs; the only pixels allowed to differ
are masked to label 255 before comparing:
  * argmax ties: the top-2 gap of the JAX scores under 1e-4 (f32) or,
    for the bf16 refined probabilities, under 2^-6 of the top value (2 to
    4 bf16 ulps; the two sides' argmax differ at gaps up to 2^-7 here, and
    the near-uniform probabilities of random weights put ~5% of pixels
    under 2^-6);
  * nearest-sampled labels that differ after the warp (< 0.5% of pixels,
    as tests/test_torch_aug.py bounds them);
  * teacher pseudo-labels that differ (< 1%, as tests/test_torch_step.py
    bounds them).
After that mask the confusions are equal.  The visual step's refined
probabilities agree within rtol 1e-3 / atol 1e-5, the aligned maps and
frames within 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.core.state import TrainState as JState
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.sac import core as jcore
from dasac_tpu.sac import refine as jrefine
from dasac_tpu.train import metrics as jmetrics
from dasac_tpu.train import steps as jsteps
from dasac_tpu_torch.aug import pipelines as tpipe
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import train_state_from_jax
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import metrics as tmetrics
from dasac_tpu_torch.train import optim as toptim
from dasac_tpu_torch.train import steps as tsteps
from tests.test_torch_aug import _target_draws, _torch_draws
from tests.test_torch_nn import _randomize_stats

C = 19
H, W = 32, 48
G, T = 2, 3
ARCH = "tiny"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _pred_gt(seed, shape=(3, 17, 23)):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, C, shape).astype(np.int32)
    gt[rng.rand(*shape) < 0.1] = 255
    # predictions agree with gt on ~half the pixels, so the diagonal is
    # not empty
    pred = np.where(rng.rand(*shape) < 0.5, np.where(gt == 255, 0, gt),
                    rng.randint(0, C, shape)).astype(np.int32)
    return pred, gt


@pytest.mark.parametrize("shape", [(3, 17, 23), (40, 31), (5, 2, 7, 9)])
def test_confusion_matches_jax(shape):
    pred, gt = _pred_gt(0, shape)
    ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred),
                                               jnp.asarray(gt), C))
    ours = tmetrics.confusion_matrix(_t(pred), _t(gt), C)
    assert ours.dtype == torch.int64 and tuple(ours.shape) == (C, C)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert int(ours.sum()) == int((gt != 255).sum())
    # uint8 inputs, as the loaders give them
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(_t(pred.astype(np.uint8)),
                                  _t(gt.astype(np.uint8)), C).numpy(), ref)


def test_confusion_drops_predictions_outside_the_classes():
    """Predictions of 255 (unlabelled teacher pixels) are counted as JAX
    counts them: at ``gt*C + 255`` when that index is below C*C (row
    gt + 13, column 8 for C = 19), dropped otherwise.  The two confusions
    are equal on the unmasked inputs."""
    pred, gt = _pred_gt(1)
    pred[::2, ::3] = 255
    ours = tmetrics.confusion_matrix(_t(pred), _t(gt), C).numpy()
    ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred),
                                               jnp.asarray(gt), C))
    np.testing.assert_array_equal(ours, ref)
    folded = (gt != 255) & (pred == 255) & (gt * C + 255 < C * C)
    assert folded.any()
    assert ours.sum() == ((gt != 255) & (pred != 255)).sum() + folded.sum()
    # uint8 inputs, as the pseudo-labels come
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(_t(pred.astype(np.uint8)),
                                  _t(gt.astype(np.uint8)), C).numpy(), ref)


def test_summaries_and_stat_manager_match_jax():
    pred, gt = _pred_gt(2)
    conf_j = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), C)
    conf_t = tmetrics.confusion_matrix(_t(pred), _t(gt), C)
    for a, b in zip(tmetrics.tp_fp_fn(conf_t), jmetrics.tp_fp_fn(conf_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tmetrics.summarise(conf_t), jmetrics.summarise(conf_j)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for ign in ((), (0, 3), (18,)):
        np.testing.assert_allclose(tmetrics.mean_iou(conf_t, ign),
                                   jmetrics.mean_iou(conf_j, ign),
                                   rtol=1e-6)
    # an empty class row/column: 1e-3 floors the denominators
    empty = np.zeros((C, C), np.float32)
    for a, b in zip(tmetrics.summarise(torch.zeros(C, C, dtype=torch.int64)),
                    jmetrics.summarise(empty)):
        np.testing.assert_array_equal(a, b)

    ours, ref = tmetrics.StatManager(), jmetrics.StatManager()
    for k, v, n in (("loss", 1.5, 2), ("loss", 0.5, 1), ("miou", 0.25, 1)):
        ours.update_stats(k, v, n)
        ref.update_stats(k, v, n)
    assert dict(ours.items()) == dict(ref.items())
    assert list(ours.keys()) == list(ref.keys())
    assert ours.has_vals("loss") and not ours.has_vals("other")


# ---------------------------------------------------------------------------
# eval steps
# ---------------------------------------------------------------------------

def _scfg(mod, **kw):
    return mod.StepConfig(
        num_classes=C, crop_hw=(H, W), group_size=T, run_conf_lower=0.01,
        guided_hflip=True, tgt_blur=True, tgt_jitter=0.4, tgt_greyscale=0.2,
        **kw)


class _MC:
    LR = 0.01
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


@pytest.fixture(scope="module")
def states():
    """The same student, teacher and running_conf on both sides."""
    jmodel = jbuild(ARCH, C)
    init = jmodel.init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((1, H, W, 3)), train=False,
                       update_stats=False)
    student = _randomize_stats(init, 1)
    teacher = _randomize_stats(init, 2)
    running_conf = np.random.RandomState(3).uniform(
        0.01, 0.2, C).astype(np.float32)
    jstate = JState(
        params=student["params"], batch_stats=student["batch_stats"],
        teacher_params=teacher["params"],
        teacher_stats=teacher["batch_stats"], opt_state=(),
        running_conf=jnp.asarray(running_conf),
        slow_init=jnp.ones((), jnp.float32), step=jnp.zeros((), jnp.int32))
    model = build_model(ARCH, C, device="cpu")
    state = create_train_state(
        model, toptim.build_optimizer(_MC, ARCH, model), C, device="cpu")
    train_state_from_jax(
        dict(params=student["params"], batch_stats=student["batch_stats"],
             teacher_params=teacher["params"],
             teacher_stats=teacher["batch_stats"],
             running_conf=running_conf, slow_init=1.0, step=0), ARCH, state)
    return jmodel, jstate, state


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, C, (n, H, W)).astype(np.int32)
    labels[:, :4] = 255
    return imgs, labels


def _ties(scores, gap, relative=False):
    top2 = np.sort(np.asarray(scores, np.float32), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap * (top2[..., 1] if relative
                                                   else 1.0)


@pytest.mark.parametrize("teacher", [False, True])
def test_eval_step_matches_jax(states, teacher):
    from dasac_tpu.aug import photometric as jP

    jmodel, jstate, state = states
    imgs, labels = _frames(4, 3)
    variables = ({"params": jstate.teacher_params,
                  "batch_stats": jstate.teacher_stats} if teacher else
                 {"params": jstate.params, "batch_stats": jstate.batch_stats})
    x = jP.normalize(jnp.asarray(imgs, jnp.float32) / 255.0,
                     (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    _, up = jmodel.apply(variables, x, train=False, update_stats=False)
    tie = _ties(up, 1e-4)
    assert tie.mean() < 0.01
    labels = np.where(tie, 255, labels).astype(np.int32)

    ref = jsteps.make_eval_step(jmodel, _scfg(jsteps), teacher=teacher)(
        jstate, jnp.asarray(imgs), jnp.asarray(labels))
    ours = tsteps.make_eval_step(_scfg(tsteps), device="cpu",
                                 teacher=teacher)(state, imgs, labels)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(ours.sum()) == int((labels != 255).sum())


def _jax_target_pieces(jmodel, jstate, scfg, imgs, labels, key):
    """The JAX target-eval step's body, op for op, with its intermediate
    tensors kept (checked against the step's own confusions)."""
    rd = jnp.bfloat16 if scfg.refine_dtype == "bfloat16" else None
    rd_pl = jnp.bfloat16 if scfg.refine_dtype == "bfloat16" else jnp.float32
    views = jpipe.augment_target_groups(
        key, jnp.asarray(imgs), jnp.asarray(labels), group_size=T,
        target_scale=scfg.target_scale, zoom=scfg.zoom,
        group_hflip=scfg.group_hflip, guided_hflip=scfg.guided_hflip,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale, mean=scfg.mean, std=scfg.std)
    _, s_up = jmodel.apply({"params": jstate.params,
                            "batch_stats": jstate.batch_stats},
                           views.frames_aug, train=False, update_stats=False)
    t_logits, t_up = jmodel.apply({"params": jstate.teacher_params,
                                   "batch_stats": jstate.teacher_stats},
                                  views.frames_clean, train=False,
                                  update_stats=False)
    refined, _ = jrefine.refine(
        t_logits, views.affine, views.affine_inv, views.padding,
        group_size=T, pool=scfg.pool, pool_on=scfg.pool_on, compute_dtype=rd,
        res=scfg.refine_res)
    pseudo, _, _ = jcore.pseudo_labels(
        refined, views.padding, jstate.running_conf,
        upper=scfg.run_conf_upper, lower=scfg.run_conf_lower,
        threshold_beta=scfg.threshold_beta, discount=scfg.conf_discount,
        compute_dtype=rd_pl)
    return views, {"logits_up": s_up, "teacher_init": t_up,
                   "teacher_refined": refined, "teacher_labels": pseudo}


def _use_jax_draws(monkeypatch, key, scfg):
    draws = _torch_draws(_target_draws(
        key, G, T, target_scale=scfg.target_scale, zoom=scfg.zoom,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale))
    monkeypatch.setattr(tpipe, "sample_target_draws",
                        lambda *a, **k: draws)


@pytest.mark.parametrize("res,dtype", [("stride8", "bfloat16"),
                                       ("full", "float32")])
def test_target_eval_step_matches_jax(states, monkeypatch, res, dtype):
    jmodel, jstate, state = states
    imgs, labels = _frames(5, G)
    key = jax.random.PRNGKey(21)
    jscfg = _scfg(jsteps, refine_res=res, refine_dtype=dtype)
    ref = jsteps.make_target_eval_step(jmodel, jscfg)(
        jstate, jnp.asarray(imgs), jnp.asarray(labels), key)
    views, pieces = _jax_target_pieces(jmodel, jstate, jscfg, imgs, labels,
                                       key)
    jlabels = np.asarray(views.labels)
    for name, p in pieces.items():
        pred = p if name == "teacher_labels" else jnp.argmax(p, -1)
        np.testing.assert_array_equal(
            np.asarray(jmetrics.confusion_matrix(pred, views.labels, C)),
            np.asarray(ref[name]), err_msg="replica of the JAX step: " + name)

    seen = {}

    def record(pred, gt, num_classes, ignore=255):
        seen.setdefault("pairs", []).append((pred.clone(), gt.clone()))
        return tmetrics.confusion_matrix(pred, gt, num_classes, ignore)

    monkeypatch.setattr(tsteps, "confusion_matrix", record)
    _use_jax_draws(monkeypatch, key, jscfg)
    ours = tsteps.make_target_eval_step(
        _scfg(tsteps, refine_res=res, refine_dtype=dtype), device="cpu")(
        state, imgs, labels, torch.Generator())
    assert list(ours) == ["logits_up", "teacher_init", "teacher_refined",
                          "teacher_labels"]

    pseudo_j = np.asarray(pieces["teacher_labels"])
    assert np.mean(pseudo_j != 255) > 0.05, "no teacher labels to compare"
    for (name, conf_t), (pred_t, gt_t) in zip(ours.items(), seen["pairs"]):
        p = pieces[name]
        np.testing.assert_array_equal(
            conf_t.numpy(), tmetrics.confusion_matrix(pred_t, gt_t,
                                                      C).numpy())
        pred_j = np.asarray(p if name == "teacher_labels"
                            else jnp.argmax(p, -1))
        pred_t, gt_t = pred_t.numpy(), gt_t.numpy()
        label_diff = gt_t != jlabels
        assert label_diff.mean() < 0.005, name
        if name == "teacher_labels":
            mask = pred_t != pred_j
            assert mask.mean() < 0.01, (name, mask.mean())
        else:
            bf16 = name == "teacher_refined" and dtype == "bfloat16"
            mask = (_ties(p, 2.0 ** -6, relative=True) if bf16
                    else _ties(p, 1e-4))
            assert mask.mean() < (0.1 if bf16 else 0.01), (name, mask.mean())
        mask |= label_diff
        gt_m = np.where(mask, 255, jlabels)
        np.testing.assert_array_equal(
            tmetrics.confusion_matrix(_t(pred_t), _t(gt_m), C).numpy(),
            np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred_j),
                                                 jnp.asarray(gt_m), C)),
            err_msg=name)


def test_visual_step_matches_jax(states, monkeypatch):
    """Shipped training settings (stride8/bf16): the visual step still runs
    the full-resolution f32 chain."""
    jmodel, jstate, state = states
    imgs, labels = _frames(6, G)
    key = jax.random.PRNGKey(22)
    jscfg = _scfg(jsteps, refine_res="stride8", refine_dtype="bfloat16")
    jviews, jrefined, jpseudo, jup, jdiags = jsteps.make_visual_step(
        jmodel, jscfg)(jstate, jnp.asarray(imgs), jnp.asarray(labels), key)
    _use_jax_draws(monkeypatch, key, jscfg)
    views, refined, pseudo, up, diags = tsteps.make_visual_step(
        _scfg(tsteps, refine_res="stride8", refine_dtype="bfloat16"),
        device="cpu")(state, imgs, labels, torch.Generator())

    for name in ("frames_aug", "frames_clean", "affine", "affine_inv"):
        np.testing.assert_allclose(getattr(views, name).numpy(),
                                   np.asarray(getattr(jviews, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert refined.dtype == torch.float32
    np.testing.assert_allclose(refined.numpy(), np.asarray(jrefined),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=1e-4,
                               atol=1e-5)
    pj = np.asarray(jpseudo)
    assert np.mean(pj != 255) > 0.05
    assert np.mean(pseudo.numpy() != pj) < 0.01
    assert set(diags) == set(jdiags) == {"teacher_aligned", "frames_aligned"}
    for name in diags:
        np.testing.assert_allclose(
            diags[name].reshape(np.shape(jdiags[name])).numpy(),
            np.asarray(jdiags[name]), rtol=1e-5, atol=1e-5, err_msg=name)
