"""Algorithm-level check of the port: SAC self-training improves
target-domain mIoU on a synthetic source->target color shift (the port's
counterpart of ``tests/test_adaptation_improves.py``: the same scenes,
seeds, ``_MC`` settings, schedule and margin, through the port's SAC step
on the CPU).

The initial weights are ``dasac_tpu``'s for ``PRNGKey(0)``, carried across
with ``nn/convert.from_jax_variables``; the augmentation draws come from a
``torch.Generator`` seeded as the JAX test seeds its keys (9, then 5, the
same for every step), so the two trajectories share their start and data
but not their random streams.  Target-mIoU gains over the source-only
baseline, measured on the CPU: ``dasac_tpu`` +0.043 (0.196 -> 0.239,
source mIoU 0.599; its test's docstring quotes +0.076 from an earlier
run), the port +0.289 (0.098 -> 0.387, source mIoU 0.591; one thread,
deterministic).  Both tests assert the same margin, +0.02, below either
gain.

This is the gain the recipe on the card cannot show on its corpus: there
the r5 run's SAC student collapsed to 0.002 target mIoU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.train import optim, steps
from dasac_tpu_torch.train.metrics import mean_iou

C, HW = 5, (32, 48)


class _MC:
    LR = 3e-3
    WEIGHT_DECAY = 1e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9
    BETA1 = 0.5


def _scene(rng, colors, n):
    imgs, lbls = [], []
    for _ in range(n):
        m = np.zeros(HW, np.uint8)
        m[:] = rng.randint(0, C)
        for _ in range(4):
            k = rng.randint(0, C)
            y, x = rng.randint(0, HW[0] - 8), rng.randint(0, HW[1] - 12)
            m[y:y + rng.randint(6, 14), x:x + rng.randint(8, 18)] = k
        img = colors[m] + rng.randn(*HW, 3) * 18
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
        lbls.append(m)
    return np.stack(imgs), np.stack(lbls)


@pytest.fixture
def one_thread():
    """One intra-op thread: the steps are small, and several test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _generator(seed):
    return torch.Generator().manual_seed(seed)


def test_sac_adaptation_improves_target_miou(one_thread):
    rng = np.random.RandomState(0)
    src_colors = np.array([[200, 50, 50], [50, 200, 50], [50, 50, 200],
                           [200, 200, 50], [120, 120, 120]], float)
    tgt_colors = np.clip(src_colors * 0.55 + np.array([80, 30, -20]), 0, 255)
    src_i, src_l = _scene(rng, src_colors, 16)
    tgt_i, tgt_l = _scene(rng, tgt_colors, 16)

    v = jbuild("tiny", C).init({"params": jax.random.PRNGKey(0)},
                               jnp.zeros((1, *HW, 3)), train=False,
                               update_stats=False)
    model = build_model("tiny", C, device="cpu")
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, dict(v)), "tiny"), strict=True)
    state = create_train_state(model, optim.build_optimizer(_MC, "tiny",
                                                            model),
                               C, device="cpu")

    base = dict(num_classes=C, crop_hw=HW, group_size=4,
                src_scale=(0.9, 1.0), src_hflip=True)
    scfg0 = steps.StepConfig(lr_target=0.0, net_momentum_iter=10**6, **base)
    step0 = steps.make_sac_step(scfg0, device="cpu")
    ev = steps.make_eval_step(scfg0, device="cpu")

    def batch(i):
        s = rng.randint(0, 12)
        return (src_i[s:s + 4], src_l[s:s + 4], tgt_i[s:s + 2],
                tgt_l[s:s + 2])

    def miou(images, labels):
        return mean_iou(ev(state, images, labels.astype(np.int32)))

    # phase 1: source-only pretraining (lr_target = 0)
    for i in range(80):
        step0(state, batch(i), _generator(9))
    miou_src = miou(src_i, src_l)
    miou_before = miou(tgt_i, tgt_l)
    assert miou_src > 0.45, "source training failed: {}".format(miou_src)
    assert miou_before < miou_src - 0.15, "no domain gap to adapt across"

    # phase 2: SAC adaptation, the teacher re-initialized from the student
    scfg1 = steps.StepConfig(lr_target=2.0, net_momentum=0.9,
                             net_momentum_iter=5, run_conf_lower=0.1,
                             zoom=(0.7, 1.0), tgt_blur=True, tgt_jitter=0.3,
                             tgt_greyscale=0.0, **base)
    step1 = steps.make_sac_step(scfg1, device="cpu")
    state.slow_init, state.step = 0, 0
    for i in range(400):
        step1(state, batch(i), _generator(5))
    miou_after = miou(tgt_i, tgt_l)

    assert miou_after > miou_before + 0.02, (
        "SAC did not improve target mIoU: {:.3f} -> {:.3f}".format(
            miou_before, miou_after))
