"""The port's inference program (dasac_tpu_torch/infer/engine.py) and its
resize (``nn/functional.resize_linear``) against dasac_tpu on the CPU.

``resize_linear`` against ``jax.image.resize(..., "linear")``, up and down
(antialiased when it shrinks), odd sizes included: within 1e-6 everywhere,
borders included (the largest gap measured is 1.8e-7, f32 roundoff of the
renormalized edge taps).

``make_infer_fn`` on the tiny arch (the same weights on both sides), a
2x32x48 uint8 batch, 19 classes, in the three settings of
tests/test_infer_tools.py (single scale; scales 0.75/1.0 with flip; the
same fused at stride 8): probabilities within atol 1e-5; labels equal
after masking the pixels whose top-2 JAX probability gap is under 1e-5
(argmax ties, < 1% of pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasac_tpu.infer import engine as jengine
from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu_torch.infer import engine as tengine
from dasac_tpu_torch.nn.functional import resize_linear
from tests.test_torch_nn import _port_model, _randomize_stats

C = 19
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 48), (24, 36)),    # 0.75: antialiased shrink
    ((33, 47), (25, 35)),    # odd sizes
    ((16, 20), (7, 9)),      # strong shrink
    ((32, 48), (40, 60)),    # 1.25: upsample
    ((10, 10), (23, 17)),    # up on one side, different factors
])
def test_resize_linear_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(0).rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_hw, 3),
                                      "linear"))
    ours = resize_linear(torch.from_numpy(x), out_hw)
    assert tuple(ours.shape) == (2, *out_hw, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild("tiny", C)
    variables = _randomize_stats(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 48, 3)),
        train=False, update_stats=False), 1)
    return jmodel, variables, _port_model("tiny", variables)


SETTINGS = [dict(scales=(1.0,)),
            dict(scales=(0.75, 1.0), flip=True),
            dict(scales=(0.75, 1.0), flip=True, fuse="stride8")]


@pytest.mark.parametrize("kw", SETTINGS, ids=["single", "multi_flip",
                                               "multi_flip_stride8"])
def test_infer_fn_matches_jax(models, kw):
    jmodel, variables, model = models
    img = (np.random.RandomState(2).rand(2, 32, 48, 3) * 255).astype(np.uint8)
    ref = np.asarray(jengine.make_infer_fn(jmodel, MEAN, STD, **kw)(
        variables, jnp.asarray(img)))
    probs = tengine.make_infer_fn(model, MEAN, STD, device="cpu", **kw)(img)
    assert probs.dtype == torch.float32 and tuple(probs.shape) == (2, 32, 48,
                                                                   C)
    np.testing.assert_allclose(probs.numpy(), ref, rtol=0, atol=1e-5)

    ref_lbl = np.asarray(jengine.make_infer_fn(
        jmodel, MEAN, STD, output="argmax", **kw)(variables,
                                                  jnp.asarray(img)))
    labels = tengine.make_infer_fn(model, MEAN, STD, output="argmax",
                                   device="cpu", **kw)(img)
    assert labels.dtype == torch.uint8 and tuple(labels.shape) == (2, 32, 48)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < 1e-5
    assert tie.mean() < 0.01
    np.testing.assert_array_equal(np.where(tie, 0, labels.numpy()),
                                  np.where(tie, 0, ref_lbl))
    # the port's own two outputs agree: the argmax program is the argmax of
    # the probabilities program
    np.testing.assert_array_equal(labels.numpy(),
                                  probs.argmax(-1).to(torch.uint8).numpy())


def test_infer_fn_rejects_unknown_modes(models):
    model = models[2]
    with pytest.raises(ValueError, match="fuse"):
        tengine.make_infer_fn(model, MEAN, STD, fuse="s4", device="cpu")
    with pytest.raises(ValueError, match="output"):
        tengine.make_infer_fn(model, MEAN, STD, output="logits", device="cpu")
