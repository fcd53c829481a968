"""Remat (``TPU.REMAT`` none / block / convs) in the port
(``nn/layers.checkpointed``, ``nn/resnet.py``, ``nn/vgg.py``) against
``dasac_tpu`` on the CPU, at ``tests/test_remat_modes.py``'s size: one
48x64 frame, 5 classes, f32, frozen BN, the mean CE of the upsampled
logits.

  * each arch's loss and gradients in every mode against JAX's "none"
    (weights carried across with ``from_jax_variables``, which loads with
    ``strict=True`` into every mode): loss rtol 1e-5, each gradient within
    a relative L2 error of 2e-2 (JAX's own bound between its modes).  The
    ResNet is the reference's at full width with a shallow trunk
    (``layers=(1, 1, 2, 1)``: every block kind, a projecting first block
    and a plain one; depth only repeats them), the VGG archs whole; JAX's
    variables are drawn with numpy, not by ``init``, which alone takes
    ~20 s for FCN8s here;
  * the ``state_dict`` keys are the same in every mode (one model per
    arch and mode serves the whole module, its weights put back at every
    use);
  * ``remat_mode`` normalises and raises as JAX's does;
  * live BN: one forward + backward under block and convs leaves the
    running statistics equal to none's (atol 1e-6) and
    ``num_batches_tracked`` advanced by one: the replay does not update
    them again;
  * the backward replays every convolution under block, none under none
    and only the stem's under convs (the conv outputs are kept);
  * no chunk draws random numbers: FCN8s' channel dropout (outside every
    chunk) draws the same in every mode, and the backward leaves the
    generator and the global RNG as the forward left them;
  * a no-grad forward enters no checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dasac_tpu.nn.factory import build_model as jbuild
from dasac_tpu.nn.resnet import remat_mode as jremat_mode
from dasac_tpu_torch.nn import layers
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.nn.resnet import remat_mode
from tests.test_torch_nn import ShallowDeepLab

ARCHS = ("deeplabv2_resnet101", "deeplabv2_vgg16_bn", "fcn_vgg16_bn")
MODES = ("none", "block", "convs")
C = 5
LAYERS = (1, 1, 2, 1)


@pytest.fixture(scope="module")
def models():
    """``get(arch, mode)``: one model per arch and mode for the module
    (FCN8s alone takes ~2 s to build here), put back to the arch's first
    weights, buffers and no gradients at every call."""
    cache, first = {}, {}

    def get(arch, mode):
        if (arch, mode) not in cache:
            kw = dict(layers=LAYERS) if arch == "deeplabv2_resnet101" else {}
            cache[arch, mode] = build_model(arch, C, remat=mode,
                                            device="cpu", **kw)
            first.setdefault(arch, {k: v.clone() for k, v in
                                    cache[arch, mode].state_dict().items()})
        model = cache[arch, mode]
        model.load_state_dict(first[arch], strict=True)
        model.zero_grad(set_to_none=True)
        return model

    yield get
    cache.clear()
    first.clear()


def _inputs():
    rng = np.random.RandomState(7)
    return (rng.rand(1, 48, 64, 3).astype(np.float32),
            rng.randint(0, C, (1, 48, 64)))


def _variables(model, x, seed):
    """Flax variables of ``model`` drawn with numpy: He-normal kernels,
    BN scales near 1, statistics and biases away from the identity."""
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k}, x, train=False,
                             update_stats=False), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def jax_reference():
    """arch -> (the port's state_dict of JAX's variables, loss, gradients
    keyed like the port's parameters) of JAX's "none" mode, computed once
    per arch."""
    cache = {}
    x, labels = _inputs()

    def get(arch):
        if arch in cache:
            return cache[arch]
        model = (ShallowDeepLab(num_classes=C, layers=LAYERS)
                 if arch == "deeplabv2_resnet101"
                 else jbuild(arch, C, dtype=jnp.float32, remat="none"))
        variables = _variables(model, x, seed=len(cache))

        def loss_fn(params):
            _, up = model.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                x, train=False, update_stats=False)
            logp = jax.nn.log_softmax(up, -1)
            return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, C) * logp, -1))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"])
        grads = from_jax_variables(
            {"params": _np(grads), "batch_stats": variables["batch_stats"]},
            arch)
        cache[arch] = (from_jax_variables(variables, arch), float(loss),
                       grads)
        return cache[arch]

    return get


def _port_loss(model, x, labels):
    _, up = model(torch.from_numpy(x), train=False, update_stats=False)
    logp = torch.log_softmax(up, -1)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels), C)
    return -(onehot * logp).sum(-1).mean()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_in_every_mode(jax_reference, models,
                                                     arch, mode):
    weights, jloss, jgrads = jax_reference(arch)
    x, labels = _inputs()
    model = models(arch, mode)
    model.load_state_dict(weights, strict=True)
    loss = _port_loss(model, x, labels)
    loss.backward()
    assert np.isclose(float(loss.detach()), jloss, rtol=1e-5, atol=1e-7), (
        float(loss), jloss)
    for k, p in model.named_parameters():
        a = jgrads[k]
        rel = float(torch.linalg.vector_norm(a - p.grad)
                    / (torch.linalg.vector_norm(a) + 1e-30))
        assert rel < 2e-2, (k, rel)


@pytest.mark.parametrize("arch", ARCHS + ("tiny",))
def test_state_dict_keys_are_the_same_in_every_mode(models, arch):
    keys = [list(models(arch, m).state_dict()) for m in MODES]
    assert keys[0] == keys[1] == keys[2]


@pytest.mark.parametrize("value", [False, True, "none", "block", "convs",
                                   "everything", "full", None])
def test_remat_mode_normalises_and_raises_as_jax(value):
    try:
        want = jremat_mode(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            remat_mode(value)
        assert str(got.value) == str(e)
    else:
        assert remat_mode(value) == want


@pytest.mark.parametrize("mode", ("block", "convs"))
@pytest.mark.parametrize("arch", ARCHS)
def test_live_bn_updates_its_buffers_once(models, arch, mode):
    x = torch.from_numpy(np.random.RandomState(3).rand(
        2, 48, 64, 3).astype(np.float32))
    buffers = {}
    for m in ("none", mode):
        model = models(arch, m)
        tracked = {k: int(v) for k, v in model.named_buffers()
                   if k.endswith("num_batches_tracked")}
        _, up = model(x, train=False, update_stats=True)
        (up * up).mean().backward()
        buffers[m] = {k: v.clone() for k, v in model.named_buffers()}
    for k, want in buffers["none"].items():
        got = buffers[mode][k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(want) == tracked[k] + 1, k
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.convs += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,replayed", [
    ("deeplabv2_resnet101", {"none": 0, "block": 20, "convs": 1}),
    ("deeplabv2_vgg16_bn", {"none": 0, "block": 13, "convs": 0}),
    ("fcn_vgg16_bn", {"none": 0, "block": 13, "convs": 0})])
def test_backward_replays_convolutions_by_mode(models, arch, replayed):
    """r101 (1, 1, 2, 1): the stem's conv, 4 first blocks of 3 convs and a
    projection, and one plain block of 3; VGG: the 13 convs of the chunked
    features (fc6, fc7 and the heads outside every chunk)."""
    x = torch.rand(1, 48, 64, 3)
    for mode, n in replayed.items():
        model = models(arch, mode)
        _, up = model(x, train=False, update_stats=True)
        with _Count() as count:
            up.sum().backward()
        assert count.convs == n, (mode, count.convs)


@pytest.mark.parametrize("mode", ("block", "convs"))
def test_chunks_draw_no_random_numbers(models, mode):
    x = torch.rand(2, 64, 64, 3)
    states = {}
    for m in ("none", mode):
        torch.manual_seed(11)
        model = models("fcn_vgg16_bn", m)
        gen = torch.Generator().manual_seed(5)
        global_before = torch.get_rng_state()
        _, up = model(x, train=True, update_stats=False, generator=gen)
        after_forward = gen.get_state()
        up.sum().backward()
        assert torch.equal(gen.get_state(), after_forward)
        assert torch.equal(torch.get_rng_state(), global_before)
        states[m] = (after_forward, up.detach())
    assert torch.equal(states[mode][0], states["none"][0])
    torch.testing.assert_close(states[mode][1], states["none"][1], rtol=0,
                               atol=0)


def test_no_checkpoint_under_no_grad(models, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("checkpoint entered under no_grad")

    monkeypatch.setattr(layers, "checkpoint", refuse)
    for arch in ARCHS:
        model = models(arch, "convs")
        with torch.no_grad():
            model(torch.rand(1, 48, 64, 3), train=False, update_stats=True)
