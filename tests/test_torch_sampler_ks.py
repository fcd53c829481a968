"""The port's augmentation samplers draw from the same distributions as
dasac_tpu's ``jax.random`` draws: ``sample_target_draws``,
``sample_source_draws`` (``aug/pipelines.py``), ``sample_jitter_draws``,
``sample_grayscale_draws`` and ``sample_blur_draws``
(``aug/photometric.py``), each against the dasac_tpu function whose draws
it takes over (``augment_target_groups``, ``augment_source_batch``,
``color_jitter``, ``random_grayscale``, ``gaussian_blur``).

The JAX side's draws are recorded as its function makes them, by wrapping
``jax.random.uniform`` (every draw of those functions is one), on inputs
of a few pixels under ``jax.jit``; they come in the order of the port's
dict.  Each draw is ~2,000 samples or more a side, from fixed seeds:

  * every continuous draw (scales, offsets, zooms, blur sigmas, jitter
    factors and hues): two-sample Kolmogorov-Smirnov, p > 1e-3;
  * every discrete decision the pipelines take from a draw (group, view
    and source flips: u > 0.5; jitter and greyscale applied: u < p; the
    jitter's op order: one of 24 permutations): chi-squared on the 2 x k
    table of counts, p > 1e-3.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from dasac_tpu.aug import photometric as jP
from dasac_tpu.aug import pipelines as jpipelines
from dasac_tpu_torch.aug import photometric as tP
from dasac_tpu_torch.aug import pipelines as tpipelines

N = 2000
T = 2
P_GREY = 0.2


def _record_jax(monkeypatch, fn, key):
    """Every ``jax.random.uniform`` draw that ``fn(key)`` makes, as numpy
    arrays in order.  ``fn`` runs under ``jax.jit`` with the draws as the
    only outputs, so XLA drops the work that uses them and compiles only
    the random numbers (the same values as an eager call's)."""
    draws, real = [], jax.random.uniform

    def uniform(*a, **k):
        out = real(*a, **k)
        draws.append(out)
        return out

    def only_draws(k):
        draws.clear()
        fn(k)
        return list(draws)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", uniform)
        return [np.asarray(d) for d in jax.jit(only_draws)(key)]


def _jitter(prefix=""):
    return [(prefix + "apply_u", "below", 0.5), (prefix + "factors", "ks"),
            (prefix + "hues", "ks"), (prefix + "order_u", "order")]


def _target(monkeypatch):
    img = np.zeros((N, 4, 4, 3), np.uint8)
    lbl = np.zeros((N, 4, 4), np.uint8)
    jax_draws = _record_jax(monkeypatch, lambda k: jpipelines.
                            augment_target_groups(k, img, lbl, group_size=T),
                            jax.random.PRNGKey(0))
    d = tpipelines.sample_target_draws(torch.Generator().manual_seed(0), N, T)
    port = {**{k: d[k] for k in ("sigma", "u_off_y", "u_off_x", "u_gflip",
                                 "u_vflip", "zoom", "u_y", "u_x")},
            "blur.sigma": d["blur"]["sigma"],
            **{"jitter." + k: v for k, v in d["jitter"].items()},
            "grey.apply_u": d["grey"]["apply_u"]}
    kinds = ([("sigma", "ks"), ("u_off_y", "ks"), ("u_off_x", "ks"),
              ("u_gflip", "above", 0.5), ("u_vflip", "above", 0.5),
              ("zoom", "ks"), ("u_y", "ks"), ("u_x", "ks"),
              ("blur.sigma", "ks")] + _jitter("jitter.")
             + [("grey.apply_u", "below", P_GREY)])
    return port, jax_draws, kinds


def _source(monkeypatch):
    img = np.zeros((N, 8, 8, 3), np.uint8)
    lbl = np.zeros((N, 8, 8), np.uint8)
    jax_draws = _record_jax(monkeypatch, lambda k: jpipelines.
                            augment_source_batch(k, img, lbl, crop_hw=(4, 4),
                                                 jitter=0.4, blur=True),
                            jax.random.PRNGKey(1))
    d = tpipelines.sample_source_draws(torch.Generator().manual_seed(1), N,
                                       jitter=0.4, blur=True)
    port = {**{k: d[k] for k in ("sigma", "u_y", "u_x", "u_flip")},
            "blur.sigma": d["blur"]["sigma"],
            **{"jitter." + k: v for k, v in d["jitter"].items()}}
    kinds = ([("sigma", "ks"), ("u_y", "ks"), ("u_x", "ks"),
              ("u_flip", "above", 0.5), ("blur.sigma", "ks")]
             + _jitter("jitter."))
    return port, jax_draws, kinds


def _photometric(sample, jax_fn):
    def case(monkeypatch):
        img = np.zeros((N, 2, 2, 3), np.float32)
        jax_draws = _record_jax(monkeypatch, lambda k: jax_fn(k, img),
                                jax.random.PRNGKey(2))
        port = sample(torch.Generator().manual_seed(2), N)
        kinds = {"sigma": ("sigma", "ks"),
                 "apply_u": ("apply_u", "below",
                             P_GREY if jax_fn is _jax_grey else 0.5),
                 "factors": ("factors", "ks"), "hues": ("hues", "ks"),
                 "order_u": ("order_u", "order")}
        return port, jax_draws, [kinds[k] for k in port]
    return case


def _jax_grey(key, img):
    return jP.random_grayscale(key, img, P_GREY)


SAMPLERS = {
    "target": _target,
    "source": _source,
    "jitter": _photometric(lambda g, n: tP.sample_jitter_draws(g, n, 0.4,
                                                               0.1),
                           lambda k, x: jP.color_jitter(k, x, 0.4, 0.1)),
    "grayscale": _photometric(tP.sample_grayscale_draws, _jax_grey),
    "blur": _photometric(tP.sample_blur_draws, jP.gaussian_blur),
}


def _categories(u, kind, arg=None):
    """The discrete decision a pipeline takes from ``u``, as counts."""
    if kind == "above":
        cat = (u > arg).astype(int).ravel()
        k = 2
    elif kind == "below":
        cat = (u < arg).astype(int).ravel()
        k = 2
    else:   # the op order: argsort of 4 uniforms, one of 24 permutations
        order = np.argsort(u, axis=-1)
        cat = (order * 4 ** np.arange(4)).sum(-1)
        k = 4 ** 4
    return np.bincount(cat, minlength=k)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sampler_matches_the_jax_distribution(monkeypatch, sampler):
    port, jax_draws, kinds = SAMPLERS[sampler](monkeypatch)
    assert len(jax_draws) == len(kinds) == len(port)
    for (name, kind, *arg), want in zip(kinds, jax_draws):
        got = port[name].numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert got.size >= N, name
        if kind == "ks":
            p = stats.ks_2samp(got.ravel(), want.ravel()).pvalue
        else:
            table = np.stack([_categories(got, kind, *arg),
                              _categories(want, kind, *arg)])
            table = table[:, table.sum(0) > 0]
            assert table.shape[1] == (24 if kind == "order" else 2), name
            p = stats.chi2_contingency(table).pvalue
        assert p > 1e-3, (name, kind, p)
