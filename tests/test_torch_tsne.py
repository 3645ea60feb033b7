"""The port's ``plot/tsne.py`` against the JAX package's, on the CPU.

Dense exact path: ``_calibrated_P`` within ``P_TOL`` and ``_tsne_grad``
within ``GRAD_TOL`` (relative to the largest entry), and ``Tsne`` over 20
iterations within ``ITER_TOL`` at a step small enough that the trajectory
is stable (learning rate 1). How far iteration-by-iteration parity holds at
the defaults (learning rate 200, exaggeration 12): about 5 iterations at
these sizes (within 1e-3 of the coordinates' scale); by 20 the two
trajectories part, and so do two runs of the reference itself whose inputs
differ by one ulp in one entry (pinned below), so whole fits at the
defaults are compared on the final KL and on the clusters' separation
only. Barnes-Hut above ``dense_threshold`` runs the reference's host code
(kNN similarities, the C++ or Python tree gradient), so its embedding is
bitwise the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.clustering import native as j_native
from deeplearning4j_tpu.plot import tsne as jt
from deeplearning4j_tpu_torch.clustering import native as t_native
from deeplearning4j_tpu_torch.plot import tsne as tt

P_TOL = 5e-5        # f32, relative to max P (the products sum in another
                    # order, then 40 bisection steps; worst seen 1.26e-5)
GRAD_TOL = 1e-5     # f32, relative to max |grad|
ITER_TOL = 2e-5     # 20 f32 iterations, relative to max |y|
KL_REL = 0.1        # whole fits at the defaults: final KL within 10%
NN_AGREE = 0.95     # 1-NN label agreement of the 2-D embedding


def _clusters(n_per=40, k=3, d=8, seed=0, spacing=3.0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(loc=spacing * m, size=(n_per, d))
                        for m in range(k)]).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


def _nn_agreement(y, labels):
    d = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return float((labels[d.argmin(1)] == labels).mean())


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("perplexity,n_per", [(10.0, 40), (30.0, 50)])
def test_calibrated_p_matches(perplexity, n_per):
    x, _ = _clusters(n_per=n_per)
    want = np.asarray(jt._calibrated_P(jnp.asarray(x), perplexity=perplexity))
    got = tt._calibrated_P(torch.from_numpy(x), perplexity=perplexity)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), want) <= P_TOL


def test_calibrated_p_has_no_nan_from_zero_probabilities():
    """Far-apart points give p = 0 entries; 0·log 0 must not leak a NaN:
    P stays finite, symmetric, and a distribution (up to the 1e-12
    floor)."""
    x = np.array([[0.0, 0.0], [0.1, 0.0], [1e3, 0.0], [1e3, 0.1],
                  [2e3, 5.0]], np.float32)
    got = tt._calibrated_P(torch.from_numpy(x), perplexity=1.0)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, got.T)
    assert abs(float(got.sum()) - 1.0) <= 1e-6


@pytest.mark.parametrize("exaggeration", [1.0, 12.0])
def test_tsne_grad_matches(exaggeration):
    x, _ = _clusters()
    P = np.asarray(jt._calibrated_P(jnp.asarray(x), perplexity=10.0)) \
        * np.float32(exaggeration)
    y = np.random.default_rng(1).normal(size=(x.shape[0], 2)) \
        .astype(np.float32)
    jg, jkl = jt._tsne_grad(jnp.asarray(y), jnp.asarray(P))
    tg, tkl = tt._tsne_grad(torch.from_numpy(y), torch.from_numpy(P))
    assert _rel(tg.numpy(), np.asarray(jg)) <= GRAD_TOL
    assert abs(float(tkl) - float(jkl)) <= GRAD_TOL * abs(float(jkl))


@pytest.mark.parametrize("use_pca_init", [True, False])
def test_twenty_iterations_match(use_pca_init):
    x, _ = _clusters()
    kw = dict(perplexity=10.0, max_iter=20, seed=1, learning_rate=1.0,
              use_pca_init=use_pca_init)
    want = jt.Tsne(**kw).fit_transform(x)
    model = tt.Tsne(**kw, device="cpu")
    got = model.fit_transform(x)
    assert got.dtype == np.float32 and got.shape == (x.shape[0], 2)
    assert _rel(got, want) <= ITER_TOL
    assert np.isfinite(model.kl_divergence)


def test_default_trajectory_parts_after_a_few_iterations():
    """At the defaults the map is chaotic: the port stays within 1e-3 of
    the reference for 5 iterations, and the reference parts from itself
    by 20 when one input entry moves by one ulp."""
    x, _ = _clusters()
    kw = dict(perplexity=10.0, max_iter=5, seed=1)
    want = jt.Tsne(**kw).fit_transform(x)
    assert _rel(tt.Tsne(**kw, device="cpu").fit_transform(x), want) <= 1e-3
    x2 = x.copy()
    x2[0, 0] = np.nextafter(x2[0, 0], np.float32(np.inf))
    kw["max_iter"] = 20
    a, b = jt.Tsne(**kw).fit_transform(x), jt.Tsne(**kw).fit_transform(x2)
    assert _rel(a, b) > 1e-2


def test_whole_fits_agree_on_kl_and_separation():
    x, labels = _clusters(spacing=6.0)
    jm = jt.Tsne(perplexity=10.0, seed=2)
    tm = tt.Tsne(perplexity=10.0, seed=2, device="cpu")
    jy, ty = jm.fit_transform(x), tm.fit_transform(x)
    assert np.isfinite(ty).all()
    assert abs(tm.kl_divergence - jm.kl_divergence) <= \
        KL_REL * jm.kl_divergence
    assert _nn_agreement(ty, labels) >= NN_AGREE
    assert _nn_agreement(jy, labels) >= NN_AGREE


def test_perplexity_too_large_raises():
    x, _ = _clusters(n_per=5)
    with pytest.raises(ValueError, match="perplexity"):
        tt.Tsne(perplexity=30.0, device="cpu").fit_transform(x)
    with pytest.raises(ValueError, match="perplexity"):
        tt.BarnesHutTsne(perplexity=30.0, dense_threshold=4,
                         device="cpu").fit_transform(x)


@pytest.mark.parametrize("theta,native", [(0.5, True), (0.8, True),
                                          (0.5, False)])
def test_barnes_hut_above_threshold_is_bitwise(theta, native, monkeypatch):
    if native and (t_native.load() is None or j_native.load() is None):
        pytest.skip("no C++ compiler for the Barnes-Hut kernel")
    if not native:      # both packages on their pure-Python trees
        monkeypatch.setattr(t_native, "load", lambda: None)
        monkeypatch.setattr(j_native, "load", lambda: None)
    x, _ = _clusters(n_per=50 if native else 30)
    kw = dict(theta=theta, perplexity=10.0, dense_threshold=64,
              max_iter=60 if native else 4, seed=3)
    want_model = jt.BarnesHutTsne(**kw)
    want = want_model.fit_transform(x.astype(np.float64))
    model = tt.BarnesHutTsne(**kw, device="cpu")
    got = model.fit_transform(x.astype(np.float64))
    np.testing.assert_array_equal(got, want)
    assert model.kl_divergence == want_model.kl_divergence


def test_barnes_hut_at_threshold_takes_the_dense_path():
    x, _ = _clusters()
    kw = dict(perplexity=10.0, max_iter=15, seed=4, learning_rate=1.0)
    dense = tt.Tsne(**kw, device="cpu").fit_transform(x)
    bh = tt.BarnesHutTsne(dense_threshold=x.shape[0], **kw,
                          device="cpu").fit_transform(x)
    np.testing.assert_array_equal(bh, dense)
    theta0 = tt.BarnesHutTsne(theta=0.0, dense_threshold=4, **kw,
                              device="cpu").fit_transform(x)
    np.testing.assert_array_equal(theta0, dense)
