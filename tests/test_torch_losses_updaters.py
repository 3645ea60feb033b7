"""The port's losses and updaters against the JAX package's.

Every registered loss, every updater under every learning-rate policy,
the five gradient normalizations, ``all_finite`` and ``select_tree``, on
the same numpy inputs. All inputs are explicit float32
(``tests/conftest.py`` turns on jax x64).

Tolerances: losses 1e-6 (relative, and absolute near zero) — the same f32
math, only the order of the reductions differs; updaters 1e-6 relative to
each leaf's largest magnitude, after 5 steps — the same f32 elementwise
math, with the scalars (learning rate, bias corrections) computed on the
host in f32 by the port and on the device by the reference, so they may
differ in the last bit, which an element where p − delta cancels shows
as a larger relative error (observed 2.1e-6 on a 1.3e-3 element of a leaf
whose scale is 1.4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deeplearning4j_tpu import losses as jlosses
from deeplearning4j_tpu.nn.conf.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch import losses as tlosses
from deeplearning4j_tpu_torch.nn.conf.training import TrainingConfig
from deeplearning4j_tpu_torch.optimize import updaters as tupd

B, T, N = 3, 4, 5
LOSS_TOL = 1e-6
UPD_TOL = 1e-6

# one activation per loss: the fused head where the loss has one
_ACTIVATION = {"sparse_mcxent": "softmax", "sparse_categorical_crossentropy":
               "softmax", "mcxent": "softmax", "negativeloglikelihood":
               "softmax", "categorical_crossentropy": "softmax",
               "xent": "sigmoid", "binary_xent": "sigmoid",
               "binary_crossentropy": "sigmoid",
               "reconstruction_crossentropy": "sigmoid"}
LOSS_CASES = ([(n, _ACTIVATION.get(n, "tanh")) for n in jlosses.names()]
              + [("mcxent", "sigmoid"), ("xent", "softmax"),
                 ("mse", "identity")])
MASKS = ["none", "b", "bt", "per_output"]


def test_registry_names_match():
    assert tlosses.names() == jlosses.names()
    for n in tlosses.names():
        assert tlosses.is_sparse(n) == jlosses.is_sparse(n)


def _loss_inputs(name, mask_kind, seed):
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((B, T, N)).astype(np.float32)
    if tlosses.is_sparse(name):
        # in range, and out of range both ways: N, 10N, -1, -N, -N - 1
        labels = rng.integers(0, N, (B, T)).astype(np.int32)
        labels[0] = [N, 10 * N, -1, -N]
        labels[1, 0] = -N - 1
    elif name in ("hinge", "squared_hinge"):
        labels = rng.choice([-1.0, 1.0], (B, T, N)).astype(np.float32)
    else:
        labels = rng.random((B, T, N)).astype(np.float32)
    mask = {"none": None,
            "b": (rng.random(B) > 0.3).astype(np.float32),
            "bt": (rng.random((B, T)) > 0.3).astype(np.float32),
            "per_output": (rng.random(labels.shape) > 0.3).astype(np.float32),
            }[mask_kind]
    return labels, pre, mask


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name,activation", LOSS_CASES)
def test_loss_matches_reference(name, activation, mask_kind):
    labels, pre, mask = _loss_inputs(name, mask_kind, seed=len(name))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    j_arr = jlosses.score_array(name, jnp.asarray(labels), jnp.asarray(pre),
                                activation, jm)
    t_arr = tlosses.score_array(name, torch.from_numpy(labels),
                                torch.from_numpy(pre), activation, tm)
    np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    j_score = jlosses.score(name, jnp.asarray(labels), jnp.asarray(pre),
                            activation, jm)
    t_score = tlosses.score(name, torch.from_numpy(labels),
                            torch.from_numpy(pre), activation, tm)
    np.testing.assert_allclose(float(t_score), float(j_score),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    if tlosses.is_sparse(name):
        # the out-of-range ids poison the same rows in both packages
        assert np.isnan(t_arr.numpy()).sum() == np.isnan(np.asarray(j_arr)).sum()
        if mask_kind == "none":
            assert np.isnan(t_arr.numpy()[0]) and np.isnan(float(t_score))


def test_sparse_mcxent_requires_softmax():
    with pytest.raises(ValueError, match="softmax"):
        tlosses.sparse_mcxent(torch.zeros((1, 2), dtype=torch.int32),
                              torch.zeros((1, 2, 3)), "sigmoid")


@pytest.mark.parametrize("sparse", [False, True])
def test_masked_denominator_matches_reference(sparse):
    rng = np.random.default_rng(3)
    labels = np.zeros((B, T) if sparse else (B, T, N), np.float32)
    for mask in (None, (rng.random(B) > 0.5).astype(np.float32),
                 (rng.random((B, T)) > 0.5).astype(np.float32),
                 np.zeros((B, T), np.float32)):
        want = jlosses.masked_denominator(
            None if mask is None else jnp.asarray(mask), jnp.asarray(labels),
            B, sparse=sparse)
        got = tlosses.masked_denominator(
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(labels), B, sparse=sparse)
        assert float(got) == float(want)


# --------------------------------------------------------------------------
# updaters
# --------------------------------------------------------------------------

UPDATERS = ["sgd", "none", "nesterovs", "adagrad", "rmsprop", "adadelta",
            "adam", "adamax", "nadam"]
POLICIES = ["none", "exponential", "inverse", "step", "torch_step", "poly",
            "sigmoid", "schedule"]
SHAPES = {"dense": {"W": (3, 4), "b": (4,)}, "res": {},
          "ln": {"gamma": (5,), "beta": (5,)}}
MULTS = {"dense": {"W": 1.0, "b": 2.5}, "res": {}, "ln": {"gamma": 0.5,
                                                        "beta": 1.0}}


def _tree(rng, scale=1.0):
    return {v: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in ps.items()} for v, ps in SHAPES.items()}


def _conf_kwargs(updater, policy):
    return dict(updater=updater, learning_rate=0.05, lr_policy=policy,
                lr_policy_decay_rate=0.9, lr_policy_steps=2.0,
                lr_policy_power=0.5, lr_schedule={2: 0.01, 4: 0.002})


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _close(got, want, what):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=UPD_TOL,
                               atol=UPD_TOL * scale + 1e-12, err_msg=what)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("updater", UPDATERS)
def test_updater_matches_reference_over_5_steps(updater, policy):
    rng = np.random.default_rng(UPDATERS.index(updater) * 10
                                + POLICIES.index(policy))
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(5)]
    jconf = JTrainingConfig(**_conf_kwargs(updater, policy))
    tconf = TrainingConfig(**_conf_kwargs(updater, policy))
    assert tupd.learning_rate_at(tconf, 3) == pytest.approx(
        float(jupd.learning_rate_at(jconf, 3)), rel=UPD_TOL)
    ju = jupd.make_updater(jconf, MULTS)
    tu = tupd.make_updater(tconf, MULTS)
    jp = {v: {k: jnp.asarray(a) for k, a in ps.items()}
          for v, ps in params.items()}
    tp = {v: {k: torch.from_numpy(a.copy()) for k, a in ps.items()}
          for v, ps in params.items()}
    js, ts = ju.init(jp), tu.init(tp)
    for i, g in enumerate(grads):
        jd, js = ju.update({v: {k: jnp.asarray(a) for k, a in ps.items()}
                            for v, ps in g.items()}, js, i)
        td, ts = tu.update({v: {k: torch.from_numpy(a) for k, a in ps.items()}
                            for v, ps in g.items()}, ts, i)
        jp = jupd.apply_updates(jp, jd)
        tupd.apply_updates(tp, td)
    for (path, want), (tpath, got) in zip(
            _leaves({"params": jp, "state": js}),
            _leaves({"params": tp, "state": ts})):
        assert path == tpath
        assert got.dtype == np.float32
        _close(got, want, path)


def test_updater_state_layout_matches_reference():
    for updater in UPDATERS:
        conf = dict(updater=updater)
        jstate = jupd.make_updater(JTrainingConfig(**conf)).init(
            {v: {k: jnp.zeros(s, jnp.float32) for k, s in ps.items()}
             for v, ps in SHAPES.items()})
        tstate = tupd.make_updater(TrainingConfig(**conf)).init(
            {v: {k: torch.zeros(s) for k, s in ps.items()}
             for v, ps in SHAPES.items()})
        assert [p for p, _ in _leaves(tstate)] == [p for p, _ in _leaves(jstate)]


@pytest.mark.parametrize("kind", ["renormalize_l2_per_layer",
                                  "renormalize_l2_per_param_type",
                                  "clip_elementwise_absolute_value",
                                  "clip_l2_per_layer",
                                  "clip_l2_per_param_type", None])
def test_normalize_gradients_matches_reference(kind):
    rng = np.random.default_rng(5)
    g = _tree(rng, 2.0)
    want = jupd.normalize_gradients(
        {v: {k: jnp.asarray(a) for k, a in ps.items()} for v, ps in g.items()},
        kind, 0.5)
    got = tupd.normalize_gradients(
        {v: {k: torch.from_numpy(a) for k, a in ps.items()}
         for v, ps in g.items()}, kind, 0.5)
    for (p, w), (_, t) in zip(_leaves(want), _leaves(got)):
        _close(t, w, p)


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="updater"):
        tupd.make_updater(TrainingConfig(updater="lbfgs"))
    with pytest.raises(ValueError, match="lr policy"):
        tupd.learning_rate_at(TrainingConfig(lr_policy="cosine"), 1)
    with pytest.raises(ValueError, match="normalization"):
        tupd.normalize_gradients({"a": {"W": torch.ones(2)}}, "clip_all")


@pytest.mark.parametrize("bad", [None, float("inf"), float("nan")])
def test_all_finite_matches_reference(bad):
    tree = {"a": {"W": np.ones((2, 2), np.float32),
                  "ids": np.arange(3, dtype=np.int32)}, "b": {}}
    if bad is not None:
        tree["a"]["W"][1, 0] = bad
    want = bool(jupd.all_finite({v: {k: jnp.asarray(a) for k, a in ps.items()}
                                 for v, ps in tree.items()}))
    got = tupd.all_finite({v: {k: torch.from_numpy(a) for k, a in ps.items()}
                           for v, ps in tree.items()})
    assert got.dtype == torch.bool and bool(got) == want == (bad is None)


@pytest.mark.parametrize("ok", [True, False])
def test_select_tree_matches_reference(ok):
    rng = np.random.default_rng(6)
    new = {"a": {"W": rng.standard_normal(3).astype(np.float32),
                 "extra": rng.standard_normal(2).astype(np.float32)},
           "s": [np.float32(1.0), np.ones(2, np.float32)]}
    old = {"a": {"W": np.zeros(3, np.float32)}, "s": [np.float32(0.0)]}

    def conv(tree, f):
        if isinstance(tree, dict):
            return {k: conv(v, f) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, f) for v in tree]
        return f(np.asarray(tree))

    want = jupd.select_tree(jnp.asarray(ok), conv(new, jnp.asarray),
                            conv(old, jnp.asarray))
    got = tupd.select_tree(torch.tensor(ok), conv(new, torch.from_numpy),
                           conv(old, torch.from_numpy))
    assert np.array_equal(got["a"]["W"].numpy(), np.asarray(want["a"]["W"]))
    assert np.array_equal(got["a"]["extra"].numpy(), new["a"]["extra"])
    assert float(got["s"][0]) == float(want["s"][0])
    assert np.array_equal(got["s"][1].numpy(), np.asarray(want["s"][1]))
