"""The port's training path against the JAX package's, from a reference
checkpoint.

A JAX ``transformer_lm(V=256, L=2, d=64, h=4, d_ff=128, input_ids=True)``
is initialised, saved with the reference's ``save_model`` and loaded into
the port with its ``load_model`` (training parity always starts from
loaded weights and optimizer state: jax and torch generators differ). The
batch is [2, 129] ids from a seed, split into inputs x = ids[:, :-1] and
labels y = ids[:, 1:], T = 128. Inputs are explicit numpy int32/float32
(``tests/conftest.py`` turns on jax x64).

Tolerances, each relative to the largest magnitude of what is compared
(one leaf of the gradient or parameter tree, or the loss):
- step-0 loss and gradients, f32: 1e-5 — the same weights and inputs,
  only summation order differs (observed ≤ 1.2e-6);
- 20 adam steps, f32: losses and final parameters 1e-4 — adam divides by
  sqrt(v) + eps, so a summation-order difference in a small gradient
  element grows into a step difference (observed 1.2e-7 on the losses,
  2.9e-6 on parameters); ``fit_scan``, whose three batches differ, meets
  a vocabulary-head gradient element of 20·eps at step 0 and holds its
  parameters to 2e-4 (observed 7.2e-5, losses 8.2e-8);
- mixed_bf16: see ``test_mixed_bf16_tracks_reference``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.util.serialization import load_model as j_load_model
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.conf.layers import NotYetPorted
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.util.serialization import (load_model,
                                                         save_model)

V, L, D, H, FF, T = 256, 2, 64, 4, 128, 128
GRAD_TOL = 1e-5
STEP_TOL = 1e-4


def _batch(seed=0, batch=2):
    ids = np.random.default_rng(seed).integers(
        0, V, (batch, T + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _jconf(dtype="float32", learning_rate=1e-3, edit=None):
    conf = j_transformer_lm(V, n_layers=L, d_model=D, n_heads=H, d_ff=FF,
                            dtype=dtype, input_ids=True, seed=7,
                            learning_rate=learning_rate)
    if edit is not None:
        edit(conf)
    return conf


def _pair(tmp_path, name="ref", **kw):
    """(reference net, the port's net loaded from its checkpoint)."""
    jnet = JComputationGraph(_jconf(**kw)).init()
    path = str(tmp_path / f"{name}.zip")
    j_save_model(jnet, path)
    return jnet, load_model(path, device="cpu")


def _rel_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"
    return err


def _tparams(tnet):
    """A numpy copy of the port's parameters (training updates them in
    place)."""
    return {v: {k: p.detach().numpy().copy() for k, p in ps.items()}
            for v, ps in tnet.params.items()}


def _assert_params_close(tnet, jparams, tol):
    for v, ps in _tparams(tnet).items():
        for k, a in ps.items():
            _rel_close(a, jparams[v][k], tol, f"{v}/{k}")


@pytest.fixture(scope="module")
def f32_pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("f32"))


@pytest.mark.parametrize("jax_flash,port_flash", [("1", "1"), ("1", "0"),
                                                  ("0", "1"), ("0", "0")])
def test_step0_loss_and_grads_match_reference(monkeypatch, f32_pair,
                                              jax_flash, port_flash):
    """Both flash routes on both sides: the reference's Pallas kernels in
    interpret mode (forward and backward) or its dense XLA path; the
    port's FlashAttentionFunction (plain backward on the CPU) or its dense
    path through autograd."""
    jnet, tnet = f32_pair
    x, y = _batch()
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", jax_flash)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jnet._loss_fn(p, jnet._states_map(), [jnp.asarray(x)],
                                [jnp.asarray(y)], None, None)[0])(jnet.params)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", port_flash)
    t_loss, t_grads = tnet._loss_and_grads([torch.from_numpy(x)],
                                           [torch.from_numpy(y)], None)
    assert t_loss.dtype == torch.float32
    _rel_close(float(t_loss), float(j_loss), GRAD_TOL, "loss")
    assert set(t_grads) == set(j_grads)
    for v, gs in t_grads.items():
        assert set(gs) == set(j_grads[v])
        for k, g in gs.items():
            _rel_close(g.numpy(), j_grads[v][k], GRAD_TOL, f"{v}/{k}")


def test_step0_with_a_key_mask_matches_reference(monkeypatch, f32_pair):
    """A [b, t] mask reaches the embedding, the attention key mask and the
    output score's denominator (sum of the mask) in both packages."""
    jnet, tnet = f32_pair
    x, y = _batch(seed=1)
    mask = np.ones((2, T), np.float32)
    mask[0, :40] = 0.0
    mask[1, 100:] = 0.0
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jnet._loss_fn(p, jnet._states_map(), [jnp.asarray(x)],
                                [jnp.asarray(y)], [jnp.asarray(mask)],
                                None)[0])(jnet.params)
    for port_flash in ("1", "0"):
        monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", port_flash)
        t_loss, t_grads = tnet._loss_and_grads(
            [torch.from_numpy(x)], [torch.from_numpy(y)],
            [torch.from_numpy(mask)])
        _rel_close(float(t_loss), float(j_loss), GRAD_TOL, "loss")
        for v, gs in t_grads.items():
            for k, g in gs.items():
                _rel_close(g.numpy(), j_grads[v][k], GRAD_TOL, f"{v}/{k}")
    assert tnet.score_for(x, y, [mask]) == pytest.approx(float(t_loss),
                                                         rel=1e-6)


def test_20_adam_steps_track_reference(tmp_path):
    jnet, tnet = _pair(tmp_path)
    x, y = _batch(seed=2)
    j_losses = [float(jnet.fit_batch([x], [y])) for _ in range(20)]
    t_losses = [float(tnet.fit_batch([x], [y])) for _ in range(20)]
    _rel_close(t_losses, j_losses, STEP_TOL, "losses")
    assert t_losses[-1] < t_losses[0]
    _assert_params_close(tnet, jax.device_get(jnet.params), STEP_TOL)
    assert tnet.iteration_count == jnet.iteration_count == 20
    assert tnet._update_count == jnet._update_count == 20
    assert tnet.score() == pytest.approx(float(jnet.score()), rel=STEP_TOL)


def test_fit_repeated_equals_k_fit_batch_bit_for_bit(tmp_path):
    _, a = _pair(tmp_path)
    b = load_model(str(tmp_path / "ref.zip"), device="cpu")
    x, y = _batch(seed=3)
    rep = a.fit_repeated([x], [y], 4)
    one = torch.stack([b.fit_batch([x], [y]) for _ in range(4)])
    assert rep.shape == (4,) and torch.equal(rep, one)
    for v, ps in a.params.items():
        for k, p in ps.items():
            assert torch.equal(p, b.params[v][k]), (v, k)
    for rule, tree in a.updater_state.items():
        for v, ps in tree.items():
            for k, s in ps.items():
                assert torch.equal(s, b.updater_state[rule][v][k])
    assert (a.iteration_count, a._update_count) == (b.iteration_count,
                                                    b._update_count) == (4, 4)


def test_fit_scan_matches_reference_and_fit_batch(tmp_path):
    jnet, tnet = _pair(tmp_path)
    other = load_model(str(tmp_path / "ref.zip"), device="cpu")
    batches = [_batch(seed=10 + i) for i in range(3)]
    xs = np.stack([x for x, _ in batches])
    ys = np.stack([y for _, y in batches])
    j_losses = np.asarray(jnet.fit_scan([xs], [ys]))
    t_losses = tnet.fit_scan([xs], [ys])
    _rel_close(t_losses.numpy(), j_losses, STEP_TOL, "losses")
    _assert_params_close(tnet, jax.device_get(jnet.params), 2 * STEP_TOL)
    one = torch.stack([other.fit_batch([x], [y]) for x, y in batches])
    assert torch.equal(t_losses, one)
    assert tnet.iteration_count == jnet.iteration_count == 3


def _regularized(conf):
    """l1/l2 on some layers, per-layer clipping, per-layer learning rates,
    under sgd: its update is linear in the gradient, so the check sees the
    regularization and clipping math and not adam's 1/(|g| + eps), which
    turns f32 summation noise in a gradient element clipped down to ≈ eps
    into a visible step difference."""
    conf.training.updater = "sgd"
    conf.training.learning_rate = 0.05
    conf.training.regularization = True
    conf.training.gradient_normalization = "clip_l2_per_layer"
    conf.training.gradient_normalization_threshold = 0.5
    ff1 = conf.vertices["blk0_ff1"].layer
    ff1.l2, ff1.l1 = 1e-2, 1e-3
    ff1.learning_rate, ff1.bias_learning_rate = 0.1, 0.02
    conf.vertices["blk1_attn"].layer.l2 = 1e-2
    conf.vertices["blk1_ln1"].layer.l2 = 1e-2      # no regularized params
    conf.vertices["out"].layer.learning_rate = 0.01


def test_l2_clip_and_per_layer_lr_track_reference(tmp_path):
    jnet, tnet = _pair(tmp_path, edit=_regularized)
    assert tnet.conf.training.regularization
    assert tnet._lr_multipliers() == jnet._lr_multipliers()
    x, y = _batch(seed=4)
    j_losses = [float(jnet.fit_batch([x], [y])) for _ in range(5)]
    t_losses = [float(tnet.fit_batch([x], [y])) for _ in range(5)]
    _rel_close(t_losses, j_losses, STEP_TOL, "losses")
    assert t_losses[-1] < t_losses[0]
    _assert_params_close(tnet, jax.device_get(jnet.params), STEP_TOL)


def test_mixed_bf16_tracks_reference(tmp_path, monkeypatch):
    """5 adam steps under mixed_bf16 (f32 parameters and optimizer state,
    bf16 matmuls and activations). The two frameworks round activations to
    bf16 at different places (8 bits of mantissa, 0.4% a rounding), and
    adam moves each element by about lr per step whatever the size of its
    gradient, so an element whose gradient is near the rounding noise may
    move the other way. So the check is on the whole update: the losses
    agree within 1% (observed equal), the two 5-step parameter updates
    point the same way (cosine ≥ 0.95, observed 0.989) with the same norm
    (within 5%, observed 0.1%), and the median element differs by at most
    0.1·lr (observed 0.04·lr)."""
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    jnet, tnet = _pair(tmp_path, dtype="mixed_bf16")
    x, y = _batch(seed=5)
    start = _tparams(tnet)
    j_losses = [float(jnet.fit_batch([x], [y])) for _ in range(5)]
    t_losses = [float(tnet.fit_batch([x], [y])) for _ in range(5)]
    _rel_close(t_losses, j_losses, 1e-2, "losses")
    assert t_losses[-1] < t_losses[0]
    lr = 1e-3
    jp = jax.device_get(jnet.params)
    t_upd, j_upd = [], []
    for v, ps in _tparams(tnet).items():
        for k, a in ps.items():
            assert a.dtype == np.float32
            t_upd.append((a - start[v][k]).ravel())
            j_upd.append((np.asarray(jp[v][k], np.float32)
                          - start[v][k]).ravel())
    t_upd, j_upd = np.concatenate(t_upd), np.concatenate(j_upd)
    cos = t_upd @ j_upd / np.linalg.norm(t_upd) / np.linalg.norm(j_upd)
    assert cos >= 0.95
    assert abs(np.linalg.norm(t_upd) / np.linalg.norm(j_upd) - 1) <= 0.05
    assert np.median(np.abs(t_upd - j_upd)) <= 0.1 * lr
    assert np.abs(t_upd).max() <= 5.5 * lr       # about lr per step


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(tmp_path, first):
    """A checkpoint written after 3 steps by one package, loaded and
    trained 3 more steps by the other, matches the saving package's own
    continuation: parameters, the adam state and the step counters all
    cross."""
    x, y = _batch(seed=6)
    jnet, tnet = _pair(tmp_path)
    path = str(tmp_path / "mid.zip")
    if first == "reference":
        for _ in range(3):
            jnet.fit_batch([x], [y])
        j_save_model(jnet, path)
        other = load_model(path, device="cpu")
        assert other._update_count == 3
        got = [float(other.fit_batch([x], [y])) for _ in range(3)]
        want = [float(jnet.fit_batch([x], [y])) for _ in range(3)]
        _rel_close(got, want, STEP_TOL, "losses")
        _assert_params_close(other, jax.device_get(jnet.params), STEP_TOL)
    else:
        for _ in range(3):
            tnet.fit_batch([x], [y])
        save_model(tnet, path)
        other = j_load_model(path)
        assert other._update_count == 3
        got = [float(other.fit_batch([x], [y])) for _ in range(3)]
        want = [float(tnet.fit_batch([x], [y])) for _ in range(3)]
        _rel_close(got, want, STEP_TOL, "losses")
        _assert_params_close(tnet, jax.device_get(other.params), STEP_TOL)


def test_unported_training_options_raise(tmp_path):
    x, y = _batch()

    def with_dropout(conf):
        conf.vertices["blk0_ff1"].layer.dropout = 0.1

    for edit, match in ((with_dropout, "dropout"),
                        (lambda c: setattr(c.training,
                                           "gradient_checkpointing", True),
                         "gradient_checkpointing"),
                        (lambda c: setattr(c, "backprop_type",
                                           "truncated_bptt"), "BPTT")):
        net = ComputationGraph(transformer_lm(V, n_layers=1, d_model=D,
                                              n_heads=H, d_ff=FF,
                                              input_ids=True),
                               device="cpu").init()
        edit(net.conf)
        with pytest.raises(NotYetPorted, match=match):
            net.fit_batch(x, y)
    with pytest.raises(NotYetPorted, match="listeners"):
        net.set_listeners(object())
    net.set_listeners()          # none: nothing to refuse


def test_output_after_training_uses_the_trained_weights(tmp_path):
    """A step changes what output() returns; no flash kernel is counted on
    the CPU."""
    _, tnet = _pair(tmp_path)
    x, y = _batch(seed=8)
    before = tnet.output(x)
    counts = [k.launches for k in (tfa.FLASH_FWD, tfa.FLASH_BWD_DQ)]
    tnet.fit_repeated(x, y, 2)
    after = tnet.output(x)
    assert not torch.equal(before, after)
    assert [k.launches for k in (tfa.FLASH_FWD, tfa.FLASH_BWD_DQ)] == counts
