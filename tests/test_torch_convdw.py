"""The port's alternative conv lowerings (``ops/convops.py``) against the
JAX package's, on the CPU in f64: ``DL4JTPU_CONV_DW=matmul`` (the weight
gradient as one matrix product per kernel tap) over the reference's
``CASES`` of ``tests/test_convdw.py``, against the reference's
``_conv2d_mmdw`` and against the autodiff dW of the default lowering; and
``DL4JTPU_CONV_1X1=dot`` (a 1×1 conv as a channel contraction).

Tolerances: the forward 1e-12 and dx, dW 1e-9, absolute on unit-normal
data, as the reference's own test holds its two lowerings (the sums run
in another order: per tap here, fused in cuDNN's or XLA's kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import convops as jconv
from deeplearning4j_tpu_torch.ops import convops
from test_convdw import CASES

FWD = 1e-12
GRAD = 1e-9


def _grads(fn, x, w, dy):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad((y * torch.tensor(dy)).sum(), (xt, wt))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


@pytest.mark.parametrize("xs,ws,st,pad", CASES)
def test_mmdw_matches_reference_and_autodiff(xs, ws, st, pad):
    rng = np.random.default_rng(7)
    x = rng.normal(size=xs)
    w = rng.normal(size=ws)
    y_ref = np.asarray(jconv._conv2d_raw(jnp.asarray(x), jnp.asarray(w), st,
                                         pad))
    dy = rng.normal(size=y_ref.shape)
    j_gx, j_gw = jax.grad(
        lambda a, b: jnp.vdot(jconv._conv2d_mmdw(a, b, tuple(st), pad, None),
                              jnp.asarray(dy)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    y_mm, gx_mm, gw_mm = _grads(
        lambda a, b: convops._Conv2dMMdW.apply(a, b, tuple(st), pad, None),
        x, w, dy)
    y_df, gx_df, gw_df = _grads(
        lambda a, b: convops._conv2d_default(a, b, st, pad, (1, 1), 1, None),
        x, w, dy)
    np.testing.assert_allclose(y_mm, y_ref, rtol=FWD, atol=FWD)
    np.testing.assert_allclose(gw_mm, np.asarray(j_gw), rtol=GRAD, atol=GRAD)
    np.testing.assert_allclose(gx_mm, np.asarray(j_gx), rtol=GRAD, atol=GRAD)
    np.testing.assert_allclose(gw_mm, gw_df, rtol=GRAD, atol=GRAD)
    np.testing.assert_array_equal(gx_mm, gx_df)     # the same dx kernel


def test_flag_routes_conv2d(monkeypatch):
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, 8, 8, 4)))
    w = torch.tensor(rng.normal(size=(3, 3, 4, 8)))
    calls = []
    real = convops._Conv2dMMdW.apply

    def sentinel(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(convops._Conv2dMMdW, "apply", sentinel)
    monkeypatch.delenv("DL4JTPU_CONV_DW", raising=False)
    convops.conv2d(x, w, (1, 1), "SAME")
    assert calls == []
    monkeypatch.setenv("DL4JTPU_CONV_DW", "matmul")
    y = convops.conv2d(x, w, (1, 1), "SAME")
    assert calls == [1]
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jconv._conv2d_raw(jnp.asarray(x.numpy()),
                                                jnp.asarray(w.numpy()),
                                                (1, 1), "SAME")),
        rtol=FWD, atol=FWD)
    convops.conv2d(x, w, (1, 1), "SAME", dilation=(2, 2))
    assert calls == [1]            # dilated convs keep the default path


class TestConv1x1Dot:
    @pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
    @pytest.mark.parametrize("padding", [(0, 0), "SAME"])
    def test_value_and_grad_parity(self, monkeypatch, stride, padding):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 8, 8, 6))
        w = rng.normal(size=(1, 1, 6, 10))
        dy_shape = (2, 8 // stride[0], 8 // stride[1], 10)
        dy = rng.normal(size=dy_shape)
        monkeypatch.delenv("DL4JTPU_CONV_1X1", raising=False)
        ref = _grads(lambda a, b: convops.conv2d(a, b, stride, padding),
                     x, w, dy)
        monkeypatch.setenv("DL4JTPU_CONV_1X1", "dot")
        got = _grads(lambda a, b: convops.conv2d(a, b, stride, padding),
                     x, w, dy)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=FWD, atol=FWD)
        jref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride, padding)
        np.testing.assert_allclose(got[0], np.asarray(jref), rtol=FWD,
                                   atol=FWD)

    def test_non_1x1_unaffected(self, monkeypatch):
        monkeypatch.setenv("DL4JTPU_CONV_1X1", "dot")
        x = torch.randn(2, 8, 8, 3)
        w = torch.randn(3, 3, 3, 4)
        assert tuple(convops.conv2d(x, w, (1, 1), (1, 1)).shape) == \
            (2, 8, 8, 4)


def test_resnet_mixed_bf16_step_under_both_flags(monkeypatch):
    """A bf16-compute conv stack (the ResNet stem's 7×7/2 then a 1×1/2
    shortcut) trains through both lowerings: the f32 masters' gradients
    within bf16 rounding of the default lowering's."""
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(2, 18, 18, 3)), dtype=torch.bfloat16)
    w1 = torch.tensor(rng.normal(size=(7, 7, 3, 8)) * 0.1,
                      dtype=torch.float32, requires_grad=True)
    w2 = torch.tensor(rng.normal(size=(1, 1, 8, 4)) * 0.1,
                      dtype=torch.float32, requires_grad=True)

    def loss():
        h = convops.conv2d(x, w1, (2, 2), (3, 3), dtype=torch.bfloat16)
        return convops.conv2d(h, w2, (2, 2), "SAME",
                              dtype=torch.bfloat16).float().square().sum()

    monkeypatch.delenv("DL4JTPU_CONV_DW", raising=False)
    monkeypatch.delenv("DL4JTPU_CONV_1X1", raising=False)
    base = torch.autograd.grad(loss(), (w1, w2))
    monkeypatch.setenv("DL4JTPU_CONV_DW", "matmul")
    monkeypatch.setenv("DL4JTPU_CONV_1X1", "dot")
    alt = torch.autograd.grad(loss(), (w1, w2))
    for a, b in zip(alt, base):
        assert a.dtype == torch.float32
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -6 * scale
