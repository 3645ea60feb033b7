"""Pretrain layers: the denoising AutoEncoder and the RBM (counterpart of
the JAX package's ``nn/conf/pretrain.py``; the same JSON fields and
parameters ``W`` [n_in, n_out], hidden bias ``b`` and visible bias
``vb``).

Inside a network each is a dense encoder layer. Greedy layerwise
pretraining (``MultiLayerNetwork.pretrain``, ``ComputationGraph.
pretrain``) runs :func:`make_pretrain_step` per batch: reconstruction-loss
SGD through autograd for the autoencoder (masking corruption, tied-weight
decode, ``mse`` or ``xent``), and contrastive divergence for the RBM —
CD-k's positive-minus-negative statistics written out as matmuls (it is
not the gradient of a loss). The Gibbs chain is a Python loop over ``k``.

Randomness (the corruption mask, the Bernoulli and Gaussian samples) comes
from an explicit ``torch.Generator`` through :func:`draw_uniform` and
:func:`draw_normal`, in the reference's draw order (h0, then v and h per
Gibbs step); the numbers are torch's, not jax's threefry.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .layers import FeedForwardLayer, register_layer


def draw_uniform(generator, shape, dtype, device) -> torch.Tensor:
    """U[0, 1) samples of ``shape`` from ``generator``."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def draw_normal(generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) samples of ``shape`` from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _bernoulli(generator, p) -> torch.Tensor:
    """1 where a uniform draw falls below ``p`` (``jax.random.bernoulli``'s
    rule), in ``p``'s dtype."""
    return (draw_uniform(generator, p.shape, p.dtype, p.device) < p).to(p.dtype)


@dataclasses.dataclass
class BasePretrainLayer(FeedForwardLayer):
    """Shared parameters: W [n_in, n_out], hidden bias b, visible bias
    vb."""

    loss: str = "mse"   # reconstruction loss: mse | xent | mse_act

    def param_shapes(self, policy=None):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        w = init_weights(gen, (self.n_in, self.n_out),
                         self.weight_init or "XAVIER", fan_in=self.n_in,
                         fan_out=self.n_out, distribution=self.dist,
                         dtype=dt, device=device)
        return {"W": w,
                "b": torch.zeros((self.n_out,), dtype=dt, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dt, device=device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        """The encoder: act(x W + b)."""
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        xc, wc = policy.cast_to_compute(x, params["W"])
        return self._act()(xc @ wc + params["b"].to(xc.dtype)), state

    def reconstruction_error(self, params, x, *, policy=None) -> torch.Tensor:
        """Mean reconstruction loss on a batch (no corruption)."""
        h, _ = self.apply(params, x, policy=policy)
        return self._recon_loss(params, h, x)

    def _decode(self, params, h):
        return h @ params["W"].t().to(h.dtype) + params["vb"].to(h.dtype)

    def _recon_loss(self, params, h, x):
        z = self._decode(params, h)
        if self.loss == "xent":
            # sigmoid cross-entropy against inputs in [0, 1], stable form
            return torch.mean(torch.sum(
                torch.clamp_min(z, 0) - z * x
                + torch.log1p(torch.exp(-torch.abs(z))), dim=-1))
        recon = self._act()(z) if self.loss == "mse_act" else z
        return torch.mean(torch.sum((recon - x) ** 2, dim=-1))


@register_layer("autoencoder")
@dataclasses.dataclass
class AutoEncoder(BasePretrainLayer):
    """Denoising autoencoder: masking noise at ``corruption_level``, a
    tied-weight decode."""

    corruption_level: float = 0.3

    def pretrain_loss(self, params, x, generator, *, policy=None):
        x_in = x
        if self.corruption_level > 0.0 and generator is not None:
            keep = draw_uniform(generator, x.shape, x.dtype, x.device) \
                < 1.0 - self.corruption_level
            x_in = x * keep.to(x.dtype)
        h, _ = self.apply(params, x_in, policy=policy)
        return self._recon_loss(params, h, x)


@register_layer("rbm")
@dataclasses.dataclass
class RBM(BasePretrainLayer):
    """Restricted Boltzmann machine: binary or rectified hidden units,
    binary or gaussian visible units, CD-k."""

    hidden_unit: str = "binary"    # binary | rectified
    visible_unit: str = "binary"   # binary | gaussian
    k: int = 1                     # CD-k Gibbs steps

    def prop_up(self, params, v):
        return torch.sigmoid(v @ params["W"].to(v.dtype)
                             + params["b"].to(v.dtype))

    def prop_down(self, params, h):
        z = self._decode(params, h)
        return z if self.visible_unit == "gaussian" else torch.sigmoid(z)

    def _sample_h(self, params, v, generator):
        p = self.prop_up(params, v)
        if self.hidden_unit == "rectified":
            return torch.clamp_min(p, 0.0), p
        return _bernoulli(generator, p), p

    def _sample_v(self, params, h, generator):
        p = self.prop_down(params, h)
        if self.visible_unit == "gaussian":
            return p + draw_normal(generator, p.shape, p.dtype, p.device), p
        return _bernoulli(generator, p), p

    def contrastive_divergence_grads(self, params, v0, generator):
        """CD-k statistics as (pseudo-)gradients for W, b and vb: the
        positive phase at the data, the negative phase after ``k`` Gibbs
        steps from the sampled hidden units."""
        h_sample, h0_prob = self._sample_h(params, v0, generator)
        vk, hk_prob = None, None
        for _ in range(self.k):
            vk, _ = self._sample_v(params, h_sample, generator)
            h_sample, hk_prob = self._sample_h(params, vk, generator)
        n = v0.shape[0]
        return {"W": -(v0.t() @ h0_prob - vk.t() @ hk_prob) / n,
                "b": -torch.mean(h0_prob - hk_prob, dim=0),
                "vb": -torch.mean(v0 - vk, dim=0)}

    def free_energy(self, params, v) -> torch.Tensor:
        """Mean free energy (for monitoring)."""
        wx_b = v @ params["W"].to(v.dtype) + params["b"].to(v.dtype)
        vbias_term = v @ params["vb"].to(v.dtype)
        hidden_term = torch.sum(torch.nn.functional.softplus(wx_b), dim=-1)
        return -torch.mean(hidden_term + vbias_term)


def make_pretrain_step(layer, lr: float, policy=None):
    """One-batch pretrain update of a pretrainable layer, in place: CD-k
    for an RBM, reconstruction-loss SGD for an autoencoder. ``step(params,
    x, generator)`` updates the ``{name: tensor}`` dict and returns it.
    Shared by both network runtimes' ``pretrain``."""
    if hasattr(layer, "contrastive_divergence_grads"):
        def grads_of(params, v, generator):
            with torch.no_grad():
                return layer.contrastive_divergence_grads(params, v,
                                                          generator)
    else:
        def grads_of(params, x, generator):
            with torch.enable_grad():
                live = {k: p.detach().requires_grad_(True)
                        for k, p in params.items()}
                loss = layer.pretrain_loss(live, x, generator, policy=policy)
                gs = torch.autograd.grad(loss, list(live.values()))
            return dict(zip(live, gs))

    def step(params, x, generator):
        grads = grads_of(params, x, generator)
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * grads[k].to(p.dtype))
        return params
    return step
