"""Loss functions (counterpart of the JAX package's ``losses.py``; the same
names and the same math).

Each loss is a plain function of (labels, pre_output, activation name)
giving the per-(example, output) loss array; gradients come from torch
autograd. The softmax/sigmoid + cross-entropy pairs are fused in logit
space for numerical stability, as in the reference.

Per-example semantics (matching the reference):
  L2   = sum_j (y-yhat)^2        MSE  = L2 / n_outputs
  L1   = sum_j |y-yhat|          MAE  = L1 / n_outputs
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .nn import activations as _act

EPS = 1e-7

# (labels, pre_output, activation_name) -> per-(example, output) loss array
# of the labels' shape (before any mask or reduction)
LossFn = Callable[[torch.Tensor, torch.Tensor, str], torch.Tensor]

_REGISTRY: Dict[str, LossFn] = {}


def register(*names: str):
    def deco(fn):
        for n in names:
            _REGISTRY[n.lower()] = fn
        return fn
    return deco


def get(name: str) -> LossFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


def _activate(pre, activation):
    return _act.get(activation)(pre)


@register("mse", "squared_loss")
def mse(labels, pre, activation):
    d = _activate(pre, activation) - labels
    return d * d / labels.shape[-1]


@register("l2")
def l2(labels, pre, activation):
    d = _activate(pre, activation) - labels
    return d * d


@register("mae", "mean_absolute_error")
def mae(labels, pre, activation):
    return torch.abs(_activate(pre, activation) - labels) / labels.shape[-1]


@register("l1")
def l1(labels, pre, activation):
    return torch.abs(_activate(pre, activation) - labels)


@register("xent", "binary_xent", "binary_crossentropy", "reconstruction_crossentropy")
def xent(labels, pre, activation):
    """Binary cross-entropy. Fused in logit space when activation is sigmoid."""
    if activation.lower() == "sigmoid":
        # -[y*log sig(x) + (1-y)*log(1-sig(x))] = max(x,0) - x*y + log(1+exp(-|x|))
        return (torch.clamp(pre, min=0) - pre * labels
                + torch.log1p(torch.exp(-torch.abs(pre))))
    p = torch.clamp(_activate(pre, activation), EPS, 1.0 - EPS)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


@register("mcxent", "negativeloglikelihood", "categorical_crossentropy")
def mcxent(labels, pre, activation):
    """Multi-class cross-entropy. Fused log-softmax when activation is softmax."""
    if activation.lower() == "softmax":
        return -labels * torch.log_softmax(pre, dim=-1)
    p = torch.clamp(_activate(pre, activation), EPS, 1.0 - EPS)
    return -labels * torch.log(p)


@register("sparse_mcxent", "sparse_categorical_crossentropy")
def sparse_mcxent(labels, pre, activation):
    """Integer-class cross-entropy: ``labels`` holds class ids (the shape
    of ``pre`` without its class axis, e.g. [b, t] ids against [b, t, V]
    logits). The same per-row value as ``mcxent`` on the one-hot labels.
    Requires the fused softmax head.

    Out-of-range ids give the reference's
    ``take_along_axis(mode="fill", fill_value=nan)``: an id in [-V, 0)
    wraps (as a negative index does), any other id outside [0, V) gives a
    NaN entry — an off-by-one vocabulary fails loudly instead of training
    against a clamped class."""
    if activation.lower() != "softmax":
        raise ValueError("sparse_mcxent requires activation='softmax' "
                         f"(got {activation!r})")
    logp = torch.log_softmax(pre, dim=-1)
    ids = labels.to(torch.int64)
    vocab = logp.shape[-1]
    ids = torch.where(ids < 0, ids + vocab, ids)
    valid = (ids >= 0) & (ids < vocab)
    picked = torch.gather(logp, -1, ids.clamp(0, vocab - 1)[..., None])[..., 0]
    return -torch.where(valid, picked, float("nan"))


@register("hinge")
def hinge(labels, pre, activation):
    # labels in {-1, +1}
    out = _activate(pre, activation)
    return torch.clamp(1.0 - labels * out, min=0.0)


@register("squared_hinge")
def squared_hinge(labels, pre, activation):
    h = hinge(labels, pre, activation)
    return h * h


@register("kl_divergence", "kld")
def kld(labels, pre, activation):
    p = torch.clamp(_activate(pre, activation), EPS, 1.0 - EPS)
    y = torch.clamp(labels, EPS, 1.0)
    return y * (torch.log(y) - torch.log(p))


@register("mape", "mean_absolute_percentage_error")
def mape(labels, pre, activation):
    out = _activate(pre, activation)
    denom = torch.where(torch.abs(labels) < EPS, EPS, labels)
    return 100.0 * torch.abs((labels - out) / denom) / labels.shape[-1]


@register("msle", "mean_squared_logarithmic_error")
def msle(labels, pre, activation):
    out = _activate(pre, activation)
    d = (torch.log1p(torch.clamp(out, min=-1 + EPS))
         - torch.log1p(torch.clamp(labels, min=-1 + EPS)))
    return d * d / labels.shape[-1]


@register("poisson")
def poisson(labels, pre, activation):
    out = torch.clamp(_activate(pre, activation), min=EPS)
    return out - labels * torch.log(out)


@register("cosine_proximity")
def cosine_proximity(labels, pre, activation):
    out = _activate(pre, activation)
    ln = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    cos = (torch.sum(labels * out, dim=-1, keepdim=True)
           / torch.clamp(ln * on, min=EPS))
    # broadcast so the per-element array keeps labels' shape; summing over
    # the features then gives n_out * (-cos)/n_out = -cos per example
    return -cos * torch.ones_like(labels) / labels.shape[-1]


def score_array(loss_name: str, labels, pre_output, activation: str,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example loss (summed over output features), mask applied.

    mask may be None, shape [batch], or broadcastable to labels' shape —
    the reference's per-output and per-timestep mask handling."""
    per_elem = get(loss_name)(labels, pre_output, activation)
    if mask is not None:
        m = mask
        while m.ndim < per_elem.ndim:
            m = m[..., None]
        per_elem = per_elem * m
    # sum over all non-batch axes
    axes = tuple(range(1, per_elem.ndim))
    return torch.sum(per_elem, dim=axes) if axes else per_elem


def is_sparse(loss_name: str) -> bool:
    """True for losses whose labels are class ids (no class axis) rather
    than per-output arrays — changes the mask-ndim contract below."""
    return loss_name.lower() in ("sparse_mcxent",
                                 "sparse_categorical_crossentropy")


def masked_denominator(mask: Optional[torch.Tensor], labels, batch_size: int,
                       *, sparse: bool = False):
    """The averaging denominator under the reference's mask-kind contract
    (used by :func:`score` and by the network runtime's loss):
      - mask is None — the batch size;
      - mask.ndim <  labels.ndim — a per-row mask ([b] or [b, t]); the
        denominator is ``sum(mask)``;
      - mask.ndim == labels.ndim — a per-output mask; a row counts as
        active if any of its outputs is unmasked:
        ``sum(any(mask, axis=-1))``.
    ``sparse=True`` (id-labelled losses, :func:`is_sparse`) declares that
    labels carry no class axis, so an equal-ndim mask is per-row there —
    decided by the loss identity, never by the label dtype."""
    if mask is None:
        return float(batch_size)
    if mask.ndim == labels.ndim and not sparse:
        row_active = torch.amax(mask, dim=-1)    # per-output mask
        return torch.clamp(torch.sum(row_active), min=1.0)
    return torch.clamp(torch.sum(mask), min=1.0)  # per-row (example/timestep)


def score(loss_name: str, labels, pre_output, activation: str,
          mask: Optional[torch.Tensor] = None, average: bool = True):
    """Scalar loss. With a mask, averaging divides by the active row count
    (see :func:`masked_denominator`)."""
    arr = score_array(loss_name, labels, pre_output, activation, mask)
    total = torch.sum(arr)
    if not average:
        return total
    return total / masked_denominator(mask, labels, labels.shape[0],
                                      sparse=is_sparse(loss_name))
