"""Updaters: per-parameter learning rules, LR schedules and gradient
normalization (counterpart of the JAX package's ``optimize/updaters.py``;
the same names, math and state layout).

One updater serves the whole network. Trees are nested dicts
``{vertex: {param: tensor}}``; per-layer and per-bias learning rates are
an LR-multiplier tree of the same shape. The optimizer state is the
reference's tree in f32 — e.g. adam's ``{"m": {vertex: {param: tensor}},
"v": ...}`` — so checkpoint paths ``updater/<rule key>/<vertex>/<param>``
map one to one between the packages.

``update()`` returns deltas to subtract; :func:`apply_updates` subtracts
them from the parameters IN PLACE (``p.sub_(delta)`` under
``torch.no_grad()``), where the reference builds new arrays. Scalars (the
scheduled learning rate, bias corrections) are computed on the host in
float32, as the reference computes them on the device, so a step needs no
host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.training import TrainingConfig

Tree = Any
_F32 = np.float32


def _map(fn, *trees):
    """Leaf-wise ``fn`` over nested dicts of the first tree's structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------


def learning_rate_at(t: TrainingConfig, iteration: int) -> float:
    """Scheduled LR at ``iteration``, computed in float32 like the
    reference's traced scalar.

    Policies (reference enum LearningRatePolicy):
      none        lr
      exponential lr * decay^iter
      inverse     lr / (1 + decay*iter)^power
      step        lr * decay^floor(iter / steps)
      torch_step  lr * decay^floor(iter / steps)
      poly        lr * (1 - iter/maxIter)^power    (maxIter := steps)
      sigmoid     lr / (1 + exp(-decay * (iter - steps)))
      schedule    piecewise-constant map {iteration: lr}
    """
    lr = _F32(t.learning_rate)
    it = _F32(iteration)
    policy = (t.lr_policy or "none").lower()
    with np.errstate(over="ignore"):
        if policy == "none":
            out = lr
        elif policy == "exponential":
            out = lr * np.power(_F32(t.lr_policy_decay_rate), it)
        elif policy == "inverse":
            out = lr / np.power(_F32(1.0) + _F32(t.lr_policy_decay_rate) * it,
                                _F32(t.lr_policy_power))
        elif policy in ("step", "torch_step"):
            steps = _F32(max(float(t.lr_policy_steps), 1.0))
            out = lr * np.power(_F32(t.lr_policy_decay_rate),
                                np.floor(it / steps))
        elif policy == "poly":
            max_iter = _F32(max(float(t.lr_policy_steps), 1.0))
            frac = np.clip(it / max_iter, _F32(0.0), _F32(1.0))
            out = lr * np.power(_F32(1.0) - frac, _F32(t.lr_policy_power))
        elif policy == "sigmoid":
            out = lr / (_F32(1.0) + np.exp(-_F32(t.lr_policy_decay_rate)
                                           * (it - _F32(t.lr_policy_steps))))
        elif policy == "schedule":
            # piecewise-constant: the base lr, switched at each scheduled step
            out = lr
            for step in sorted(t.lr_schedule or {}):
                if it >= step:
                    out = _F32(t.lr_schedule[step])
        else:
            raise ValueError(f"unknown lr policy {t.lr_policy!r}")
    return float(_F32(out))


# --------------------------------------------------------------------------
# gradient normalization
# --------------------------------------------------------------------------


def _global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in _leaves(tree)]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack(sq).sum())


def normalize_gradients(grads: Tree, kind: Optional[str],
                        threshold: float = 1.0) -> Tree:
    """One of the reference's 5 GradientNormalization modes. ``grads`` is
    the whole-network ``{vertex: {param: grad}}`` tree, so "per layer" is
    per vertex and "per param type" is per leaf."""
    if not kind or kind == "none":
        return grads
    kind = kind.lower()

    def per_leaf_norm(g):
        return torch.linalg.vector_norm(g.float().reshape(-1))

    if kind == "renormalize_l2_per_layer":
        def per_layer(layer_grads):
            n = torch.clamp(_global_norm(layer_grads), min=1e-8)
            return _map(lambda g: g / n.to(g.dtype), layer_grads)
        return {k: per_layer(v) for k, v in grads.items()}

    if kind == "renormalize_l2_per_param_type":
        return _map(lambda g: g / torch.clamp(per_leaf_norm(g),
                                              min=1e-8).to(g.dtype), grads)

    if kind == "clip_elementwise_absolute_value":
        thr = float(_F32(threshold))
        return _map(lambda g: torch.clamp(g, -thr, thr), grads)

    def clip_scale(n):
        return torch.where(n > threshold,
                           threshold / torch.clamp(n, min=1e-8),
                           torch.ones_like(n))

    if kind == "clip_l2_per_layer":
        def per_layer(layer_grads):
            scale = clip_scale(_global_norm(layer_grads))
            return _map(lambda g: (g * scale).to(g.dtype), layer_grads)
        return {k: per_layer(v) for k, v in grads.items()}

    if kind == "clip_l2_per_param_type":
        return _map(lambda g: (g * clip_scale(per_leaf_norm(g))).to(g.dtype),
                    grads)

    raise ValueError(f"unknown gradient normalization {kind!r}")


# --------------------------------------------------------------------------
# updaters
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Updater:
    """A network-wide learning rule.

    init(params)                              -> optimizer state tree
    update(grads, state, iteration)           -> (deltas, new state)
    apply_updates(params, deltas)             subtracts in place
    """

    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, int], Tuple[Tree, Tree]]


@torch.no_grad()
def apply_updates(params: Tree, deltas: Tree) -> None:
    """``p -= delta`` for every leaf, in place (the reference returns
    ``params - deltas``)."""
    _map(lambda p, d: p.sub_(d.to(p.dtype)), params, deltas)


def all_finite(tree: Tree) -> torch.Tensor:
    """0-dim bool tensor: every floating leaf of ``tree`` is finite."""
    ok = None
    for leaf in _leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else ok & f
    return torch.tensor(True) if ok is None else ok


def select_tree(ok, new: Tree, old: Tree) -> Tree:
    """Leaf-wise ``where(ok, new, old)`` that tolerates ``new`` growing
    container entries ``old`` lacks — unmatched entries keep ``new``."""
    if isinstance(new, dict):
        old = old if isinstance(old, dict) else {}
        return {k: select_tree(ok, v, old.get(k)) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        old = old if isinstance(old, (list, tuple)) else ()
        seq = [select_tree(ok, v, old[i] if i < len(old) else None)
               for i, v in enumerate(new)]
        if isinstance(new, tuple):
            return type(new)(*seq) if hasattr(new, "_fields") else tuple(seq)
        return seq
    if new is None or old is None or not torch.is_tensor(new):
        return new
    return torch.where(ok, new, old)


def _zeros_like_f32(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def make_updater(t: TrainingConfig,
                 lr_multipliers: Optional[Tree] = None) -> Updater:
    """Build the network-wide updater from a TrainingConfig.

    ``lr_multipliers`` is a tree matching the parameters whose leaves scale
    the scheduled global LR per parameter (per-layer ``learning_rate`` and
    ``bias_learning_rate`` overrides). None = all 1.0."""
    name = (t.updater or "sgd").lower()
    eps = float(t.epsilon)

    def lr_tree(grads, iteration):
        lr = _F32(learning_rate_at(t, iteration))
        if lr_multipliers is None:
            return _map(lambda _: float(lr), grads)
        return _map(lambda m: float(lr * _F32(m)), lr_multipliers)

    def to_f32(g):
        return g.float()

    if name in ("sgd", "none"):
        scale = 1.0 if name == "sgd" else 0.0

        def init(params):
            return {}

        def update(grads, state, iteration):
            lrs = lr_tree(grads, iteration)
            deltas = _map(lambda g, lr: scale * lr * to_f32(g), grads, lrs)
            return deltas, state

        return Updater(name, init, update)

    if name == "nesterovs":
        mu = float(t.momentum)

        def init(params):
            return {"v": _zeros_like_f32(params)}

        def update(grads, state, iteration):
            lrs = lr_tree(grads, iteration)
            # Sutskever-style NAG (ND4J's Nesterovs):
            # v' = mu*v - lr*g ; delta = -(mu*v' - lr*g)
            v_new = _map(lambda v, g, lr: mu * v - lr * to_f32(g),
                         state["v"], grads, lrs)
            deltas = _map(lambda v, g, lr: -(mu * v - lr * to_f32(g)),
                          v_new, grads, lrs)
            return deltas, {"v": v_new}

        return Updater(name, init, update)

    if name == "adagrad":
        def init(params):
            return {"accum": _zeros_like_f32(params)}

        def update(grads, state, iteration):
            lrs = lr_tree(grads, iteration)
            accum = _map(lambda a, g: a + torch.square(to_f32(g)),
                         state["accum"], grads)
            deltas = _map(lambda a, g, lr: lr * to_f32(g) / (torch.sqrt(a) + eps),
                          accum, grads, lrs)
            return deltas, {"accum": accum}

        return Updater(name, init, update)

    if name == "rmsprop":
        decay = float(t.rms_decay)

        def init(params):
            return {"accum": _zeros_like_f32(params)}

        def update(grads, state, iteration):
            lrs = lr_tree(grads, iteration)
            accum = _map(lambda a, g: decay * a + (1 - decay) * torch.square(to_f32(g)),
                         state["accum"], grads)
            deltas = _map(lambda a, g, lr: lr * to_f32(g) / torch.sqrt(a + eps),
                          accum, grads, lrs)
            return deltas, {"accum": accum}

        return Updater(name, init, update)

    if name == "adadelta":
        rho = float(t.rho)

        def init(params):
            return {"msg": _zeros_like_f32(params),
                    "msdx": _zeros_like_f32(params)}

        def update(grads, state, iteration):
            msg = _map(lambda a, g: rho * a + (1 - rho) * torch.square(to_f32(g)),
                       state["msg"], grads)
            deltas = _map(lambda a, dx, g: torch.sqrt(dx + eps)
                          / torch.sqrt(a + eps) * to_f32(g),
                          msg, state["msdx"], grads)
            msdx = _map(lambda dx, d: rho * dx + (1 - rho) * torch.square(d),
                        state["msdx"], deltas)
            return deltas, {"msg": msg, "msdx": msdx}

        return Updater(name, init, update)

    if name in ("adam", "adamax", "nadam"):
        b1, b2 = float(t.adam_beta1), float(t.adam_beta2)

        def init(params):
            return {"m": _zeros_like_f32(params),
                    "v": _zeros_like_f32(params)}

        def update(grads, state, iteration):
            lrs = lr_tree(grads, iteration)
            tstep = _F32(iteration) + _F32(1.0)
            m = _map(lambda m_, g: b1 * m_ + (1 - b1) * to_f32(g),
                     state["m"], grads)
            bc1 = float(_F32(1.0) - np.power(_F32(b1), tstep))
            if name == "adamax":
                v = _map(lambda v_, g: torch.maximum(b2 * v_, torch.abs(to_f32(g))),
                         state["v"], grads)
                deltas = _map(lambda m_, v_, lr: lr * (m_ / bc1) / (v_ + eps),
                              m, v, lrs)
            else:
                v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(to_f32(g)),
                         state["v"], grads)
                bc2 = float(_F32(1.0) - np.power(_F32(b2), tstep))
                if name == "nadam":
                    deltas = _map(
                        lambda m_, v_, g, lr: lr
                        * (b1 * m_ / bc1 + (1 - b1) * to_f32(g) / bc1)
                        / (torch.sqrt(v_ / bc2) + eps),
                        m, v, grads, lrs)
                else:
                    deltas = _map(lambda m_, v_, lr: lr * (m_ / bc1)
                                  / (torch.sqrt(v_ / bc2) + eps),
                                  m, v, lrs)
            return deltas, {"m": m, "v": v}

        return Updater(name, init, update)

    raise ValueError(f"unknown updater {name!r}; known: sgd, nesterovs, "
                     "adagrad, rmsprop, adadelta, adam, adamax, nadam, none")
