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

:func:`update_in_place` is the runtimes' step: the same update applied to
the parameters in place. The route is a pure rule of what the code can
observe: under adam, a leaf whose p, g, m and v are contiguous f32 CUDA
tensors of one size on one device (``ops.fused_adam.takes``) goes to the
multi-tensor kernel, which updates every such leaf in one pass, p, m and v
in place, bitwise as ``update()`` + :func:`apply_updates` would; the other
leaves, and every other rule, run the plain path.
``updater_leaves_total{model, path}`` counts the leaves each path took.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.training import TrainingConfig
from ..ops import fused_adam as _fused_adam
from ..util import metrics as _metrics

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


def _flatten(tree, *others, prefix=(), out=None):
    """(the leaves' key paths, ``tree``'s leaves, and each of ``others``'s
    leaves at the same paths), in ``_leaves`` order: one walk."""
    if out is None:
        out = ([], []) + tuple([] for _ in others)
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, *(o[k] for o in others), prefix=prefix + (k,),
                     out=out)
        elif v is not None:
            out[0].append(prefix + (k,))
            out[1].append(v)
            for leaves, o in zip(out[2:], others):
                leaves.append(o[k])
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _from_paths(paths, leaves, like=None):
    """Nested dicts with ``leaves`` at ``paths``, shaped as ``like`` (its
    empty dicts kept) where given."""
    out = {} if like is None else _map(lambda _: None, like)
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


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
    # (params, grads, state, iteration, want_deltas) -> (deltas or None,
    # new state, fused leaves, plain leaves): the rule's own in-place step,
    # where it has one (adam); :func:`update_in_place` runs the plain path
    # otherwise
    step: Optional[Callable[..., Tuple[Optional[Tree], Tree, int, int]]] = None


def leaves_counter(registry=None) -> _metrics.Counter:
    return (registry or _metrics.REGISTRY).counter(
        "updater_leaves_total",
        "Parameter leaves one training update updated, by path: 'fused' "
        "the multi-tensor adam kernel, 'plain' the per-leaf ops",
        ("model", "path"))


def update_in_place(updater: Updater, params: Tree, grads: Tree, state: Tree,
                    iteration: int, *, want_deltas: bool = False,
                    model: str = "") -> Tuple[Optional[Tree], Tree]:
    """One update applied to ``params`` in place: what ``updater.update`` and
    :func:`apply_updates` compute, through the rule's fused step where it
    has one. Returns (the deltas — None from a fused step unless
    ``want_deltas`` —, the new state), and counts the leaves each path took
    in ``updater_leaves_total{model, path}``."""
    if updater.step is not None:
        deltas, state, fused, plain = updater.step(params, grads, state,
                                                   iteration, want_deltas)
    else:
        deltas, state = updater.update(grads, state, iteration)
        apply_updates(params, deltas)
        fused, plain = 0, sum(1 for _ in _leaves(grads))
    counter = leaves_counter()
    counter.inc(fused, model=model, path="fused")
    counter.inc(plain, model=model, path="plain")
    return deltas, state


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

        def update(grads, state, iteration, lrs=None):
            if lrs is None:
                lrs = lr_tree(grads, iteration)
            m = _map(lambda m_, g: b1 * m_ + (1 - b1) * to_f32(g),
                     state["m"], grads)
            if name == "adam":
                # times the f32 reciprocals of the bias corrections, as ATen
                # computes a tensor over a Python scalar on the card, on
                # every device (the fused kernel's arithmetic)
                s = _fused_adam.Scalars.at(b1, b2, eps, iteration)
                v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(to_f32(g)),
                         state["v"], grads)
                deltas = _map(lambda m_, v_, lr: lr * (m_ * s.ibc1)
                              / (torch.sqrt(v_ * s.ibc2) + eps),
                              m, v, lrs)
                return deltas, {"m": m, "v": v}
            tstep = _F32(iteration) + _F32(1.0)
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
                deltas = _map(
                    lambda m_, v_, g, lr: lr
                    * (b1 * m_ / bc1 + (1 - b1) * to_f32(g) / bc1)
                    / (torch.sqrt(v_ / bc2) + eps),
                    m, v, grads, lrs)
            return deltas, {"m": m, "v": v}

        if name != "adam":
            return Updater(name, init, update)

        mults_of = {}      # the leaves' LR multipliers, by key paths

        def step(params, grads, state, iteration, want_deltas):
            """The leaves the kernel takes (``ops.fused_adam.takes``)
            through it in one pass (p, m, v in place; the deltas written
            where wanted); the rest through ``update``'s per-leaf ops, as
            their own tree."""
            paths, gs, ps, ms, vs = _flatten(grads, params, state["m"],
                                             state["v"])
            lr = _F32(learning_rate_at(t, iteration))
            if lr_multipliers is None:
                lrs = [float(lr)] * len(paths)
            else:
                key = tuple(paths)
                if key not in mults_of:
                    mults_of[key] = np.array(
                        [_at(lr_multipliers, path) for path in paths],
                        dtype=_F32)
                lrs = (lr * mults_of[key]).tolist()     # f32 products
            # the rule's check and the kernel's table entries, in one pass
            recs = _fused_adam.records(ps, gs, ms, vs)
            fused = [i for i, r in enumerate(recs) if r is not None]
            plain = [i for i, r in enumerate(recs) if r is None]
            deltas = [None] * len(gs)
            if fused:
                ds = ([torch.empty_like(ps[i]) for i in fused]
                      if want_deltas else None)
                _fused_adam.adam_(*([x[i] for i in fused]
                                    for x in (ps, gs, ms, vs, lrs)),
                                  _fused_adam.Scalars.at(b1, b2, eps,
                                                         iteration), ds,
                                  recs=[recs[i] for i in fused])
                for j, i in enumerate(fused if want_deltas else ()):
                    deltas[i] = ds[j]
            new_state = state       # the fused leaves' m and v, in place
            if plain:
                sub = [paths[i] for i in plain]
                sub_d, sub_state = update(
                    _from_paths(sub, [gs[i] for i in plain]),
                    {"m": _from_paths(sub, [ms[i] for i in plain]),
                     "v": _from_paths(sub, [vs[i] for i in plain])},
                    iteration, _from_paths(sub, [lrs[i] for i in plain]))
                apply_updates(_from_paths(sub, [ps[i] for i in plain]),
                              sub_d)
                for i, path in zip(plain, sub):
                    deltas[i] = _at(sub_d, path)
                    ms[i] = _at(sub_state["m"], path)
                    vs[i] = _at(sub_state["v"], path)
                new_state = {"m": _from_paths(paths, ms, grads),
                             "v": _from_paths(paths, vs, grads)}
            out = (_from_paths(paths, deltas, grads)
                   if want_deltas or not fused else None)
            return out, new_state, len(fused), len(plain)

        return Updater(name, init, update, torch.no_grad()(step))

    raise ValueError(f"unknown updater {name!r}; known: sgd, nesterovs, "
                     "adagrad, rmsprop, adadelta, adam, adamax, nadam, none")
