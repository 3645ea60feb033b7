"""ComputationGraph: the DAG runtime model (counterpart of the JAX package's
``nn/graph_runtime.py``).

An ``nn.Module`` holding one ``ParameterDict`` per parameterised vertex.
The forward walks the configuration's topological order — the reference's
order — applying each vertex's forward function. PyTorch runs it eagerly;
the reference's ``jax.jit`` has no counterpart here.

Training follows the reference's train step: the loss (``_loss_fn``,
output vertices scored from their hidden input, plus the l1/l2 penalty),
its gradients (torch autograd in place of ``jax.grad``), gradient
normalization, the updater's deltas, and the parameters updated in place.
``fit_batch`` takes one step, ``fit_repeated`` K steps on one batch and
``fit_scan`` one step on each of K staged batches; the losses stay on the
device. Layer state (BatchNormalization's running statistics) is created
with the parameters, read by every forward and persisted after each
training step; ``output()`` never touches it. Dropout draws from a
``torch.Generator`` on the net's device, seeded from the configuration's
seed and the update count. Listeners fire at the reference's points,
with the loss as a ``LazyScore`` (``fit_repeated``/``fit_scan`` read
their K losses in one transfer first, as the reference replays them). With
``enable_health_stats()`` the step also reduces the per-layer health
stats (``util/health.py``) beside its update, from the same gradients
and deltas; ``fit_repeated``/``fit_scan`` keep the last step's. Truncated
BPTT and gradient checkpointing are not yet ported and raise
``NotYetPorted``.

Streaming inference (``rnn_time_step``) carries each attention layer's
K/V cache between calls; the fed-step count that the reference keeps
in-band in the cache lives on the host here (``_rnn_steps_fed`` and each
cache's ``"pos"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as _dtypes
from .. import losses as _losses
from ..optimize import updaters as _updaters
from ..optimize.listeners import as_listener_score
from ..util import health as _health
from .conf.graph import ComputationGraphConfiguration, LayerVertex
from .conf.layers import NotYetPorted
from ..util.netutil import (named_generator, note_streamed_steps,
                             precheck_streamed_steps)


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


class ComputationGraph(torch.nn.Module):
    """Runtime DAG network over a :class:`ComputationGraphConfiguration`.

    ``device`` defaults to ``"cuda"``; without a card that raises rather
    than running on the CPU unasked — pass ``device="cpu"`` for the CPU.
    Parameters are created by :meth:`init` (random, from the configured
    seed) or loaded (``util.serialization.load_model`` /
    ``params_from_numpy``)."""

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
        super().__init__()
        conf.validate()
        self.conf = conf
        self.device = _dtypes.resolve_device(device)
        self.policy = _dtypes.policy_from_name(conf.training.dtype)
        self.topo_order = conf.topological_order()
        for name in self.topo_order:
            if "." in name or not name:
                raise ValueError(f"vertex name {name!r} cannot hold "
                                 "parameters (empty or contains '.')")
        self.vertex_params = torch.nn.ModuleDict()
        self._has_params = False
        self.state: Dict[str, Dict[str, torch.Tensor]] = self._init_state()
        self._persistent_keys = {n: tuple(st) for n, st in self.state.items()
                                 if st}
        # the optimizer state: the reference's tree, f32, on self.device
        self.updater_state: Optional[Dict[str, Any]] = None
        self._updater: Optional[_updaters.Updater] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._update_count = 0
        self._score: Optional[torch.Tensor] = None
        self._output_layer_names = [
            n for n in conf.network_outputs
            if hasattr(self._vertex_layer(n), "compute_score_array")]
        # streaming carries (rnn_time_step): {vertex: cache state}
        self._rnn_state: Optional[Dict[str, Dict[str, Any]]] = None
        self._rnn_steps_fed = 0
        self.listeners: List[Any] = []
        # training-health stats (util.health): None = off
        self.health_stats: Optional[_health.StatsConfig] = None
        self._last_health_stats: Optional[_health.DeviceStats] = None

    def _vertex_layer(self, name: str):
        v = self.conf.vertices[name]
        return v.layer if isinstance(v, LayerVertex) else None

    def _init_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {n: self.conf.vertices[n].init_state(self.policy, self.device)
                for n in self.topo_order}

    def _persist_states(self, new_states) -> None:
        """Keep the persistent (``init_state``-declared) entries of a
        training step's new vertex states, e.g. BN running statistics."""
        for name, keys in self._persistent_keys.items():
            st = new_states.get(name) or {}
            if any(k in st for k in keys):
                self.state[name] = {k: st[k].detach() for k in keys
                                    if k in st}

    def _generator(self, name: str) -> Optional[torch.Generator]:
        """The dropout generator of one step (None when nothing drops)."""
        if not any((layer.dropout or 0.0) > 0.0
                   for layer in map(self._vertex_layer, self.topo_order)
                   if layer is not None):
            return None
        return named_generator(self.device, self.conf.training.seed, name)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    @property
    def params(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """{vertex: {param name: tensor}} (None before init/load)."""
        if not self._has_params:
            return None
        return {n: (dict(self.vertex_params[n])
                    if n in self.vertex_params else {})
                for n in self.topo_order}

    def set_params(self, tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Install parameters, checked name by name and shape by shape
        against the configuration."""
        new = torch.nn.ModuleDict()
        for name in self.topo_order:
            want = self.conf.vertices[name].param_shapes(self.policy)
            got = tree.get(name, {})
            if set(got) != set(want):
                raise ValueError(
                    f"vertex {name!r}: parameters {sorted(got)} do not match "
                    f"the configuration's {sorted(want)}")
            pd = torch.nn.ParameterDict()
            for k, shape in want.items():
                t = torch.as_tensor(got[k])
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"vertex {name!r} param {k!r}: shape "
                                     f"{tuple(t.shape)}, expected {shape}")
                pd[k] = torch.nn.Parameter(t.to(self.device))
            if want:
                new[name] = pd
        extra = set(tree) - set(self.topo_order)
        if any(tree[n] for n in extra):
            raise ValueError(f"parameters for unknown vertices {sorted(extra)}")
        self.vertex_params = new
        self._has_params = True

    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Random parameters from ``torch.Generator``s seeded per vertex
        from the configured seed (the same schemes and distributions as the
        reference, not the same numbers)."""
        seed = self.conf.training.seed if seed is None else seed
        tree = {}
        for name in self.topo_order:
            tree[name] = self.conf.vertices[name].init_params(
                named_generator("cpu", seed, name), self.policy, self.device)
        self.set_params(tree)
        self.state = self._init_state()
        self.init_updater()
        return self

    def init_updater(self) -> None:
        """Build the updater from the training configuration and a fresh
        (zero) optimizer state for the current parameters."""
        self._updater = _updaters.make_updater(self.conf.training,
                                               self._lr_multipliers())
        self.updater_state = self._updater.init(self.params)

    def _lr_multipliers(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter multipliers of the global learning rate: a layer's
        ``learning_rate`` for its weights, ``bias_learning_rate`` (else the
        layer's rate) for ``b`` (the reference's ``_lr_multipliers``)."""
        base = float(self.conf.training.learning_rate)
        mults = {}
        for name in self.topo_order:
            layer = self._vertex_layer(name)
            shapes = self.conf.vertices[name].param_shapes(self.policy)
            if layer is None or not shapes:
                mults[name] = {k: 1.0 for k in shapes}
                continue
            layer_lr = (layer.learning_rate
                        if layer.learning_rate is not None else base)
            bias_lr = (layer.bias_learning_rate
                       if layer.bias_learning_rate is not None else layer_lr)
            if base == 0.0:
                if layer_lr != 0.0 or bias_lr != 0.0:
                    raise ValueError(
                        f"vertex {name!r} sets a per-layer learning rate but "
                        "the global learning_rate is 0.0")
                mults[name] = {k: 1.0 for k in shapes}
            else:
                mults[name] = {k: (bias_lr / base if k == "b"
                                   else layer_lr / base) for k in shapes}
        return mults

    def num_params(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------
    # forward over the DAG
    # ------------------------------------------------------------------

    def _to_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _require_params(self):
        params = self.params
        if params is None:
            raise ValueError("call init() or load parameters first")
        return params

    def _forward(self, inputs: List[torch.Tensor], masks=None, *,
                 params=None, train=False,
                 generator=None) -> Dict[str, torch.Tensor]:
        """Walk the topo order; returns {vertex: activation}. ``masks``:
        one per network input (or None), propagated along the DAG by each
        vertex's ``output_mask``. (``output`` passes none, as in the
        reference.) ``params`` replaces the net's parameters (NaN
        attribution replays a poisoned tree). ``train`` runs the train-mode
        forward (dropout from ``generator``, BN batch statistics) without
        touching the layer state."""
        params = self._require_params() if params is None else params
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        minibatch = inputs[0].shape[0]
        for name in self.topo_order:
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_masks = [mask_map.get(i) for i in in_names]
            out, _ = v.apply(params[name], [acts[i] for i in in_names],
                             state=self.state.get(name), policy=self.policy,
                             masks=in_masks, minibatch=minibatch,
                             train=train, generator=generator)
            acts[name] = out
            mask_map[name] = v.output_mask(in_masks)
        return acts

    def output(self, *inputs, train: bool = False):
        """Activations of the network outputs, computed under
        ``torch.inference_mode()``. Inputs may be numpy arrays or tensors;
        returns one tensor when there is one output, else a list.
        ``train=True`` runs the train-mode forward (dropout active, BN
        batch statistics) without updating parameters or state."""
        inputs = [self._to_input(x) for x in _as_list(
            inputs[0] if len(inputs) == 1 and isinstance(inputs[0], (list, tuple))
            else list(inputs))]
        gen = (self._generator(f"output_{self.iteration_count}")
               if train else None)
        with torch.inference_mode():
            acts = self._forward(inputs, train=train, generator=gen)
        outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def _zero_rnn_carry(self, batch: int) -> Dict[str, Dict[str, Any]]:
        """Fresh streaming carries: each layer with a ``_zero_state`` (the
        attention layers built with ``max_cache_t``) gets its zero K/V
        cache."""
        carry = {}
        for name in self.topo_order:
            layer = self._vertex_layer(name)
            if (layer is not None and hasattr(layer, "_zero_state")
                    and getattr(layer, "max_cache_t", None) is not None):
                carry[name] = layer._zero_state(batch, self.policy,
                                                self.device)
        return carry

    def evaluate(self, data, labels=None):
        """Classification :class:`~..eval.Evaluation` of ``output`` (one
        input, one output) over an iterable of batches or (x, y)
        arrays."""
        from ..eval.evaluation import evaluate_network
        return evaluate_network(self, data, labels)

    def rnn_time_step(self, *inputs):
        """Streaming inference: feed one (or a few) timesteps, carrying each
        attention layer's K/V cache between calls (the reference's
        ``rnnTimeStep``). Inputs: ``[b, f]`` (one step; the output is
        squeezed back) or ``[b, t, f]``; token ids ``[b, t, 1]``. The
        strict-mode precheck runs before any device work."""
        inputs = _as_list(
            inputs[0] if len(inputs) == 1 and isinstance(inputs[0], (list, tuple))
            else list(inputs))
        shape = np.shape(inputs[0])
        squeeze = len(shape) == 2
        t_new = 1 if squeeze else shape[1]
        if self._rnn_state is None:
            self._rnn_steps_fed = 0
        # strict-mode streaming caches refuse the overflowing chunk before
        # any device work
        precheck_streamed_steps(self, t_new)
        inputs = [self._to_input(x) for x in inputs]
        if squeeze:
            inputs = [x[:, None, :] for x in inputs]
        if self._rnn_state is None:
            self._rnn_state = self._zero_rnn_carry(inputs[0].shape[0])
        params = self._require_params()
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        with torch.inference_mode():
            for name in self.topo_order:
                v = self.conf.vertices[name]
                in_names = self.conf.vertex_inputs[name]
                carry = self._rnn_state.get(name)
                out, st = v.apply(params[name], [acts[i] for i in in_names],
                                  state=(carry if carry is not None
                                         else self.state.get(name)),
                                  policy=self.policy,
                                  masks=[None] * len(in_names),
                                  minibatch=inputs[0].shape[0])
                if carry is not None:
                    self._rnn_state[name] = st
                acts[name] = out
        # count only steps the cache absorbed (a refused chunk raised above)
        note_streamed_steps(self, t_new)
        outs = [acts[n] for n in self.conf.network_outputs]
        if squeeze:
            outs = [o[:, 0, :] if o.ndim == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        """Reset the streaming carries (the reference's
        ``rnnClearPreviousState``)."""
        self._rnn_state = None
        self._rnn_steps_fed = 0

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def _loss_fn(self, inputs, labels, masks=None, *, params=None,
                 collect_stats: Optional[_health.StatsConfig] = None,
                 generator=None, new_states: Optional[Dict] = None):
        """The training loss: every vertex but the output layers runs
        forward (with ``train=True`` and the dropout ``generator``); each
        output layer is scored from its hidden input (``_output_score``);
        the l1/l2 penalty is added. The reference's unsegmented walk. With
        ``collect_stats`` it returns ``(loss, {vertex: act_moments})``,
        each vertex's activation summarised (detached) as it is produced.
        ``params`` replaces the net's parameters; ``new_states``, a dict,
        receives each vertex's new state (the caller persists it)."""
        if not self._output_layer_names:
            raise ValueError(
                "no output vertex has a loss (need an output layer at a "
                "network output to train)")
        if self.conf.training.gradient_checkpointing:
            raise NotYetPorted("gradient_checkpointing is not yet ported to "
                               "the PyTorch package")
        params = self._require_params() if params is None else params
        out_set = set(self._output_layer_names)
        act_stats: Dict[str, tuple] = {}
        # output layers that also feed other vertices still run forward
        consumed = {i for ins in self.conf.vertex_inputs.values() for i in ins}
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        label_map = dict(zip(self.conf.network_outputs, labels))
        minibatch = inputs[0].shape[0]
        total = 0.0
        for name in self.topo_order:
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_masks = [mask_map.get(i) for i in in_names]
            if name in out_set:
                total = total + self._output_score(
                    params, name, acts[in_names[0]], label_map[name],
                    in_masks[0] if in_masks else None)
            if name not in out_set or name in consumed:
                out, st = v.apply(params[name], [acts[i] for i in in_names],
                                  state=self.state.get(name),
                                  policy=self.policy, masks=in_masks,
                                  train=True, generator=generator,
                                  minibatch=minibatch)
                if new_states is not None:
                    new_states[name] = st
                acts[name] = out
                mask_map[name] = v.output_mask(in_masks)
                if collect_stats is not None:
                    act_stats[name] = _health.act_moments(
                        out, collect_stats.act_sample)
        total = total + self._reg_penalty(params)
        if collect_stats is not None:
            return total.to(self._loss_dtype()), act_stats
        return total.to(self._loss_dtype())

    def _loss_dtype(self):
        return (torch.float64 if self.policy.param_dtype == torch.float64
                else torch.float32)

    def _output_score(self, params, name, hidden, y, mask):
        """One output vertex's loss contribution from its hidden input:
        the fused score array over the masked denominator."""
        layer = self.conf.vertices[name].layer
        score_arr = layer.compute_score_array(params[name], hidden, y,
                                              mask=mask, policy=self.policy)
        denom = _losses.masked_denominator(
            mask, y, score_arr.shape[0], sparse=_losses.is_sparse(layer.loss))
        return torch.sum(score_arr) / denom

    def _reg_penalty(self, params):
        """l1·Σ|w| + ½·l2·Σw² over each layer's ``regularized_params``,
        when the configuration turns regularization on."""
        if not self.conf.training.regularization:
            return 0.0
        total = 0.0
        for name in self.topo_order:
            layer = self._vertex_layer(name)
            if layer is None:
                continue
            l1, l2 = float(layer.l1 or 0.0), float(layer.l2 or 0.0)
            if l1 == 0.0 and l2 == 0.0:
                continue
            for pname in layer.regularized_params():
                if pname not in params[name]:
                    continue
                w = params[name][pname].to(self._loss_dtype())
                if l1:
                    total = total + l1 * torch.sum(torch.abs(w))
                if l2:
                    total = total + 0.5 * l2 * torch.sum(torch.square(w))
        return total

    def _stage(self, inputs, labels, masks):
        """Inputs, labels and masks as lists of tensors on the device."""
        inputs = [self._to_input(x) for x in _as_list(inputs)]
        labels = [self._to_input(y) for y in _as_list(labels)]
        if masks is not None:
            masks = [None if m is None else self._to_input(m)
                     for m in _as_list(masks)]
        return inputs, labels, masks

    def score_for(self, inputs, labels, masks=None) -> float:
        """The loss on one batch, without a gradient or an update."""
        inputs, labels, masks = self._stage(inputs, labels, masks)
        with torch.no_grad():
            return float(self._loss_fn(inputs, labels, masks))

    def score(self) -> Optional[float]:
        """The last training step's loss (one host sync), or None."""
        return None if self._score is None else float(self._score)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def enable_health_stats(self, config=True) -> None:
        """Reduce the per-layer training-health stats (``util.health``) in
        every training step from the next fit call on. Consumers read
        ``util.health.latest_stats(net)`` — one host sync per read, the
        snapshot carries the step loss."""
        self.health_stats = _health.StatsConfig.coerce(config)

    def disable_health_stats(self) -> None:
        self.health_stats = None

    def set_listeners(self, *listeners) -> None:
        # varargs or one collection (the reference's two overloads)
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def _fire_iteration(self, batch_size, loss) -> None:
        self.iteration_count += 1
        if not self.listeners:
            return
        # the device loss reaches the host only when a listener reads it
        score = as_listener_score(loss)
        for listener in self.listeners:
            if hasattr(listener, "record_batch"):
                listener.record_batch(batch_size)
            listener.iteration_done(self, self.iteration_count, score)

    def _fire_replay(self, batch_size, losses: torch.Tensor) -> None:
        """Listener firing for K updates in one call: one transfer of the
        K losses, then one firing per update with host floats."""
        k = int(losses.shape[0])
        if not self.listeners:
            self.iteration_count += k
            return
        per_step = losses.detach().cpu().numpy()
        for i in range(k):
            self._fire_iteration(batch_size, per_step[i])

    def _check_trainable(self, api: str) -> None:
        if self.conf.backprop_type == "truncated_bptt":
            raise NotYetPorted(f"{api}: truncated BPTT is not yet ported to "
                               "the PyTorch package")

    def _loss_and_grads(self, inputs, labels, masks, collect_stats=None,
                        generator=None, new_states=None):
        """(loss, {vertex: {param: grad}}) — ``jax.value_and_grad`` of the
        reference's ``_loss_fn``, by torch autograd; with
        ``collect_stats``, (loss, grads, activation stats). ``new_states``
        receives the vertices' new states."""
        params = self._require_params()
        named = [(v, k, p) for v, ps in params.items() for k, p in ps.items()]
        out = self._loss_fn(inputs, labels, masks,
                            collect_stats=collect_stats, generator=generator,
                            new_states=new_states)
        loss, act_stats = out if collect_stats is not None else (out, None)
        gs = torch.autograd.grad(loss, [p for _, _, p in named],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {v: {} for v in params}
        for (v, k, p), g in zip(named, gs):
            grads[v][k] = torch.zeros_like(p) if g is None else g
        if collect_stats is None:
            return loss.detach(), grads
        return loss.detach(), grads, act_stats

    def _step_and_update(self, inputs, labels, masks, stats=None):
        """One update: loss and gradients, gradient normalization, the
        updater's deltas subtracted from the parameters in place. Returns
        the loss on the device; with ``stats`` (a ``StatsConfig``),
        ``(loss, health stats tree)`` — reduced after the update from the
        raw gradients, the deltas and the updated parameters, so the
        update itself is the same computation either way."""
        if self._updater is None:
            self.init_updater()
        t = self.conf.training
        gen = self._generator(f"update_{self._update_count}")
        new_states: Dict[str, Any] = {}
        if stats is None:
            loss, grads_raw = self._loss_and_grads(
                inputs, labels, masks, generator=gen, new_states=new_states)
            act_stats = None
        else:
            loss, grads_raw, act_stats = self._loss_and_grads(
                inputs, labels, masks, collect_stats=stats, generator=gen,
                new_states=new_states)
        grads = _updaters.normalize_gradients(
            grads_raw, t.gradient_normalization,
            float(t.gradient_normalization_threshold))
        deltas, self.updater_state = self._updater.update(
            grads, self.updater_state, self._update_count)
        params = self.params
        _updaters.apply_updates(params, deltas)
        self._update_count += 1
        self._persist_states(new_states)
        if stats is None:
            return loss
        with torch.no_grad():
            tree = _health.model_stats(params, grads_raw, deltas, act_stats,
                                       stats, loss=loss)
        return loss, tree

    def _steps(self, batches) -> torch.Tensor:
        """One update per (inputs, labels, masks) of ``batches``; the last
        one reduces the health stats when they are on. Returns the [k]
        losses on the device."""
        cfg = self.health_stats
        losses = []
        for i, (x, y, m) in enumerate(batches):
            last = cfg is not None and i == len(batches) - 1
            out = self._step_and_update(x, y, m, stats=cfg if last else None)
            if last:
                out, tree = out
                self._last_health_stats = _health.DeviceStats(
                    tree, iteration=self.iteration_count + len(batches),
                    model="ComputationGraph")
            losses.append(out)
        losses = torch.stack(losses)
        self._score = losses[-1]
        return losses

    def fit_batch(self, inputs, labels, masks=None) -> torch.Tensor:
        """One update. inputs/labels: an array or a list of arrays
        (multi-input / multi-output); masks: optional list of feature
        masks. Returns the loss as a 0-dim tensor on the device."""
        self._check_trainable("fit_batch")
        inputs, labels, masks = self._stage(inputs, labels, masks)
        loss = self._steps([(inputs, labels, masks)])[0]
        self._fire_iteration(inputs[0].shape[0], loss)
        return loss

    def fit_repeated(self, inputs, labels, k: int, masks=None) -> torch.Tensor:
        """K updates on one batch: the same steps as K ``fit_batch`` calls,
        with the losses kept on the device — the caller's read of the
        returned [k] tensor is the one host sync (listeners, when set,
        read them once for their replay)."""
        self._check_trainable("fit_repeated")
        inputs, labels, masks = self._stage(inputs, labels, masks)
        losses = self._steps([(inputs, labels, masks)] * int(k))
        self._fire_replay(inputs[0].shape[0], losses)
        return losses

    def fit_scan(self, xs, ys, masks=None) -> torch.Tensor:
        """One update on each of K staged batches: xs/ys are [k, b, ...]
        arrays or lists of such (multi-input / multi-output), masks
        optional likewise. Returns the [k] losses on the device."""
        self._check_trainable("fit_scan")
        xs, ys, masks = self._stage(xs, ys, masks)
        batches = [([x[i] for x in xs], [y[i] for y in ys],
                    None if masks is None
                    else [None if m is None else m[i] for m in masks])
                   for i in range(xs[0].shape[0])]
        losses = self._steps(batches)
        self._fire_replay(xs[0].shape[1], losses)
        return losses
