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
device. Truncated BPTT, gradient checkpointing, dropout, listeners and
streaming (``rnn_time_step``) are not yet ported and raise
``NotYetPorted``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import torch

from .. import dtypes as _dtypes
from .. import losses as _losses
from ..optimize import updaters as _updaters
from .conf.graph import ComputationGraphConfiguration, LayerVertex
from .conf.layers import NotYetPorted


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _vertex_seed(seed: int, name: str) -> int:
    """Stable 63-bit generator seed per (network seed, vertex name)."""
    digest = hashlib.blake2s(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") >> 1


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
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            n: {} for n in self.topo_order}
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

    def _vertex_layer(self, name: str):
        v = self.conf.vertices[name]
        return v.layer if isinstance(v, LayerVertex) else None

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
        gen = torch.Generator(device="cpu")
        tree = {}
        for name in self.topo_order:
            gen.manual_seed(_vertex_seed(seed, name))
            tree[name] = self.conf.vertices[name].init_params(
                gen, self.policy, self.device)
        self.set_params(tree)
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

    def _forward(self, inputs: List[torch.Tensor],
                 masks=None) -> Dict[str, torch.Tensor]:
        """Walk the topo order; returns {vertex: activation}. ``masks``:
        one per network input (or None), propagated along the DAG by each
        vertex's ``output_mask``. (``output`` passes none, as in the
        reference.)"""
        params = self._require_params()
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        for name in self.topo_order:
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_masks = [mask_map.get(i) for i in in_names]
            out, _ = v.apply(params[name], [acts[i] for i in in_names],
                             state=self.state.get(name), policy=self.policy,
                             masks=in_masks)
            acts[name] = out
            mask_map[name] = v.output_mask(in_masks)
        return acts

    def output(self, *inputs):
        """Activations of the network outputs, computed under
        ``torch.inference_mode()``. Inputs may be numpy arrays or tensors;
        returns one tensor when there is one output, else a list."""
        inputs = [self._to_input(x) for x in _as_list(
            inputs[0] if len(inputs) == 1 and isinstance(inputs[0], (list, tuple))
            else list(inputs))]
        with torch.inference_mode():
            acts = self._forward(inputs)
        outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def _loss_fn(self, inputs, labels, masks=None) -> torch.Tensor:
        """The training loss: every vertex but the output layers runs
        forward (with ``train=True``); each output layer is scored from its
        hidden input (``_output_score``); the l1/l2 penalty is added. The
        reference's unsegmented walk without health stats."""
        if not self._output_layer_names:
            raise ValueError(
                "no output vertex has a loss (need an output layer at a "
                "network output to train)")
        if self.conf.training.gradient_checkpointing:
            raise NotYetPorted("gradient_checkpointing is not yet ported to "
                               "the PyTorch package")
        params = self._require_params()
        out_set = set(self._output_layer_names)
        # output layers that also feed other vertices still run forward
        consumed = {i for ins in self.conf.vertex_inputs.values() for i in ins}
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        label_map = dict(zip(self.conf.network_outputs, labels))
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
                out, _ = v.apply(params[name], [acts[i] for i in in_names],
                                 state=self.state.get(name),
                                 policy=self.policy, masks=in_masks,
                                 train=True)
                acts[name] = out
                mask_map[name] = v.output_mask(in_masks)
        total = total + self._reg_penalty(params)
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

    def set_listeners(self, *listeners) -> None:
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        if listeners:
            raise NotYetPorted("training listeners are not yet ported to "
                               "the PyTorch package")

    def _check_trainable(self, api: str) -> None:
        if self.conf.backprop_type == "truncated_bptt":
            raise NotYetPorted(f"{api}: truncated BPTT is not yet ported to "
                               "the PyTorch package")

    def _loss_and_grads(self, inputs, labels, masks):
        """(loss, {vertex: {param: grad}}) — ``jax.value_and_grad`` of the
        reference's ``_loss_fn``, by torch autograd."""
        params = self._require_params()
        named = [(v, k, p) for v, ps in params.items() for k, p in ps.items()]
        loss = self._loss_fn(inputs, labels, masks)
        gs = torch.autograd.grad(loss, [p for _, _, p in named],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {v: {} for v in params}
        for (v, k, p), g in zip(named, gs):
            grads[v][k] = torch.zeros_like(p) if g is None else g
        return loss.detach(), grads

    def _step_and_update(self, inputs, labels, masks) -> torch.Tensor:
        """One update: loss and gradients, gradient normalization, the
        updater's deltas subtracted from the parameters in place. Returns
        the loss on the device."""
        if self._updater is None:
            self.init_updater()
        t = self.conf.training
        loss, grads = self._loss_and_grads(inputs, labels, masks)
        grads = _updaters.normalize_gradients(
            grads, t.gradient_normalization,
            float(t.gradient_normalization_threshold))
        deltas, self.updater_state = self._updater.update(
            grads, self.updater_state, self._update_count)
        _updaters.apply_updates(self.params, deltas)
        self._update_count += 1
        return loss

    def fit_batch(self, inputs, labels, masks=None) -> torch.Tensor:
        """One update. inputs/labels: an array or a list of arrays
        (multi-input / multi-output); masks: optional list of feature
        masks. Returns the loss as a 0-dim tensor on the device."""
        self._check_trainable("fit_batch")
        inputs, labels, masks = self._stage(inputs, labels, masks)
        loss = self._step_and_update(inputs, labels, masks)
        self._score = loss
        self.iteration_count += 1
        return loss

    def fit_repeated(self, inputs, labels, k: int, masks=None) -> torch.Tensor:
        """K updates on one batch: the same steps as K ``fit_batch`` calls,
        with the losses kept on the device — the caller's read of the
        returned [k] tensor is the one host sync."""
        self._check_trainable("fit_repeated")
        inputs, labels, masks = self._stage(inputs, labels, masks)
        losses = torch.stack([self._step_and_update(inputs, labels, masks)
                              for _ in range(int(k))])
        self._score = losses[-1]
        self.iteration_count += int(k)
        return losses

    def fit_scan(self, xs, ys, masks=None) -> torch.Tensor:
        """One update on each of K staged batches: xs/ys are [k, b, ...]
        arrays or lists of such (multi-input / multi-output), masks
        optional likewise. Returns the [k] losses on the device."""
        self._check_trainable("fit_scan")
        xs, ys, masks = self._stage(xs, ys, masks)
        k = xs[0].shape[0]
        losses = []
        for i in range(k):
            ms = (None if masks is None
                  else [None if m is None else m[i] for m in masks])
            losses.append(self._step_and_update([x[i] for x in xs],
                                                [y[i] for y in ys], ms))
        losses = torch.stack(losses)
        self._score = losses[-1]
        self.iteration_count += k
        return losses
