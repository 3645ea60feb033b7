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
and deltas; ``fit_repeated``/``fit_scan`` keep the last step's. Layers may
return an ``"aux_loss"`` in their state (``MoELayer``'s load balancing);
the loss adds it, and it is never persisted. Each vertex gets its own
example count (``_minibatch_map``: Stack and Unstack change it).

Truncated BPTT (``backprop_type="truncated_bptt"``) chunks ``fit_batch``
along time: one update and one listener firing per chunk, the recurrent
h/c carried across chunks with its gradient cut. Gradient checkpointing
(``gradient_checkpointing``) splits the topo order into about √V
segments, each run under ``torch.utils.checkpoint`` (non-reentrant):
only the segments' boundary activations and the loss heads' inputs stay
live for the backward. A segment restores the step generator's state
before it runs, so its recompute draws the dropout masks of its first
forward; the layer state persisted is the first forward's. Masked inputs
(with a warning) and the health-stats step run the full walk.

Streaming inference (``rnn_time_step``) carries each attention layer's
K/V cache between calls; the fed-step count that the reference keeps
in-band in the cache lives on the host here (``_rnn_steps_fed`` and each
cache's ``"pos"``).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as _dtypes
from .. import losses as _losses
from ..optimize import updaters as _updaters
from ..optimize.listeners import as_listener_score
from ..util import health as _health
from ..util import ingest as _ingest
from ..util import tracing as _tracing
from .conf.graph import ComputationGraphConfiguration, LayerVertex
from .conf.preprocessors import call_preprocessor
from ..util.netutil import (checkpoint_segment, named_generator,
                             note_streamed_steps, precheck_streamed_steps)

_CARRY_KEYS = ("h", "c", "pos")


def _aux_total(new_states) -> Any:
    """The sum of the ``"aux_loss"`` entries of the vertices' new states
    (0.0 when none has one)."""
    total = 0.0
    for st in new_states.values():
        if st and "aux_loss" in st:
            total = total + st["aux_loss"]
    return total


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
        # a util.tracing.Tracer: spans of fit's steps and their phases,
        # and of the stager's copies; None = no spans
        self.tracer: Optional[_tracing.Tracer] = None
        # training-health stats (util.health): None = off
        self.health_stats: Optional[_health.StatsConfig] = None
        self._last_health_stats: Optional[_health.DeviceStats] = None
        # per-batch-size example counts and the checkpointing plan, both
        # pure graph structure
        self._mb_maps: Dict[int, Dict[str, int]] = {}
        self._seg_plan = None
        # set by parallel.ParallelWrapper: the data-parallel step
        self._data_parallel = None

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

    def _draws(self) -> bool:
        """Whether a training forward draws random numbers: a layer with
        dropout, or a sampling preprocessor."""
        for name in self.topo_order:
            v = self.conf.vertices[name]
            layer = self._vertex_layer(name)
            if layer is not None and (layer.dropout or 0.0) > 0.0:
                return True
            proc = getattr(v, "preprocessor", None)
            if proc is not None and getattr(proc, "wants_rng", False):
                return True
        return False

    def _generator(self, name: str) -> Optional[torch.Generator]:
        """The generator of one step's draws (None when nothing draws)."""
        if not self._draws():
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
        # a ParameterDict's own table: its item access is a module
        # attribute lookup a parameter, which the training step pays
        mods = self.vertex_params._modules
        return {n: dict(mods[n]._parameters) if n in mods else {}
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

    def _states_map(self, rnn_state=None) -> Dict[str, Dict[str, Any]]:
        """Each vertex's state: its persistent entries, with the recurrent
        carry of ``rnn_state`` (TBPTT, streaming) laid over them."""
        out = {}
        for n in self.topo_order:
            st = dict(self.state.get(n) or {})
            if rnn_state is not None and rnn_state.get(n):
                st.update(rnn_state[n])
            out[n] = st
        return out

    def _minibatch_map(self, batch: int) -> Dict[str, int]:
        """The example count at every vertex for a network batch of
        ``batch`` (Stack and Unstack change it; time-flattened activations
        do not), cached per batch size."""
        mbs = self._mb_maps.get(batch)
        if mbs is None:
            mbs = {n: batch for n in self.conf.network_inputs}
            for name in self.topo_order:
                mbs[name] = self.conf.vertices[name].output_minibatch(
                    [mbs[i] for i in self.conf.vertex_inputs[name]])
            self._mb_maps[batch] = mbs
        return mbs

    def _apply_vertex(self, name, params_n, acts, state_n, generator, *,
                      train, minibatch, in_masks=None):
        """One vertex's forward on its inputs from ``acts`` — the single
        definition shared by the plain walk and the checkpointed
        segments."""
        v = self.conf.vertices[name]
        xs = [acts[i] for i in self.conf.vertex_inputs[name]]
        out, st = v.apply(params_n, xs, state=state_n, policy=self.policy,
                          masks=in_masks or [None] * len(xs), train=train,
                          generator=generator, minibatch=minibatch)
        return out, (st if st is not None else {})

    def _forward(self, inputs: List[torch.Tensor], masks=None, *,
                 params=None, train=False, generator=None,
                 states=None) -> Dict[str, torch.Tensor]:
        """Walk the topo order; returns {vertex: activation}. ``masks``:
        one per network input (or None), propagated along the DAG by each
        vertex's ``output_mask``. (``output`` passes none, as in the
        reference.) ``params`` replaces the net's parameters (NaN
        attribution replays a poisoned tree); ``states`` the vertices'
        states. ``train`` runs the train-mode forward (dropout from
        ``generator``, BN batch statistics) without touching the layer
        state."""
        params = self._require_params() if params is None else params
        states = self._states_map() if states is None else states
        mbs = self._minibatch_map(inputs[0].shape[0])
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        for name in self.topo_order:
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_masks = [mask_map.get(i) for i in in_names]
            acts[name], _ = self._apply_vertex(
                name, params[name], acts, states[name], generator,
                train=train, minibatch=mbs[in_names[0]], in_masks=in_masks)
            mask_map[name] = v.output_mask(
                in_masks, minibatch=acts[in_names[0]].shape[0])
        return acts

    def feed_forward(self, *inputs, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Every vertex's activation (and the network inputs), keyed by
        name, under ``torch.inference_mode()``."""
        inputs = [self._to_input(x) for x in _as_list(
            inputs[0] if len(inputs) == 1 and isinstance(inputs[0], (list, tuple))
            else list(inputs))]
        gen = (self._generator(f"output_{self.iteration_count}")
               if train else None)
        with torch.inference_mode():
            return self._forward(inputs, train=train, generator=gen)

    def clone_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """A detached copy of the parameters (training updates the live
        ones in place)."""
        return {k: {n: p.detach().clone() for n, p in ps.items()}
                for k, ps in self._require_params().items()}

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
        """Fresh recurrent carries (TBPTT, streaming): each layer with a
        ``_zero_state`` gets its zeros at its vertex's example count — the
        LSTMs' h/c, and the K/V cache of an attention layer built with
        ``max_cache_t`` (one without carries nothing)."""
        mbs = self._minibatch_map(batch)
        carry = {}
        for name in self.topo_order:
            layer = self._vertex_layer(name)
            if (layer is not None and hasattr(layer, "_zero_state")
                    and getattr(layer, "max_cache_t", True) is not None):
                mb = mbs[self.conf.vertex_inputs[name][0]]
                carry[name] = layer._zero_state(mb, self.policy, self.device)
        return carry

    @staticmethod
    def _extract_rnn_carry(new_states) -> Dict[str, Dict[str, Any]]:
        return {name: {k: v for k, v in st.items() if k in _CARRY_KEYS}
                for name, st in new_states.items()
                if st and any(k in st for k in _CARRY_KEYS)}

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
        mbs = self._minibatch_map(inputs[0].shape[0])
        states = self._states_map(self._rnn_state)
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        with torch.inference_mode():
            for name in self.topo_order:
                out, st = self._apply_vertex(
                    name, params[name], acts, states[name], None,
                    train=False,
                    minibatch=mbs[self.conf.vertex_inputs[name][0]])
                if name in self._rnn_state:
                    self._rnn_state[name] = {k: v for k, v in st.items()
                                             if k in _CARRY_KEYS}
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
                 generator=None, new_states: Optional[Dict] = None,
                 states=None):
        """The training loss: every vertex but the output layers runs
        forward (with ``train=True`` and the step's ``generator``); each
        output layer is scored from its hidden input (``_output_score``);
        the l1/l2 penalty and the layers' ``"aux_loss"`` entries are added.
        With ``gradient_checkpointing`` (no masks, no stats) the walk runs
        segmented (``_loss_fn_segmented``). With ``collect_stats`` it
        returns ``(loss, {vertex: act_moments})``, each vertex's activation
        summarised (detached) as it is produced. ``params`` replaces the
        net's parameters and ``states`` the vertices' states (the TBPTT
        carry rides in them); ``new_states``, a dict, receives each
        vertex's new state (the caller persists it)."""
        if not self._output_layer_names:
            raise ValueError(
                "no output vertex has a loss (need an output layer at a "
                "network output to train)")
        params = self._require_params() if params is None else params
        states = self._states_map() if states is None else states
        if self.conf.training.gradient_checkpointing and collect_stats is None:
            if masks is None or all(m is None for m in masks):
                return self._loss_fn_segmented(
                    inputs, labels, params=params, states=states,
                    generator=generator, new_states=new_states)
            warnings.warn(
                "gradient_checkpointing is ignored for masked "
                "ComputationGraph inputs — the full-activation path runs",
                stacklevel=2)
        new_states = {} if new_states is None else new_states
        out_set = set(self._output_layer_names)
        act_stats: Dict[str, tuple] = {}
        # output layers that also feed other vertices still run forward
        consumed = {i for ins in self.conf.vertex_inputs.values() for i in ins}
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        mask_map = dict(zip(self.conf.network_inputs,
                            masks if masks is not None else [None] * len(inputs)))
        label_map = dict(zip(self.conf.network_outputs, labels))
        mbs = self._minibatch_map(inputs[0].shape[0])
        total = 0.0
        for name in self.topo_order:
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_masks = [mask_map.get(i) for i in in_names]
            mb = mbs[in_names[0]]
            if name in out_set:
                total = total + self._output_score(
                    params, name, acts[in_names[0]], label_map[name],
                    in_masks[0] if in_masks else None, generator,
                    minibatch=mb)
            if name not in out_set or name in consumed:
                out, st = self._apply_vertex(
                    name, params[name], acts, states[name], generator,
                    train=True, minibatch=mb, in_masks=in_masks)
                new_states[name] = st
                acts[name] = out
                mask_map[name] = v.output_mask(
                    in_masks, minibatch=acts[in_names[0]].shape[0])
                if collect_stats is not None:
                    act_stats[name] = _health.act_moments(
                        out, collect_stats.act_sample)
        total = total + self._reg_penalty(params) + _aux_total(new_states)
        if collect_stats is not None:
            return total.to(self._loss_dtype()), act_stats
        return total.to(self._loss_dtype())

    def _segment_plan(self):
        """The topo order in about √V segments, and for each the
        activations it reads from outside and the ones it must publish
        (read by a later segment, a network output, or a loss head's
        input). Output layers nothing consumes are left out (only their
        score runs). Cached: it is pure graph structure."""
        if self._seg_plan is not None:
            return self._seg_plan
        order = self.topo_order
        n_seg = max(1, int(np.ceil(np.sqrt(len(order)))))
        bounds = np.array_split(np.arange(len(order)), n_seg)
        pos = {name: i for i, name in enumerate(order)}
        consumed = {i for ins in self.conf.vertex_inputs.values() for i in ins}
        skip = {n for n in self._output_layer_names if n not in consumed}
        required = set(self.conf.network_outputs) - skip
        for name in self._output_layer_names:
            required.update(self.conf.vertex_inputs[name])
        segments = []
        for idx in bounds:
            seg = [order[i] for i in idx if order[i] not in skip]
            if not seg:
                continue
            seg_set = set(seg)
            ext_in, seen = [], set()
            for vname in seg:
                for src in self.conf.vertex_inputs[vname]:
                    if src not in seg_set and src not in seen:
                        seen.add(src)
                        ext_in.append(src)
            last = pos[seg[-1]]
            outs = [vname for vname in seg
                    if vname in required
                    or any(pos[w] > last for w in order
                           if vname in self.conf.vertex_inputs[w])]
            segments.append((seg, ext_in, outs))
        self._seg_plan = (segments, skip)
        return self._seg_plan

    def _forward_segmented(self, inputs, *, params, states, generator=None):
        """The training forward with segment-level recomputation: each
        segment runs under ``checkpoint_segment``, so only its published
        activations stay live for the backward; its interior, dropout masks
        included, is recomputed there. Returns ({vertex: activation}, new
        states) — the states of the first forward."""
        mbs = self._minibatch_map(inputs[0].shape[0])
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        segments, skip = self._segment_plan()
        new_states: Dict[str, Dict[str, Any]] = {n: {} for n in skip}
        for seg, ext_in, outs_needed in segments:
            def seg_fn(*ext_acts, _seg=tuple(seg), _ext=tuple(ext_in),
                       _outs=tuple(outs_needed)):
                local = dict(zip(_ext, ext_acts))
                st_out = {}
                for vname in _seg:
                    local[vname], st_out[vname] = self._apply_vertex(
                        vname, params[vname], local, states[vname],
                        generator, train=True,
                        minibatch=mbs[self.conf.vertex_inputs[vname][0]])
                return [local[o] for o in _outs], st_out

            outs, seg_new = checkpoint_segment(seg_fn, generator,
                                               *[acts[n] for n in ext_in])
            acts.update(zip(outs_needed, outs))
            new_states.update(seg_new)
        return acts, new_states

    def _loss_fn_segmented(self, inputs, labels, *, params, states,
                           generator=None, new_states=None):
        """The gradient-checkpointed loss: ``_forward_segmented``, then the
        loss heads score the published hidden activations as in the full
        walk."""
        acts, seg_states = self._forward_segmented(
            inputs, params=params, states=states, generator=generator)
        if new_states is not None:
            new_states.update(seg_states)
        label_map = dict(zip(self.conf.network_outputs, labels))
        mbs = self._minibatch_map(inputs[0].shape[0])
        total = 0.0
        for name in self._output_layer_names:
            src = self.conf.vertex_inputs[name][0]
            total = total + self._output_score(
                params, name, acts[src], label_map[name], None, generator,
                minibatch=mbs[src])
        total = total + self._reg_penalty(params) + _aux_total(seg_states)
        return total.to(self._loss_dtype())

    def _loss_dtype(self):
        return (torch.float64 if self.policy.param_dtype == torch.float64
                else torch.float32)

    def _output_score(self, params, name, hidden, y, mask, generator=None,
                      minibatch=None):
        """One output vertex's loss contribution from its hidden input:
        the vertex's preprocessor, the fused score array over the masked
        denominator."""
        v = self.conf.vertices[name]
        out_mask = mask
        if v.preprocessor is not None:
            mb = minibatch if minibatch is not None else hidden.shape[0]
            hidden = call_preprocessor(v.preprocessor, hidden,
                                       minibatch_size=mb, generator=generator)
            out_mask = v.preprocessor.transform_mask(out_mask,
                                                     minibatch_size=mb)
        score_arr = v.layer.compute_score_array(params[name], hidden, y,
                                                mask=out_mask,
                                                policy=self.policy)
        denom = _losses.masked_denominator(
            out_mask, y, score_arr.shape[0],
            sparse=_losses.is_sparse(v.layer.loss))
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
        # one share of the summed loss carries the penalty when the batch
        # is split over ranks
        from ..parallel.collectives import count_once
        return count_once(total)

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

    def _tbptt_T(self, inputs) -> Optional[int]:
        """The sequence length truncated BPTT chunks, over every 3-D input
        (a static [b, f] input may ride beside a series); None when TBPTT
        is off or nothing is temporal. Differing lengths are ambiguous and
        raise."""
        if self.conf.backprop_type != "truncated_bptt":
            return None
        ts = {int(x.shape[1]) for x in inputs if x.ndim == 3}
        if not ts:
            return None
        if len(ts) > 1:
            raise ValueError(
                f"truncated_bptt with differing sequence lengths {sorted(ts)} "
                "across inputs is ambiguous — align or pad them")
        return ts.pop()

    def _reject_tbptt(self, inputs, api: str) -> None:
        """``fit_repeated`` and ``fit_scan`` take one full-sequence update
        per batch; under a truncated_bptt configuration that would change
        the memory and the optimisation, so they refuse."""
        T = self._tbptt_T(inputs)
        if T is not None and T > self.conf.tbptt_fwd_length:
            raise ValueError(
                f"{api} does not chunk truncated BPTT (T={T} > "
                f"tbptt_fwd_length={self.conf.tbptt_fwd_length}); use "
                "fit()/fit_batch(), or pre-chunk the sequences")

    def _loss_and_grads(self, inputs, labels, masks, collect_stats=None,
                        generator=None, new_states=None, states=None):
        """(loss, {vertex: {param: grad}}) — ``jax.value_and_grad`` of the
        reference's ``_loss_fn``, by torch autograd; with
        ``collect_stats``, (loss, grads, activation stats). ``new_states``
        receives the vertices' new states; ``states`` replaces the
        vertices' states."""
        params = self._require_params()
        named = [(v, k, p) for v, ps in params.items() for k, p in ps.items()]
        out = self._loss_fn(inputs, labels, masks,
                            collect_stats=collect_stats, generator=generator,
                            new_states=new_states, states=states)
        loss, act_stats = out if collect_stats is not None else (out, None)
        gs = torch.autograd.grad(loss, [p for _, _, p in named],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {v: {} for v in params}
        for (v, k, p), g in zip(named, gs):
            grads[v][k] = torch.zeros_like(p) if g is None else g
        if collect_stats is None:
            return loss.detach(), grads
        return loss.detach(), grads, act_stats

    def _step_and_update(self, inputs, labels, masks, stats=None,
                         rnn_state=None):
        """One update: loss and gradients, gradient normalization, the
        updater's deltas subtracted from the parameters in place. Returns
        the loss on the device; with ``stats`` (a ``StatsConfig``),
        ``(loss, health stats tree)`` — reduced after the update from the
        raw gradients, the deltas and the updated parameters, so the
        update itself is the same computation either way. ``rnn_state``
        is the TBPTT carry the step starts from; the carry it ends with is
        left, detached, in ``_last_rnn_carry``."""
        if self._updater is None:
            self.init_updater()
        t = self.conf.training
        dp = self._data_parallel
        if dp is not None:
            if rnn_state is not None:
                raise ValueError("truncated BPTT does not run under "
                                 "ParallelWrapper")
            inputs, labels, masks = dp.shard(inputs, labels, masks)
        gen = self._generator(f"update_{self._update_count}")
        new_states: Dict[str, Any] = {}
        states = self._states_map(rnn_state)
        with _tracing.phase("fit.forward_backward", self.tracer), (
                dp.loss_context() if dp is not None
                else contextlib.nullcontext()):
            if stats is None:
                loss, grads_raw = self._loss_and_grads(
                    inputs, labels, masks, generator=gen,
                    new_states=new_states, states=states)
                act_stats = None
            else:
                loss, grads_raw, act_stats = self._loss_and_grads(
                    inputs, labels, masks, collect_stats=stats,
                    generator=gen, new_states=new_states, states=states)
        if dp is not None:
            loss, grads_raw, ok = dp.reduce(loss, grads_raw,
                                            (inputs, labels, masks))
            if not ok:
                # a skipped step: nothing moves but the update count
                self._update_count += 1
                self._last_rnn_carry = {}
                return loss if stats is None else (loss, None)
        with _ingest.fit_phase("updater", self.tracer, "ComputationGraph"):
            grads = _updaters.normalize_gradients(
                grads_raw, t.gradient_normalization,
                float(t.gradient_normalization_threshold))
            params = self.params
            deltas, self.updater_state = _updaters.update_in_place(
                self._updater, params, grads, self.updater_state,
                self._update_count, want_deltas=stats is not None,
                model="ComputationGraph")
        self._update_count += 1
        # the TBPTT boundary: the carry's values pass on, its graph does not
        self._last_rnn_carry = {
            n: {k: v.detach() if torch.is_tensor(v) else v
                for k, v in st.items()}
            for n, st in self._extract_rnn_carry(new_states).items()}
        self._persist_states(new_states)
        if stats is None:
            return loss
        with torch.no_grad():
            tree = _health.model_stats(params, grads_raw, deltas, act_stats,
                                       stats, loss=loss)
        return loss, tree

    def _steps(self, batches, rnn_state=None, every_stats=False
               ) -> torch.Tensor:
        """One update per (inputs, labels, masks) of ``batches``; the last
        one (each one with ``every_stats``) reduces the health stats when
        they are on. ``rnn_state`` starts a TBPTT carry that each update
        hands to the next. Returns the [k] losses on the device."""
        cfg = self.health_stats
        losses = []
        for i, (x, y, m) in enumerate(batches):
            stats = cfg is not None and (every_stats
                                         or i == len(batches) - 1)
            out = self._step_and_update(x, y, m, stats=cfg if stats else None,
                                        rnn_state=rnn_state)
            if rnn_state is not None:
                rnn_state = self._last_rnn_carry
            if stats:
                out, tree = out
            if stats and tree is not None:      # None: a skipped step
                self._last_health_stats = _health.DeviceStats(
                    tree, iteration=self.iteration_count
                    + (i + 1 if every_stats else len(batches)),
                    model="ComputationGraph")
            losses.append(out)
        losses = torch.stack(losses)
        self._score = losses[-1]
        return losses

    def fit_batch(self, inputs, labels, masks=None) -> torch.Tensor:
        """One update (TBPTT-aware: one per chunk). inputs/labels: an
        array or a list of arrays (multi-input / multi-output); masks:
        optional list of feature masks. Returns the loss as a 0-dim tensor
        on the device (the last chunk's under TBPTT)."""
        inputs, labels, masks = self._stage(inputs, labels, masks)
        T = self._tbptt_T(inputs)
        if T is not None and T > self.conf.tbptt_fwd_length:
            return self._fit_tbptt(inputs, labels, masks, T)
        loss = self._steps([(inputs, labels, masks)])[0]
        self._fire_iteration(inputs[0].shape[0], loss)
        return loss

    def _fit_tbptt(self, inputs, labels, masks, T: int) -> torch.Tensor:
        """Truncated BPTT over the DAG: every [b, T, ...] input, label and
        mask cut into forward-length chunks; one update and one listener
        firing per chunk, every recurrent vertex's h/c carried across
        chunks with its gradient cut."""
        length = self.conf.tbptt_fwd_length
        batch = inputs[0].shape[0]

        def cut(a, start, end, min_ndim=3):
            # time-major arrays: [b, T, f] features and one-hot labels,
            # [b, T] masks and integer labels
            return (a[:, start:end] if a is not None and a.ndim >= min_ndim
                    and a.shape[1] == T else a)

        chunks = [([cut(x, s, e) for x in inputs],
                   [cut(y, s, e, 3 if y.is_floating_point() else 2)
                    for y in labels],
                   None if masks is None else [cut(m, s, e, 2) for m in masks])
                  for s, e in ((s, min(s + length, T))
                               for s in range(0, T, length))]
        losses = self._steps(chunks, rnn_state=self._zero_rnn_carry(batch),
                             every_stats=True)
        for loss in losses:
            self._fire_iteration(batch, loss)
        return losses[-1]

    def fit_repeated(self, inputs, labels, k: int, masks=None) -> torch.Tensor:
        """K updates on one batch: the same steps as K ``fit_batch`` calls,
        with the losses kept on the device — the caller's read of the
        returned [k] tensor is the one host sync (listeners, when set,
        read them once for their replay)."""
        inputs, labels, masks = self._stage(inputs, labels, masks)
        self._reject_tbptt(inputs, "fit_repeated")
        losses = self._steps([(inputs, labels, masks)] * int(k))
        self._fire_replay(inputs[0].shape[0], losses)
        return losses

    def fit_scan(self, xs, ys, masks=None) -> torch.Tensor:
        """One update on each of K staged batches: xs/ys are [k, b, ...]
        arrays or lists of such (multi-input / multi-output), masks
        optional likewise. Returns the [k] losses on the device."""
        xs, ys, masks = self._stage(xs, ys, masks)
        self._reject_tbptt([x[0] for x in xs], "fit_scan")
        batches = [([x[i] for x in xs], [y[i] for y in ys],
                    None if masks is None
                    else [None if m is None else m[i] for m in masks])
                   for i in range(xs[0].shape[0])]
        losses = self._steps(batches)
        self._fire_replay(xs[0].shape[1], losses)
        return losses

    def fit(self, data, labels=None, *, epochs: int = 1,
            coalesce: Optional[int] = None, session=None) -> None:
        """Train for ``epochs`` over (inputs, labels) arrays (or lists of
        them), a DataSet/MultiDataSet, or an iterable of either — the
        asynchronous loop ``MultiLayerNetwork.fit`` runs
        (``util.ingest.run_fit_loop``): background staging of iterator
        sources onto the card, a bounded in-flight window, ``LazyScore``
        listener delivery, lazy epoch-start resets, optional same-shape
        coalescing (``coalesce=K`` / ``DL4JTPU_COALESCE_K``) and an
        optional ``util.durable.DurableSession``."""
        from ..util.ingest import run_fit_loop
        if self.params is None:
            self.init()
        run_fit_loop(self, data, labels, None, epochs, coalesce,
                     model_label="ComputationGraph", session=session)

    @staticmethod
    def _as_batches(data, labels=None, mask=None):
        from ..util.batching import iter_batches
        return iter_batches(data, labels, mask)

    # ------------------------------------------------------------------
    # layerwise pretraining
    # ------------------------------------------------------------------

    def pretrain(self, data, labels=None, *, epochs: int = 1,
                 learning_rate: Optional[float] = None) -> None:
        """Greedy layerwise pretraining of the AutoEncoder and RBM layer
        vertices, in topological order: each trains on its frozen
        upstream activations (``make_pretrain_step``), then the walk moves
        deeper. Nothing else moves."""
        from .conf.pretrain import make_pretrain_step
        from ..util.batching import iter_batches
        if self.params is None:
            self.init()
        lr = float(learning_rate if learning_rate is not None
                   else self.conf.training.learning_rate)
        pre = [n for n in self.topo_order
               if self._vertex_layer(n) is not None
               and (hasattr(self._vertex_layer(n), "pretrain_loss")
                    or hasattr(self._vertex_layer(n),
                               "contrastive_divergence_grads"))]
        if not pre:
            return
        batches = [[self._to_input(x) for x in _as_list(ins)]
                   for ins, _, _ in iter_batches(data, labels, None)]
        params = self._require_params()
        for name in pre:
            step = make_pretrain_step(self._vertex_layer(name), lr,
                                      self.policy)
            # the upstream is frozen while this vertex trains, so its
            # inputs are the same every epoch: held across epochs when
            # there are few batches
            cache = [None] * len(batches) if (
                epochs > 1 and len(batches) <= 64) else None
            for e in range(int(epochs)):
                for bi, ins in enumerate(batches):
                    hidden = None if cache is None else cache[bi]
                    if hidden is None:
                        hidden = self._vertex_input_activation(name, ins)
                        if cache is not None:
                            cache[bi] = hidden
                    gen = named_generator(self.device,
                                          self.conf.training.seed,
                                          f"pre_{name}_{e}_{bi}")
                    step(params[name], hidden, gen)

    def _vertex_input_activation(self, name: str,
                                 inputs: List[torch.Tensor]) -> torch.Tensor:
        """The (preprocessed) input activation a layer vertex sees, every
        upstream vertex in eval mode."""
        with torch.no_grad():
            acts = self._forward(inputs)
        src = self.conf.vertex_inputs[name][0]
        x = acts[src]
        v = self.conf.vertices[name]
        if v.preprocessor is not None:
            mbs = self._minibatch_map(inputs[0].shape[0])
            x = v.preprocessor(x, minibatch_size=mbs[src])
        return x
