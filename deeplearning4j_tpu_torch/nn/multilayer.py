"""MultiLayerNetwork: the sequential-stack runtime (counterpart of the JAX
package's ``nn/multilayer.py``).

An ``nn.Module`` holding one ``ParameterDict`` per layer, keyed
``layer_{i}`` as in the reference's parameter tree and checkpoints. The
forward threads the input through each layer's preprocessor and forward
function, eagerly; the reference's ``jax.jit`` has no counterpart here.
Non-parameter state (BatchNormalization's running statistics) lives in
``net.state`` and is persisted after every training step; the recurrent
carry (LSTM ``h``/``c``, an attention layer's K/V cache) rides in the same
per-layer state dicts for TBPTT and ``rnn_time_step``.

Training is the reference's train step: the loss (every layer but the
output one forward with ``train=True``, the output layer scored from its
hidden input, the l1/l2 penalty), torch autograd in place of
``jax.grad``, gradient normalization, the updater's deltas, and the
parameters updated in place. ``fit_batch`` takes one step (TBPTT chunks
when the configuration asks for it and the sequence is longer than the
forward length: one update per chunk, the carry passed on with its
gradient cut), ``fit_repeated`` K steps on one batch, ``fit_scan`` one
step on each of K staged batches, and ``fit`` iterates arrays, a
DataSet-like object or a plain iterable of batches. Losses stay on the
device; listeners get a ``LazyScore``. Dropout (and a sampling
preprocessor) draws from a ``torch.Generator`` on the net's device, seeded
from the configuration's seed and the update count. A layer's
``"aux_loss"`` state entry (``MoELayer``) is added to the loss.

With ``gradient_checkpointing`` the training forward runs in about √N
segments of consecutive layers, each under ``torch.utils.checkpoint``
(non-reentrant), masks threaded through; a segment restores the step
generator's state on entry so its recompute draws the same masks.
``pretrain`` trains the AutoEncoder and RBM layers greedily, each on the
frozen activations below it.
"""

from __future__ import annotations

import contextlib
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
from ..util.netutil import (checkpoint_segment, named_generator,
                             note_streamed_steps, precheck_streamed_steps)
from .conf.multi_layer import MultiLayerConfiguration
from .conf.preprocessors import call_preprocessor

_CARRY_KEYS = ("h", "c", "pos")


def _layer_key(i: int) -> str:
    return f"layer_{i}"


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach_tree(v) for v in tree]
    return tree.detach() if torch.is_tensor(tree) else tree


class MultiLayerNetwork(torch.nn.Module):
    """Runtime network over a :class:`MultiLayerConfiguration`.

    ``device`` defaults to ``"cuda"``; without a card that raises rather
    than running on the CPU unasked — pass ``device="cpu"`` for the CPU.
    Parameters come from :meth:`init` (random, from the configured seed)
    or a checkpoint (``util.serialization.load_model`` /
    ``params_from_numpy``)."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        super().__init__()
        self.conf = conf
        self.layers = conf.layers
        self.training = conf.training
        self.device = _dtypes.resolve_device(device)
        self.policy = _dtypes.policy_from_name(conf.training.dtype)
        self.keys = [_layer_key(i) for i in range(len(self.layers))]
        self.layer_params = torch.nn.ModuleDict()
        self._has_params = False
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            k: layer.init_state(self.policy, self.device)
            for k, layer in zip(self.keys, self.layers)}
        # set by parallel.ParallelWrapper: the data-parallel step
        self._data_parallel = None
        self._persistent_keys = [tuple(self.state[k]) for k in self.keys]
        self.updater_state: Optional[Dict[str, Any]] = None
        self._updater: Optional[_updaters.Updater] = None
        self.listeners: List[Any] = []
        # a util.tracing.Tracer: spans of fit's steps and their phases,
        # and of the stager's copies; None = no spans
        self.tracer: Optional[_tracing.Tracer] = None
        self.iteration_count = 0   # minibatches seen (listener-visible)
        self._update_count = 0     # parameter updates (TBPTT chunks too)
        self.epoch_count = 0
        self._score: Optional[torch.Tensor] = None
        self._rnn_state: Optional[List[Dict[str, Any]]] = None
        self._rnn_steps_fed = 0
        self._last_rnn_carry = None
        self.health_stats: Optional[_health.StatsConfig] = None
        self._last_health_stats: Optional[_health.DeviceStats] = None
        self._has_loss_output = hasattr(self.layers[-1], "compute_score_array")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    @property
    def topo_order(self) -> List[str]:
        """The layer keys in forward order (the graph runtime's name for
        it, which the health attribution reads)."""
        return self.keys

    @property
    def params(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """{layer_i: {param name: tensor}} (None before init/load)."""
        if not self._has_params:
            return None
        return {k: (dict(self.layer_params[k]) if k in self.layer_params
                    else {}) for k in self.keys}

    def set_params(self, tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Install parameters, checked name by name and shape by shape
        against the configuration."""
        new = torch.nn.ModuleDict()
        for key, layer in zip(self.keys, self.layers):
            want = layer.param_shapes(self.policy)
            got = tree.get(key, {})
            if set(got) != set(want):
                raise ValueError(
                    f"{key}: parameters {sorted(got)} do not match the "
                    f"configuration's {sorted(want)}")
            pd = torch.nn.ParameterDict()
            for name, shape in want.items():
                t = torch.as_tensor(got[name])
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"{key} param {name!r}: shape "
                                     f"{tuple(t.shape)}, expected {shape}")
                pd[name] = torch.nn.Parameter(t.to(self.device))
            if want:
                new[key] = pd
        extra = set(tree) - set(self.keys)
        if any(tree[k] for k in extra):
            raise ValueError(f"parameters for unknown layers {sorted(extra)}")
        self.layer_params = new
        self._has_params = True

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Random parameters from ``torch.Generator``s seeded per layer
        from the configured seed (the reference's schemes and
        distributions, not its numbers), fresh layer state and a zero
        optimizer state."""
        seed = self.training.seed if seed is None else seed
        tree = {key: layer.init_params(named_generator("cpu", seed, key),
                                       self.policy, self.device)
                for key, layer in zip(self.keys, self.layers)}
        self.set_params(tree)
        self.state = {k: layer.init_state(self.policy, self.device)
                      for k, layer in zip(self.keys, self.layers)}
        self.init_updater()
        return self

    def init_updater(self) -> None:
        """The updater from the training configuration and a fresh (zero)
        optimizer state for the current parameters."""
        self._updater = _updaters.make_updater(self.training,
                                               self._lr_multipliers())
        self.updater_state = self._updater.init(self.params)

    def _lr_multipliers(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter multipliers of the global learning rate: a
        layer's ``learning_rate`` for its weights, ``bias_learning_rate``
        (else the layer's rate) for ``b``."""
        base = float(self.training.learning_rate)
        mults = {}
        for i, (key, layer) in enumerate(zip(self.keys, self.layers)):
            shapes = layer.param_shapes(self.policy)
            layer_lr = (layer.learning_rate
                        if layer.learning_rate is not None else base)
            bias_lr = (layer.bias_learning_rate
                       if layer.bias_learning_rate is not None else layer_lr)
            if base == 0.0:
                if layer_lr != 0.0 or bias_lr != 0.0:
                    raise ValueError(
                        f"layer {i} sets learning_rate={layer_lr}/"
                        f"bias_learning_rate={bias_lr} but the global "
                        "learning_rate is 0.0")
                mults[key] = {k: 1.0 for k in shapes}
            else:
                mults[key] = {k: (bias_lr / base if k == "b"
                                  else layer_lr / base) for k in shapes}
        return mults

    def num_params(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")
        return sum(p.numel() for p in self.parameters())

    def clone_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """A detached copy of the parameters (training updates the live
        ones in place)."""
        return {k: {n: p.detach().clone() for n, p in ps.items()}
                for k, ps in self._require_params().items()}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _to_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _require_params(self):
        params = self.params
        if params is None:
            raise ValueError("call init() or load parameters first")
        return params

    def _states_list(self, rnn_state=None) -> List[Dict[str, Any]]:
        out = []
        for i, key in enumerate(self.keys):
            st = dict(self.state.get(key, {}))
            if rnn_state is not None and rnn_state[i]:
                st.update(rnn_state[i])
            out.append(st)
        return out

    def _persist_states(self, new_states) -> None:
        """Keep the persistent (``init_state``-declared) entries, e.g. BN
        running statistics."""
        for key, keys, st in zip(self.keys, self._persistent_keys,
                                 new_states):
            if keys:
                self.state[key] = {k: st[k].detach() for k in keys if k in st}

    def _apply_layer(self, i, p_i, cur, cur_mask, state_i, generator, *,
                     train, minibatch):
        """Preprocessor + layer forward at position ``i``."""
        proc = self.conf.input_preprocessors.get(i)
        if proc is not None:
            cur = call_preprocessor(proc, cur, minibatch_size=minibatch,
                                    generator=generator)
            cur_mask = proc.transform_mask(cur_mask, minibatch_size=minibatch)
        cur, st = self.layers[i].apply(p_i, cur, state=state_i, train=train,
                                       generator=generator, mask=cur_mask,
                                       policy=self.policy)
        return cur, cur_mask, (st if st is not None else {})

    def _forward(self, x, *, train=False, generator=None, mask=None,
                 upto: Optional[int] = None, collect=False, params=None,
                 states=None):
        """Thread ``x`` through preprocessors and layers ``[0, upto)``.
        Returns ``(final activation | [input, act_0, ...], new_states)``.
        ``params`` replaces the net's parameters (NaN attribution replays
        a poisoned tree)."""
        params = self._require_params() if params is None else params
        states = self._states_list() if states is None else states
        upto = len(self.layers) if upto is None else upto
        if (self.training.gradient_checkpointing and train and not collect
                and torch.is_grad_enabled()):
            return self._forward_segmented(x, params=params, states=states,
                                           generator=generator, mask=mask,
                                           upto=upto)
        minibatch = x.shape[0]
        cur, cur_mask = x, mask
        acts = [x] if collect else None
        new_states = []
        for i, key in enumerate(self.keys):
            if i >= upto:
                new_states.append(states[i])
                continue
            cur, cur_mask, st = self._apply_layer(
                i, params[key], cur, cur_mask, states[i], generator,
                train=train, minibatch=minibatch)
            new_states.append(st)
            if collect:
                acts.append(cur)
        return (acts if collect else cur), new_states

    def _forward_segmented(self, x, *, params, states, generator, mask,
                           upto):
        """The training forward with segment-level recomputation: layers
        ``[0, upto)`` in about √N runs, each under ``checkpoint_segment``
        so only the runs' boundary activations stay live for the backward
        (the recompute redraws the same masks); the states returned are the
        first forward's."""
        minibatch = x.shape[0]
        cur, cur_mask = x, mask
        new_states: List[Dict[str, Any]] = []
        for idx in np.array_split(np.arange(upto),
                                  max(1, int(np.ceil(np.sqrt(max(upto, 1)))))):
            def seg_fn(cur, cur_mask, _seg=tuple(int(i) for i in idx)):
                st_out = []
                for i in _seg:
                    cur, cur_mask, st = self._apply_layer(
                        i, params[self.keys[i]], cur, cur_mask, states[i],
                        generator, train=True, minibatch=minibatch)
                    st_out.append(st)
                return cur, cur_mask, st_out

            cur, cur_mask, st_out = checkpoint_segment(seg_fn, generator,
                                                       cur, cur_mask)
            new_states.extend(st_out)
        new_states.extend(states[upto:])     # layers past upto: untouched
        return cur, new_states

    def _generator(self, name: str) -> Optional[torch.Generator]:
        """The generator of one step's draws (None when no layer drops and
        no preprocessor samples)."""
        if not (any((layer.dropout or 0.0) > 0.0 for layer in self.layers)
                or any(getattr(p, "wants_rng", False)
                       for p in self.conf.input_preprocessors.values())):
            return None
        return named_generator(self.device, self.training.seed, name)

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Final-layer activations under ``torch.inference_mode()``.
        ``train=True`` runs the train-mode forward (dropout active, BN
        batch statistics) without updating parameters or state."""
        x = self._to_input(x)
        gen = (self._generator(f"output_{self.iteration_count}")
               if train else None)
        with torch.inference_mode():
            out, _ = self._forward(x, train=train, generator=gen)
        return out

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """All layer activations, the input first."""
        x = self._to_input(x)
        with torch.inference_mode():
            acts, _ = self._forward(x, train=train, collect=True)
        return acts

    def _zero_rnn_carry(self, batch: int) -> List[Dict[str, Any]]:
        carry = []
        for layer in self.layers:
            # max_cache_t None = a streaming-capable layer (attention)
            # whose cache is disabled: it carries nothing
            if (hasattr(layer, "_zero_state")
                    and getattr(layer, "max_cache_t", True) is not None):
                carry.append(layer._zero_state(batch, self.policy,
                                               self.device))
            else:
                carry.append({})
        return carry

    @staticmethod
    def _extract_rnn_carry(new_states) -> List[Dict[str, Any]]:
        return [{k: v for k, v in st.items() if k in _CARRY_KEYS}
                for st in new_states]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None
        self._rnn_steps_fed = 0

    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference: feed one (or a few) timesteps, carrying the
        LSTM ``h``/``c`` and attention K/V caches between calls. ``x``:
        ``[b, f]`` (one step; the output is squeezed back) or
        ``[b, t, f]``."""
        x = self._to_input(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_state is None:
            self._rnn_state = self._zero_rnn_carry(x.shape[0])
            self._rnn_steps_fed = 0
        # strict-mode caches refuse the overflowing chunk before any work
        precheck_streamed_steps(self, x.shape[1])
        with torch.inference_mode():
            out, new_states = self._forward(
                x, states=self._states_list(self._rnn_state))
        self._rnn_state = self._extract_rnn_carry(new_states)
        note_streamed_steps(self, x.shape[1])
        return out[:, 0, :] if (squeeze and out.ndim == 3) else out

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def _loss_dtype(self):
        return (torch.float64 if self.policy.param_dtype == torch.float64
                else torch.float32)

    def _reg_penalty(self, params):
        """l1·Σ|w| + ½·l2·Σw² over each layer's ``regularized_params``,
        when the configuration turns regularization on."""
        if not self.training.regularization:
            return 0.0
        total = 0.0
        for key, layer in zip(self.keys, self.layers):
            l1, l2 = float(layer.l1 or 0.0), float(layer.l2 or 0.0)
            if l1 == 0.0 and l2 == 0.0:
                continue
            for name in layer.regularized_params():
                if name not in params[key]:
                    continue
                w = params[key][name].to(self._loss_dtype())
                if l1:
                    total = total + l1 * torch.sum(torch.abs(w))
                if l2:
                    total = total + 0.5 * l2 * torch.sum(torch.square(w))
        # one share of the summed loss carries the penalty when the batch
        # is split over ranks
        from ..parallel.collectives import count_once
        return count_once(total)

    def _loss_fn(self, x, y, mask=None, *, params=None, states=None,
                 generator=None, collect_stats=None):
        """``(loss, new_states)``: every layer but the output one forward
        with ``train=True``, the output layer scored from its hidden input
        over the masked denominator, plus the l1/l2 penalty. With
        ``collect_stats`` (a ``StatsConfig``) it returns ``(loss,
        new_states, {layer: act_moments})``."""
        if not self._has_loss_output:
            raise ValueError(
                "final layer has no loss (need OutputLayer/RnnOutputLayer/"
                "LossLayer to train with fit())")
        params = self._require_params() if params is None else params
        n_hidden = len(self.layers) - 1
        fwd, new_states = self._forward(
            x, train=True, generator=generator, mask=mask, upto=n_hidden,
            collect=collect_stats is not None, params=params, states=states)
        if collect_stats is not None:
            hidden = fwd[-1]
            act_stats = {self.keys[i]: _health.act_moments(
                fwd[i + 1], collect_stats.act_sample)
                for i in range(n_hidden)}
        else:
            hidden = fwd
        out_layer = self.layers[-1]
        proc = self.conf.input_preprocessors.get(n_hidden)
        out_mask = mask
        if proc is not None:
            hidden = call_preprocessor(proc, hidden, minibatch_size=x.shape[0],
                                       generator=generator)
            out_mask = proc.transform_mask(out_mask, minibatch_size=x.shape[0])
        score_arr = out_layer.compute_score_array(
            params[self.keys[-1]], hidden, y, mask=out_mask,
            policy=self.policy)
        denom = _losses.masked_denominator(
            out_mask, y, score_arr.shape[0],
            sparse=_losses.is_sparse(out_layer.loss))
        loss = torch.sum(score_arr) / denom + self._reg_penalty(params)
        # auxiliary objectives a layer returns in its state (MoELayer)
        for st in new_states:
            if "aux_loss" in st:
                loss = loss + st["aux_loss"]
        loss = loss.to(self._loss_dtype())
        if collect_stats is not None:
            return loss, new_states, act_stats
        return loss, new_states

    def _stage(self, x, y, mask):
        return (self._to_input(x), self._to_input(y),
                None if mask is None else self._to_input(mask))

    def score_for(self, x, y, mask=None) -> float:
        """The loss on one batch, without a gradient or an update (the
        train-mode forward, no dropout, as the reference)."""
        x, y, mask = self._stage(x, y, mask)
        with torch.no_grad():
            loss, _ = self._loss_fn(x, y, mask)
        return float(loss)

    def score(self) -> Optional[float]:
        """The last training step's loss (one host sync), or None."""
        return None if self._score is None else float(self._score)

    def _loss_and_grads(self, x, y, mask, *, states=None, generator=None,
                        collect_stats=None):
        """``(loss, grads, new_states, act_stats)`` — the reference's
        ``jax.value_and_grad`` of ``_loss_fn``, by torch autograd."""
        params = self._require_params()
        named = [(k, n, p) for k, ps in params.items() for n, p in ps.items()]
        out = self._loss_fn(x, y, mask, states=states, generator=generator,
                            collect_stats=collect_stats)
        loss, new_states = out[0], out[1]
        gs = torch.autograd.grad(loss, [p for _, _, p in named],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in params}
        for (k, n, p), g in zip(named, gs):
            grads[k][n] = torch.zeros_like(p) if g is None else g
        return (loss.detach(), grads, new_states,
                out[2] if collect_stats is not None else None)

    def compute_gradient_and_score(self, x, y, mask=None):
        """``(gradients, score)`` for one batch — no update applied."""
        x, y, mask = self._stage(x, y, mask)
        loss, grads, _, _ = self._loss_and_grads(x, y, mask)
        return grads, float(loss)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def set_listeners(self, *listeners) -> None:
        # varargs or one collection (the reference's two overloads)
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def enable_health_stats(self, config=True) -> None:
        """Reduce the per-layer training-health stats (``util.health``) in
        every training step from the next fit call on; ``fit_repeated`` and
        ``fit_scan`` reduce them on their last step. Consumers read
        ``util.health.latest_stats(net)``."""
        self.health_stats = _health.StatsConfig.coerce(config)

    def disable_health_stats(self) -> None:
        self.health_stats = None

    def _step_and_update(self, x, y, mask, rnn_state=None, stats=None,
                         stats_iteration=None):
        """One update. Returns the loss on the device; with ``stats``,
        the health stats of the step are stored on the net, labelled
        ``stats_iteration`` (default: the next iteration)."""
        if self._updater is None:
            self.init_updater()
        t = self.training
        dp = self._data_parallel
        if dp is not None:
            if rnn_state is not None:
                raise ValueError("truncated BPTT does not run under "
                                 "ParallelWrapper")
            x, y, mask = dp.shard(x, y, mask)
        gen = self._generator(f"update_{self._update_count}")
        with _tracing.phase("fit.forward_backward", self.tracer), (
                dp.loss_context() if dp is not None
                else contextlib.nullcontext()):
            loss, grads_raw, new_states, act_stats = self._loss_and_grads(
                x, y, mask, states=self._states_list(rnn_state),
                generator=gen, collect_stats=stats)
        if dp is not None:
            loss, grads_raw, ok = dp.reduce(loss, grads_raw, (x, y, mask))
            if not ok:
                # a skipped step: nothing moves but the update count
                self._update_count += 1
                self._last_rnn_carry = []
                self._score = loss
                return loss
        with _ingest.fit_phase("updater", self.tracer, "MultiLayerNetwork"):
            grads = _updaters.normalize_gradients(
                grads_raw, t.gradient_normalization,
                float(t.gradient_normalization_threshold))
            deltas, self.updater_state = self._updater.update(
                grads, self.updater_state, self._update_count)
            params = self.params
            _updaters.apply_updates(params, deltas)
        self._update_count += 1
        # the TBPTT boundary: the carry's values pass on, its graph does not
        self._last_rnn_carry = _detach_tree(self._extract_rnn_carry(new_states))
        self._persist_states(new_states)
        if stats is not None:
            with torch.no_grad():
                tree = _health.model_stats(params, grads_raw, deltas,
                                           act_stats, stats, loss=loss)
            self._last_health_stats = _health.DeviceStats(
                tree, iteration=(self.iteration_count + 1
                                 if stats_iteration is None
                                 else stats_iteration),
                model="MultiLayerNetwork")
        self._score = loss
        return loss

    def _steps(self, batches) -> torch.Tensor:
        """One update per (x, y, mask) of ``batches``; the last one reduces
        the health stats when they are on. Returns the [k] losses."""
        cfg = self.health_stats
        last = len(batches) - 1
        losses = [self._step_and_update(
            x, y, m, stats=cfg if i == last else None,
            stats_iteration=self.iteration_count + len(batches))
            for i, (x, y, m) in enumerate(batches)]
        return torch.stack(losses)

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
        per_step = losses.detach().float().cpu().numpy()
        for i in range(k):
            self._fire_iteration(batch_size, per_step[i])

    def _is_tbptt(self, x) -> bool:
        return (self.conf.backprop_type == "truncated_bptt" and x.ndim == 3
                and x.shape[1] > self.conf.tbptt_fwd_length)

    def _reject_tbptt(self, x, api: str) -> None:
        if self._is_tbptt(x):
            raise ValueError(
                f"{api} does not chunk truncated BPTT (T={x.shape[1]} > "
                f"tbptt_fwd_length={self.conf.tbptt_fwd_length}); use "
                "fit()/fit_batch(), or pre-chunk the sequences")

    def fit_batch(self, x, y, mask=None) -> torch.Tensor:
        """One minibatch update (TBPTT-aware). Returns the loss as a 0-dim
        tensor on the device (the last chunk's under TBPTT)."""
        x, y, mask = self._stage(x, y, mask)
        if self._is_tbptt(x):
            return self._fit_tbptt(x, y, mask)
        loss = self._step_and_update(x, y, mask, stats=self.health_stats)
        self._fire_iteration(x.shape[0], loss)
        return loss

    def _fit_tbptt(self, x, y, mask) -> torch.Tensor:
        """Truncated BPTT: [b, t, ...] in forward-length chunks, one update
        and one listener firing per chunk, the recurrent state carried
        across chunks with its gradient cut."""
        length = self.conf.tbptt_fwd_length
        rnn_state = self._zero_rnn_carry(x.shape[0])
        loss = None
        for start in range(0, x.shape[1], length):
            end = min(start + length, x.shape[1])
            ys = y[:, start:end] if y.ndim == 3 else y
            ms = (mask[:, start:end]
                  if (mask is not None and mask.ndim >= 2) else mask)
            loss = self._step_and_update(x[:, start:end], ys, ms,
                                         rnn_state=rnn_state,
                                         stats=self.health_stats)
            rnn_state = self._last_rnn_carry
            self._fire_iteration(x.shape[0], loss)
        return loss

    def fit_repeated(self, x, y, k: int, mask=None) -> torch.Tensor:
        """K updates on one batch — the same steps as K ``fit_batch``
        calls, with the [k] losses kept on the device."""
        x, y, mask = self._stage(x, y, mask)
        self._reject_tbptt(x, "fit_repeated")
        losses = self._steps([(x, y, mask)] * int(k))
        self._fire_replay(x.shape[0], losses)
        return losses

    def fit_scan(self, xs, ys, masks=None) -> torch.Tensor:
        """One update on each of K staged batches: xs/ys [k, b, ...],
        masks optional [k, ...]. Returns the [k] losses on the device."""
        xs, ys, masks = self._stage(xs, ys, masks)
        self._reject_tbptt(xs[0], "fit_scan")
        batches = [(xs[i], ys[i], None if masks is None else masks[i])
                   for i in range(xs.shape[0])]
        losses = self._steps(batches)
        self._fire_replay(xs.shape[1], losses)
        return losses

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None,
            coalesce: Optional[int] = None, session=None) -> None:
        """Train for ``epochs`` over (features, labels) arrays, a
        DataSet-like object, or an iterable of either, through the
        asynchronous loop (``util.ingest.run_fit_loop``): iterator
        batches staged onto the card by a background thread, losses kept
        on the card behind a bounded in-flight window, listeners handed a
        ``LazyScore``, resets at the start of each later epoch,
        ``coalesce=K`` runs of same-shape batches through ``fit_scan``,
        and ``session`` a ``util.durable.DurableSession`` (cursors,
        snapshots, preemption, watchdog)."""
        from ..util.ingest import run_fit_loop
        if self.params is None:
            self.init()
        run_fit_loop(self, data, labels, mask, epochs, coalesce,
                     model_label="MultiLayerNetwork", session=session)

    @staticmethod
    def _as_batches(data, labels=None, mask=None):
        from ..util.batching import iter_batches
        return iter_batches(data, labels, mask)

    # ------------------------------------------------------------------
    # layerwise pretraining
    # ------------------------------------------------------------------

    def pretrain(self, data, labels=None, *, epochs: int = 1,
                 learning_rate: Optional[float] = None) -> None:
        """Greedy layerwise pretraining of the AutoEncoder and RBM layers:
        each trains on the activations of the layers before it, frozen
        (``make_pretrain_step``), then the stack moves one layer deeper.
        Nothing else moves."""
        from .conf.pretrain import make_pretrain_step
        from ..util.batching import iter_batches
        if self.params is None:
            self.init()
        lr = float(learning_rate if learning_rate is not None
                   else self.training.learning_rate)
        pre_idx = [i for i, layer in enumerate(self.layers)
                   if hasattr(layer, "pretrain_loss")
                   or hasattr(layer, "contrastive_divergence_grads")]
        if not pre_idx:
            return
        batches = [self._to_input(x)
                   for x, _, _ in iter_batches(data, labels, None)]
        params = self._require_params()
        for i in pre_idx:
            step = make_pretrain_step(self.layers[i], lr, self.policy)
            # the layers before i are frozen, so its inputs are the same
            # every epoch: held across epochs when there are few batches
            cache = [None] * len(batches) if (
                epochs > 1 and len(batches) <= 64) else None
            for e in range(int(epochs)):
                for bi, x in enumerate(batches):
                    hidden = None if cache is None else cache[bi]
                    if hidden is None:
                        hidden = self._activation_upto(x, i)
                        if cache is not None:
                            cache[bi] = hidden
                    gen = named_generator(self.device, self.training.seed,
                                          f"pre_{i}_{e}_{bi}")
                    step(params[self.keys[i]], hidden, gen)

    def _activation_upto(self, x, layer_idx: int) -> torch.Tensor:
        """The input activation of layer ``layer_idx``: the layers before
        it in eval mode, then its preprocessor."""
        with torch.no_grad():
            cur, _ = self._forward(x, upto=layer_idx)
        proc = self.conf.input_preprocessors.get(layer_idx)
        if proc is not None:
            cur = proc(cur, minibatch_size=x.shape[0])
        return cur

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self, data, labels=None):
        """Classification :class:`~..eval.Evaluation` of ``output`` over an
        iterable of batches or (x, y) arrays."""
        from ..eval.evaluation import evaluate_network
        return evaluate_network(self, data, labels)
