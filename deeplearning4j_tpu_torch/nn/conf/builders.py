"""NeuralNetConfiguration builder — the user-facing config DSL
(counterpart of the JAX package's ``nn/conf/builders.py``; the same
methods, defaults and resulting configurations).

    conf = (NeuralNetConfiguration.builder()
            .seed(123)
            .updater("adam").learning_rate(1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())

Global defaults fill any per-layer field left as None, as in the reference
(activation "sigmoid", weight_init "XAVIER", ...). ``list()`` gives the
:class:`ListBuilder` of a ``MultiLayerConfiguration``; ``graph_builder()``
the DAG builder of a ``ComputationGraphConfiguration``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from ..weights import Distribution
from .inputs import InputType
from .layers import Layer
from .preprocessors import InputPreProcessor
from .training import TrainingConfig


class NeuralNetConfiguration:
    """Namespace for the builder entrypoint."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._t = TrainingConfig()
        # global layer defaults (applied to layers leaving fields None)
        self._defaults = dict(
            activation="sigmoid", weight_init="XAVIER", bias_init=0.0,
            dropout=0.0, l1=0.0, l2=0.0, dist=None,
            learning_rate=None, bias_learning_rate=None,
        )

    # ---- training-level settings ----
    def seed(self, s: int) -> "Builder":
        self._t.seed = int(s); return self

    def iterations(self, n: int) -> "Builder":
        self._t.iterations = int(n); return self

    def optimization_algo(self, algo: str) -> "Builder":
        self._t.optimization_algo = algo.lower(); return self

    def updater(self, name: str, **hyper) -> "Builder":
        self._t.updater = name.lower()
        for k, v in hyper.items():
            setattr(self._t, k, v)
        return self

    def learning_rate(self, lr: float) -> "Builder":
        self._t.learning_rate = float(lr); return self

    def bias_learning_rate(self, lr: float) -> "Builder":
        self._defaults["bias_learning_rate"] = float(lr); return self

    def momentum(self, m: float) -> "Builder":
        self._t.momentum = float(m); return self

    def rms_decay(self, d: float) -> "Builder":
        self._t.rms_decay = float(d); return self

    def rho(self, r: float) -> "Builder":
        self._t.rho = float(r); return self

    def adam_mean_decay(self, b1: float) -> "Builder":
        self._t.adam_beta1 = float(b1); return self

    def adam_var_decay(self, b2: float) -> "Builder":
        self._t.adam_beta2 = float(b2); return self

    def epsilon(self, e: float) -> "Builder":
        self._t.epsilon = float(e); return self

    def learning_rate_policy(self, policy: str, decay_rate: float = 0.0,
                             steps: float = 0.0, power: float = 0.0,
                             schedule: Optional[Dict[int, float]] = None) -> "Builder":
        self._t.lr_policy = policy.lower()
        self._t.lr_policy_decay_rate = decay_rate
        self._t.lr_policy_steps = steps
        self._t.lr_policy_power = power
        self._t.lr_schedule = schedule
        return self

    def gradient_normalization(self, kind: str, threshold: float = 1.0) -> "Builder":
        self._t.gradient_normalization = kind.lower()
        self._t.gradient_normalization_threshold = float(threshold)
        return self

    def gradient_checkpointing(self, flag: bool = True) -> "Builder":
        """Rematerialize activations in the backward pass: both runtimes
        train in checkpointed segments (``torch.utils.checkpoint``)."""
        self._t.gradient_checkpointing = bool(flag)
        return self

    def max_num_line_search_iterations(self, n: int) -> "Builder":
        self._t.max_line_search_iterations = int(n); return self

    def minibatch(self, flag: bool) -> "Builder":
        self._t.minibatch = bool(flag); return self

    def dtype(self, policy_name: str) -> "Builder":
        self._t.dtype = policy_name; return self

    # ---- per-layer global defaults ----
    def activation(self, a: str) -> "Builder":
        self._defaults["activation"] = a; return self

    def weight_init(self, w: str) -> "Builder":
        self._defaults["weight_init"] = w.upper(); return self

    def bias_init(self, b: float) -> "Builder":
        self._defaults["bias_init"] = float(b); return self

    def dist(self, d: Distribution) -> "Builder":
        self._defaults["dist"] = d; return self

    def drop_out(self, d: float) -> "Builder":
        self._defaults["dropout"] = float(d); return self

    def l1(self, v: float) -> "Builder":
        self._defaults["l1"] = float(v); return self

    def l2(self, v: float) -> "Builder":
        self._defaults["l2"] = float(v); return self

    def regularization(self, flag: bool) -> "Builder":
        self._t.regularization = bool(flag); return self

    # ---- transitions ----
    def list(self) -> "ListBuilder":
        return ListBuilder(self)

    def graph_builder(self):
        from .graph import GraphBuilder
        return GraphBuilder(self)

    # internal: fill a layer's None fields with the global defaults
    def _apply_defaults(self, layer: Layer) -> Layer:
        layer = copy.deepcopy(layer)
        for field, val in self._defaults.items():
            if getattr(layer, field, "missing") is None and val is not None:
                setattr(layer, field, val)
        return layer


class ListBuilder:
    """Builds a ``MultiLayerConfiguration``: the layer stack, explicit
    input preprocessors, the input type and the backprop/TBPTT fields."""

    def __init__(self, base: Builder):
        self._base = base
        self._layers: List[Layer] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop = True
        self._pretrain = False
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._backprop_type = "standard"  # "standard" | "truncated_bptt"

    def layer(self, layer_or_idx, maybe_layer=None) -> "ListBuilder":
        if maybe_layer is None:
            self._layers.append(layer_or_idx)
        else:
            idx = int(layer_or_idx)
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = maybe_layer
        return self

    def input_preprocessor(self, idx: int, preproc: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[idx] = preproc
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = bool(flag); return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = bool(flag); return self

    def backprop_type(self, kind: str) -> "ListBuilder":
        self._backprop_type = kind.lower(); return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = int(n); return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = int(n); return self

    def build(self) -> "MultiLayerConfiguration":
        from .multi_layer import MultiLayerConfiguration

        if any(l is None for l in self._layers):
            raise ValueError("layer indices have gaps")
        layers = [self._base._apply_defaults(l) for l in self._layers]
        preprocessors = dict(self._preprocessors)

        # nIn inference from the input type, and the preprocessors each
        # layer needs inserted where none was given
        input_type = self._input_type
        if input_type is not None:
            cur = input_type
            for i, layer in enumerate(layers):
                proc = preprocessors.get(i) or layer.preprocessor_for(cur)
                if proc is not None:
                    preprocessors[i] = proc
                    cur = proc.output_type(cur)
                layer.set_n_in(cur, override=False)
                cur = layer.output_type(cur)

        return MultiLayerConfiguration(
            layers=layers,
            input_preprocessors=preprocessors,
            training=copy.deepcopy(self._base._t),
            input_type=input_type,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
        )
