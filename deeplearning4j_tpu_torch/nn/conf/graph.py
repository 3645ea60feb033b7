"""ComputationGraph configuration: a DAG of named vertices (counterpart of
the JAX package's ``nn/conf/graph.py``; the same JSON and YAML).

The reference's thirteen vertex types: ``LayerVertex`` (a layer and its
input preprocessor), ``ElementWiseVertex``, ``MergeVertex``,
``SubsetVertex``, ``StackVertex``, ``UnstackVertex``, ``ScaleVertex``,
``ShiftVertex``, ``L2Vertex``, ``L2NormalizeVertex``,
``PreprocessorVertex``, ``LastTimeStepVertex`` and
``DuplicateToTimeSeriesVertex``. Each vertex maps its input activations
to an output, its input masks to an output mask, and its inputs' example
counts to its own (``output_minibatch``: Stack and Unstack change it).
A type name no package registers raises :class:`NotYetPorted`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Type

import torch

from .inputs import InputType
from .layers import Layer, NotYetPorted, layer_from_dict, layer_to_dict
from .preprocessors import (InputPreProcessor, call_preprocessor,
                            preprocessor_from_dict)
from .training import TrainingConfig

# register the layer types the graph JSON may name
from . import attention as _attention  # noqa: F401
from . import hybrid as _hybrid  # noqa: F401
from . import moe as _moe  # noqa: F401
from . import pretrain as _pretrain  # noqa: F401
from . import recurrent as _recurrent  # noqa: F401

VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


def register_vertex(name: str):
    def deco(cls):
        cls._type_name = name
        VERTEX_REGISTRY[name] = cls
        return cls
    return deco


def vertex_to_dict(v: "GraphVertex") -> dict:
    d = {"type": v._type_name}
    for f in dataclasses.fields(v):
        val = getattr(v, f.name)
        if isinstance(val, Layer):
            val = {"__layer__": layer_to_dict(val)}
        elif isinstance(val, InputPreProcessor):
            val = {"__preprocessor__": val.to_dict()}
        elif isinstance(val, tuple):
            val = list(val)
        d[f.name] = val
    return d


def vertex_from_dict(d: dict) -> "GraphVertex":
    d = dict(d)
    typ = d.pop("type")
    cls = VERTEX_REGISTRY.get(typ)
    if cls is None:
        raise NotYetPorted(f"graph vertex type {typ!r} is not yet ported to "
                           "the PyTorch package")
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in field_map:
            continue
        if isinstance(v, dict) and "__layer__" in v:
            v = layer_from_dict(v["__layer__"])
        elif isinstance(v, dict) and "__preprocessor__" in v:
            v = preprocessor_from_dict(v["__preprocessor__"])
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


# --------------------------------------------------------------------------
# vertices
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GraphVertex:
    """A function over one or more input activations."""

    _type_name = "base"

    def init_params(self, gen, policy=None, device="cpu") -> Dict[str, Any]:
        return {}

    def param_shapes(self, policy=None) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_state(self, policy=None, device="cpu") -> Dict[str, Any]:
        return {}

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def set_n_in(self, input_types: List[InputType], override: bool = False) -> None:
        pass

    def apply(self, params, xs: List[torch.Tensor], *, state=None,
              policy=None, masks=None, train=False, generator=None,
              minibatch=None):
        raise NotImplementedError

    def output_mask(self, masks: Optional[List[Optional[torch.Tensor]]],
                    minibatch: Optional[int] = None):
        """Propagate masks: the first non-None input mask. ``minibatch`` is
        the row count of this vertex's input activations."""
        for m in masks or ():
            if m is not None:
                return m
        return None

    def output_minibatch(self, in_mbs: List[int]) -> int:
        """The example count of this vertex's output (time-flattened
        activations have b·t rows, so the runtime tracks the true count
        along the DAG); the batch-axis vertices override it."""
        return in_mbs[0]


@register_vertex("layer")
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """Wraps a Layer config (and its optional input preprocessor) as a
    single-input vertex."""

    layer: Layer = None
    preprocessor: Optional[InputPreProcessor] = None

    def init_params(self, gen, policy=None, device="cpu"):
        return self.layer.init_params(gen, policy, device)

    def init_state(self, policy=None, device="cpu"):
        return self.layer.init_state(policy, device)

    def param_shapes(self, policy=None):
        return self.layer.param_shapes(policy)

    def _in_type(self, input_types):
        it = input_types[0]
        return (it if self.preprocessor is None
                else self.preprocessor.output_type(it))

    def output_type(self, input_types):
        return self.layer.output_type(self._in_type(input_types))

    def set_n_in(self, input_types, override=False):
        self.layer.set_n_in(self._in_type(input_types), override)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        x = xs[0]
        mask = masks[0] if masks else None
        if self.preprocessor is not None:
            # the NETWORK minibatch: time-flattened inputs arrive as
            # [b*t, f] and FeedForwardToRnn rebuilds [b, t, f]
            mb = minibatch if minibatch is not None else x.shape[0]
            x = call_preprocessor(self.preprocessor, x, minibatch_size=mb,
                                  generator=generator)
            mask = self.preprocessor.transform_mask(mask, minibatch_size=mb)
        return self.layer.apply(params, x, state=state, train=train,
                                generator=generator, mask=mask, policy=policy)


@register_vertex("merge")
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature (last) axis — depth for NHWC CNN
    activations."""

    def output_type(self, input_types):
        first = input_types[0]
        if first.kind == "convolutional":
            return InputType.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        if first.kind == "recurrent":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       first.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in input_types))

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return torch.cat(list(xs), dim=-1), state


@register_vertex("elementwise")
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add/subtract/product/average/max over equal-shaped inputs
    (the residual-sum building block)."""

    op: str = "add"   # add | subtract | product | average | max

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        op = self.op.lower()
        if op == "add":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
        elif op == "subtract":
            if len(xs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            out = xs[0] - xs[1]
        elif op == "product":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
        elif op == "average":
            out = sum(xs) / float(len(xs))
        elif op == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"unknown elementwise op {self.op!r}")
        return out, state


@register_vertex("subset")
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features ``[from_idx, to_idx]`` inclusive (channels for CNN
    activations)."""

    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        it = input_types[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timesteps)
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return xs[0][..., self.from_idx:self.to_idx + 1], state


@register_vertex("stack")
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack the inputs along the batch axis (weight-shared towers)."""

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return torch.cat(list(xs), dim=0), state

    def output_mask(self, masks, minibatch=None):
        if not masks or all(m is None for m in masks):
            return None
        if any(m is None for m in masks):
            raise ValueError("StackVertex: either all or no inputs may be "
                             "masked")
        return torch.cat(list(masks), dim=0)

    def output_minibatch(self, in_mbs):
        return sum(in_mbs)


@register_vertex("unstack")
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Batch slice ``from_idx`` of ``stack_size`` equal slices."""

    from_idx: int = 0
    stack_size: int = 1

    def output_type(self, input_types):
        return input_types[0]

    def _slice(self, a):
        step = a.shape[0] // self.stack_size
        return a[self.from_idx * step:(self.from_idx + 1) * step]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return self._slice(xs[0]), state

    def output_mask(self, masks, minibatch=None):
        m = super().output_mask(masks)
        return None if m is None else self._slice(m)

    def output_minibatch(self, in_mbs):
        return in_mbs[0] // self.stack_size


@register_vertex("scale")
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar."""

    scale: float = 1.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return xs[0] * self.scale, state


@register_vertex("shift")
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """Add a fixed scalar."""

    shift: float = 0.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        return xs[0] + self.shift, state


@register_vertex("l2")
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs → [b, 1] (siamese and triplet
    nets): ``sqrt(Σ (a - b)² + epsilon)``."""

    epsilon: float = 1e-8

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        a = xs[0].reshape(xs[0].shape[0], -1)
        b = xs[1].reshape(xs[1].shape[0], -1)
        d2 = torch.sum(torch.square(a - b), dim=1, keepdim=True)
        return torch.sqrt(d2 + self.epsilon), state


@register_vertex("l2normalize")
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """``x / sqrt(Σ x² + epsilon)`` over every axis but the batch."""

    epsilon: float = 1e-8

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        x = xs[0]
        dims = tuple(range(1, x.ndim))
        norm = torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True)
                          + self.epsilon)
        return x / norm, state


@register_vertex("preprocessor")
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """A standalone input preprocessor (a shape adapter, or a sampler that
    draws from the step's generator)."""

    preprocessor: InputPreProcessor = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        x = xs[0]
        mb = minibatch if minibatch is not None else x.shape[0]
        return call_preprocessor(self.preprocessor, x, minibatch_size=mb,
                                 generator=generator), state

    def output_mask(self, masks, minibatch=None):
        m = masks[0] if masks else None
        if m is None:
            return None
        return self.preprocessor.transform_mask(m, minibatch_size=minibatch)


@register_vertex("last_time_step")
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """[b, t, f] → [b, f] at each example's last unmasked step."""

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        x = xs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :], state
        # the first maximum of the flipped mask is the last active step
        last = torch.flip(mask > 0, dims=(1,)).to(torch.int8).argmax(dim=1)
        idx = x.shape[1] - 1 - last
        return x[torch.arange(x.shape[0], device=x.device), idx], state

    def output_mask(self, masks, minibatch=None):
        return None  # one row per example, all active


@register_vertex("duplicate_to_time_series")
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[b, f] broadcast to [b, t, f], t from the second input (the
    reference activation named by ``reference_input``)."""

    reference_input: str = ""

    def output_type(self, input_types):
        ref = input_types[1] if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].flat_size(),
                                   ref.timesteps if ref else None)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False, generator=None, minibatch=None):
        x, ref = xs[0], xs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1],
                                    x.shape[1]), state

    def output_mask(self, masks, minibatch=None):
        return masks[1] if masks and len(masks) > 1 else None


# --------------------------------------------------------------------------
# configuration + builder
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """Named DAG: vertices, their input edges, network inputs/outputs."""

    vertices: Dict[str, GraphVertex]
    vertex_inputs: Dict[str, List[str]]
    network_inputs: List[str]
    network_outputs: List[str]
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    input_types: Optional[List[InputType]] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def topological_order(self) -> List[str]:
        """Kahn topo sort, deterministic (insertion order among ready
        nodes) — the reference's order, so vertices run in the same
        sequence."""
        indeg = {name: 0 for name in self.vertices}
        children: Dict[str, List[str]] = {name: [] for name in self.vertices}
        for name, inputs in self.vertex_inputs.items():
            for inp in inputs:
                if inp in self.vertices:
                    indeg[name] += 1
                    children[inp].append(name)
                elif inp not in self.network_inputs:
                    raise ValueError(
                        f"vertex {name!r} references unknown input {inp!r}")
        ready = [n for n in self.vertices if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            cyc = sorted(set(self.vertices) - set(order))
            raise ValueError(f"graph has a cycle involving {cyc}")
        return order

    def validate(self) -> None:
        for out in self.network_outputs:
            if out not in self.vertices:
                raise ValueError(f"network output {out!r} is not a vertex")
        for name in self.vertices:
            if name in self.network_inputs:
                raise ValueError(f"{name!r} is both a vertex and a network input")
            if not self.vertex_inputs.get(name):
                raise ValueError(f"vertex {name!r} has no inputs")
        self.topological_order()

    def infer_shapes(self) -> Dict[str, InputType]:
        """The output type of every vertex (and network input), inferring
        nIn along the way; empty without ``input_types``."""
        if self.input_types is None:
            return {}
        types: Dict[str, InputType] = dict(
            zip(self.network_inputs, self.input_types))
        for name in self.topological_order():
            v = self.vertices[name]
            in_types = [types[i] for i in self.vertex_inputs[name]]
            v.set_n_in(in_types, override=False)
            types[name] = v.output_type(in_types)
        return types

    def to_dict(self) -> dict:
        return {
            "format_version": 1,
            "framework": "deeplearning4j_tpu",
            "model": "computation_graph",
            "vertices": {n: vertex_to_dict(v) for n, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "training": self.training.to_dict(),
            "input_types": ([t.to_dict() for t in self.input_types]
                            if self.input_types else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            vertices={n: vertex_from_dict(v)
                      for n, v in d["vertices"].items()},
            vertex_inputs={n: list(v) for n, v in d["vertex_inputs"].items()},
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            training=TrainingConfig.from_dict(d.get("training", {})),
            input_types=([InputType.from_dict(t) for t in d["input_types"]]
                         if d.get("input_types") else None),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))


class GraphBuilder:
    """Fluent DAG builder, reached via
    ``NeuralNetConfiguration.builder().graph_builder()``."""

    def __init__(self, base):
        self._base = base
        self._vertices: Dict[str, GraphVertex] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._input_types: Optional[List[InputType]] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        layer = self._base._apply_defaults(layer)
        return self.add_vertex(
            name, LayerVertex(layer=layer, preprocessor=preprocessor),
            *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name {name!r}")
        if not inputs:
            raise ValueError(f"vertex {name!r} needs at least one input")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop_type(self, kind: str) -> "GraphBuilder":
        self._backprop_type = kind.lower()
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = int(n)
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = ComputationGraphConfiguration(
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            training=copy.deepcopy(self._base._t),
            input_types=self._input_types,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
        )
        conf.validate()
        # insert input preprocessors and infer nIn along the DAG
        if conf.input_types is not None:
            types: Dict[str, InputType] = dict(
                zip(conf.network_inputs, conf.input_types))
            for name in conf.topological_order():
                v = conf.vertices[name]
                in_types = [types[i] for i in conf.vertex_inputs[name]]
                if isinstance(v, LayerVertex) and v.preprocessor is None:
                    v.preprocessor = v.layer.preprocessor_for(in_types[0])
                v.set_n_in(in_types, override=False)
                types[name] = v.output_type(in_types)
        return conf
