"""ComputationGraph configuration: a DAG of named vertices (counterpart of
the JAX package's ``nn/conf/graph.py``; the same JSON).

This slice ports the vertices the transformer uses — ``LayerVertex`` and
``ElementWiseVertex`` — and no preprocessors. Any other vertex type, or a
non-null preprocessor, in a configuration raises :class:`NotYetPorted`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Type

import torch

from .inputs import InputType
from .layers import Layer, NotYetPorted, layer_from_dict, layer_to_dict
from .training import TrainingConfig

# register the layer types the graph JSON may name
from . import attention as _attention  # noqa: F401
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
            raise NotYetPorted(
                "input preprocessor "
                f"{v['__preprocessor__'].get('type', '?')!r} is not yet "
                "ported to the PyTorch package")
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

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def set_n_in(self, input_types: List[InputType], override: bool = False) -> None:
        pass

    def apply(self, params, xs: List[torch.Tensor], *, state=None,
              policy=None, masks=None, train=False):
        raise NotImplementedError

    def output_mask(self, masks: Optional[List[Optional[torch.Tensor]]]):
        """Propagate masks: the first non-None input mask."""
        for m in masks or ():
            if m is not None:
                return m
        return None


@register_vertex("layer")
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """Wraps a Layer config as a single-input vertex. ``preprocessor`` is
    kept for the JSON; the port has no preprocessors yet, so it is None."""

    layer: Layer = None
    preprocessor: Optional[Any] = None

    def __post_init__(self):
        if self.preprocessor is not None:
            raise NotYetPorted("input preprocessors are not yet ported to "
                               "the PyTorch package")

    def init_params(self, gen, policy=None, device="cpu"):
        return self.layer.init_params(gen, policy, device)

    def param_shapes(self, policy=None):
        return self.layer.param_shapes(policy)

    def output_type(self, input_types):
        return self.layer.output_type(input_types[0])

    def set_n_in(self, input_types, override=False):
        self.layer.set_n_in(input_types[0], override)

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False):
        if train and (self.layer.dropout or 0.0) > 0.0:
            raise NotYetPorted(
                f"training a {type(self.layer).__name__} with dropout="
                f"{self.layer.dropout}: dropout is not yet ported to the "
                "PyTorch package")
        return self.layer.apply(params, xs[0], state=state,
                                mask=masks[0] if masks else None,
                                policy=policy)


@register_vertex("elementwise")
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add/subtract/product/average/max over equal-shaped inputs
    (the residual-sum building block)."""

    op: str = "add"   # add | subtract | product | average | max

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, xs, *, state=None, policy=None, masks=None,
              train=False):
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

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        layer = self._base._apply_defaults(layer)
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

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

    def build(self) -> ComputationGraphConfiguration:
        conf = ComputationGraphConfiguration(
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            training=copy.deepcopy(self._base._t),
            input_types=self._input_types,
        )
        conf.validate()
        # infer nIn along the DAG; where the reference would insert an
        # input preprocessor, refuse (none is ported yet)
        if conf.input_types is not None:
            types: Dict[str, InputType] = dict(
                zip(conf.network_inputs, conf.input_types))
            for name in conf.topological_order():
                v = conf.vertices[name]
                in_types = [types[i] for i in conf.vertex_inputs[name]]
                if isinstance(v, LayerVertex):
                    needed = v.layer.preprocessor_for(in_types[0])
                    if needed is not None:
                        raise NotYetPorted(
                            f"vertex {name!r} needs a {needed}, and input "
                            "preprocessors are not yet ported to the "
                            "PyTorch package")
                v.set_n_in(in_types, override=False)
                types[name] = v.output_type(in_types)
        return conf
