"""ComputationGraph: the DAG runtime model (counterpart of the JAX package's
``nn/graph_runtime.py``).

An ``nn.Module`` holding one ``ParameterDict`` per parameterised vertex.
The forward walks the configuration's topological order — the reference's
order — applying each vertex's forward function. PyTorch runs it eagerly;
the reference's ``jax.jit`` has no counterpart here.

This slice ports ``__init__``, ``init``, ``_forward`` and ``output``;
training (``fit_batch``/``fit_repeated``) and streaming
(``rnn_time_step``) come with later slices.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as _dtypes
from .conf.graph import ComputationGraphConfiguration


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
        # a loaded checkpoint's updater arrays ride along untouched so that
        # save_model writes them back (the updater itself is ported with
        # the training slice)
        self.updater_arrays: Dict[str, np.ndarray] = {}
        self.iteration_count = 0
        self.epoch_count = 0
        self._update_count = 0

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
        return self

    def num_params(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------
    # forward over the DAG
    # ------------------------------------------------------------------

    def _to_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _forward(self, inputs: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Walk the topo order; returns {vertex: activation}. (Masks reach
        the layers with the training slice; ``output`` takes none, as in
        the reference.)"""
        params = self.params
        if params is None:
            raise ValueError("call init() or load parameters first")
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        for name in self.topo_order:
            out, _ = self.conf.vertices[name].apply(
                params[name], [acts[i] for i in self.conf.vertex_inputs[name]],
                state=self.state.get(name), policy=self.policy)
            acts[name] = out
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
