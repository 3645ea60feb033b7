"""Sequence (context) parallelism: train attention models with the TIME
axis split over a ``seq`` mesh dim (counterpart of the JAX package's
``parallel/sequence.py``).

Activations are split [b, t/seq, f]: every per-timestep op (projections,
FFN, loss) runs on the local block, and the one op that mixes timesteps —
attention — runs as ring attention (``ops.attention``): K/V shards travel
around the dim's process group while each rank accumulates its local
queries online. Sequence length scales with devices; the [t, t] score
matrix never exists. The backward rides the same ring (the flash route's
autograd Function, or autograd through the plain route's shifts).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ops.attention import dot_product_attention, make_ring_attention
from . import collectives as _coll
from .dsl_trainer import ShardedDSLTrainerBase
from .mesh import axis_group, axis_names, axis_size, mesh_device

Pytree = Any


def init_block_params(generator: torch.Generator, d_model: int, d_ff: int,
                      n_heads: int, vocab: int, dtype=torch.float32,
                      device="cpu") -> Pytree:
    """Causal transformer block LM: in-proj → attention (+res) → FFN (+res)
    → vocab head; normal draws from ``generator``."""
    del n_heads  # head count is a forward-time reshape, not a param shape

    def normal(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=dtype)
        return (w * torch.tensor(1.0 / math.sqrt(fan), dtype=dtype)).to(device)

    return {
        "Win": normal((vocab, d_model), vocab),
        "Wqkv": normal((d_model, 3 * d_model), d_model),
        "Wo": normal((d_model, d_model), d_model),
        "W1": normal((d_model, d_ff), d_model),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=device),
        "W2": normal((d_ff, d_model), d_ff),
        "b2": torch.zeros((d_model,), dtype=dtype, device=device),
        "Whead": torch.zeros((d_model, vocab), dtype=dtype, device=device),
    }


def block_apply(params: Pytree, x, *, n_heads: int, attention_fn):
    """[b, t, vocab] one-hot → [b, t, vocab] logits. ``attention_fn`` is
    dense attention or the ring (the same [b, t, h, d] contract)."""
    h = x @ params["Win"]                                   # [b, t, d]
    b, t, d = h.shape
    qkv = (h @ params["Wqkv"]).reshape(b, t, 3, n_heads, d // n_heads)
    att = attention_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    h = h + att.reshape(b, t, d) @ params["Wo"]
    ff = torch.relu(h @ params["W1"] + params["b1"]) @ params["W2"]
    h = h + ff + params["b2"]
    return h @ params["Whead"]                              # [b, t, vocab]


def lm_loss(params: Pytree, x, y, *, n_heads: int, attention_fn):
    """Mean next-token cross entropy over every (global) position: inside
    a ``collectives.batch_split`` the count is the global one."""
    logits = block_apply(params, x, n_heads=n_heads,
                         attention_fn=attention_fn)
    logp = torch.log_softmax(logits, dim=-1)
    n = _coll.global_count(float(logp.shape[0] * logp.shape[1]))
    return -torch.sum(y * logp) / n


class SequenceParallelTrainer:
    """Train the causal block LM with the time axis split over ``axis``.

    ``fit_batch(x, y)`` takes GLOBAL [b, t, vocab] arrays (t divisible by
    the dim's size) on every rank; each rank runs its time block and the
    gradients are summed over the dim (plain SGD)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int, vocab: int,
                 mesh, *, axis: str = "seq", learning_rate: float = 0.1,
                 seed: int = 0):
        if axis not in axis_names(mesh):
            raise ValueError(f"axis {axis!r} not in mesh {axis_names(mesh)}")
        self.mesh = mesh
        self.axis = axis
        self.n_heads = int(n_heads)
        self.lr = float(learning_rate)
        self.device = mesh_device(mesh)
        self.params = init_block_params(
            torch.Generator().manual_seed(int(seed)), d_model, d_ff,
            n_heads, vocab, device=self.device)
        self._group = axis_group(mesh, axis)
        self._ring = make_ring_attention(mesh, axis, causal=True)

    def _stage(self, a):
        t = torch.as_tensor(a).to(self.device)
        n = axis_size(self.mesh, self.axis)
        if t.shape[1] % n:
            raise ValueError(f"t={t.shape[1]} does not split over "
                             f"{self.axis!r} ({n})")
        return _coll.local_slice(t, self._group, 1)

    def forward(self, x):
        """Logits for GLOBAL x, gathered back along time."""
        with torch.no_grad():
            out = block_apply(self.params, self._stage(x),
                              n_heads=self.n_heads, attention_fn=self._ring)
        return _coll.all_gather_dim(out, self._group, 1)

    def fit_batch(self, x, y):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        with _coll.batch_split((), time_groups=[self._group]):
            loss = lm_loss(params, self._stage(x), self._stage(y),
                           n_heads=self.n_heads, attention_fn=self._ring)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _coll.all_reduce_tree({"p": grads}, [self._group])
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=self._group)
        with torch.no_grad():
            self.params = {k: p - self.lr * grads[k]
                           for k, p in params.items()}
        return loss


def dense_attention_fn(q, k, v):
    """Single-device reference: the same contract as the ring."""
    return dot_product_attention(q, k, v, causal=True)


class SequenceParallelGraphTrainer(ShardedDSLTrainerBase):
    """Sequence-parallel training for ANY DSL model (``ComputationGraph``
    or ``MultiLayerNetwork``) whose vertices keep the time axis — e.g.
    ``models.transformer.transformer_lm``.

    Parameters stay whole; inputs/labels are split [b, t/seq, f] over
    ``seq_axis`` (and [b/dp, ...] over ``batch_axis`` for 2-D dp × sp
    meshes). Every per-timestep op runs on the local block; the one op
    that mixes timesteps — ``SelfAttentionLayer`` — runs as ring attention
    because the step runs the network's OWN loss inside an
    ``ops.attention.sequence_sharding`` context. Sequence masks ([b, t],
    split over batch × seq) travel the ring with their K/V shards.

    ``expert_axis``: optional mesh dim for sp × ep — MoELayer
    expert-stacked parameters are partitioned over it
    (``parallel.expert``'s placements) while the time axis rides the ring,
    in the same step."""

    _api = "SequenceParallelGraphTrainer"

    def __init__(self, net, mesh, *, seq_axis: str = "seq",
                 batch_axis: Optional[str] = None,
                 expert_axis: Optional[str] = None,
                 skip_nonfinite_budget: Optional[int] = None):
        from ..ops.attention import sequence_sharding

        if seq_axis not in axis_names(mesh):
            raise ValueError(f"seq_axis {seq_axis!r} not in mesh "
                             f"{axis_names(mesh)}")
        self.seq_axis = seq_axis
        placement = None
        expert_group = None
        if expert_axis is not None:
            from .expert import expert_param_shardings
            if net.params is None:
                net.init()
            placement = expert_param_shardings(net, mesh, expert_axis)
            expert_group = axis_group(mesh, expert_axis)

        @contextlib.contextmanager
        def step_ctx():
            with sequence_sharding(mesh, seq_axis, batch_axis), \
                    _coll.expert_split(expert_group):
                yield

        self._build(net, mesh,
                    x_spec=(batch_axis, seq_axis, None),
                    mask_spec=(batch_axis, seq_axis),
                    batch_axis=batch_axis,
                    param_placement=placement, step_ctx=step_ctx,
                    local_compute=expert_axis is not None,
                    skip_nonfinite_budget=skip_nonfinite_budget)
