"""Decoder-only transformer LM as a ComputationGraphConfiguration
(counterpart of the JAX package's ``models/transformer.py::transformer_lm``;
it builds the same configuration, so ``to_json`` matches the reference's).

Pre-norm blocks of ``SelfAttentionLayer`` + time-distributed FFN with
``ElementWiseVertex`` residual adds. Two input contracts:
  - default: one-hot [b, t, vocab] inputs;
  - ``input_ids=True``: integer token ids [b, t] through an
    ``EmbeddingSequenceLayer`` gather (the realistic-vocab path).

This slice ports the dense-FFN model; the MoE variant (``moe_experts > 0``)
and autoregressive decode come later.
"""

from __future__ import annotations

from typing import Optional

from ..nn.conf.attention import SelfAttentionLayer
from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (EmbeddingSequenceLayer, LayerNormalization,
                              NotYetPorted, RnnOutputLayer)
from ..nn.conf.recurrent import TimeDistributedDenseLayer


def transformer_lm(vocab_size: int, *, n_layers: int = 4,
                   d_model: int = 256, n_heads: int = 4, d_ff: int = 1024,
                   updater: str = "adam", learning_rate: float = 3e-4,
                   seed: int = 42, dtype: str = "float32",
                   moe_experts: int = 0, moe_top_k: int = 2,
                   input_ids: bool = False,
                   max_cache_t: Optional[int] = None):
    """Causal LM: in-proj → n_layers × [ln → attention (+res) → ln → ffn
    (+res)] → final ln → vocab head (softmax)."""
    if d_model % n_heads:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_heads={n_heads}")
    if moe_experts > 0:
        raise NotYetPorted("transformer_lm(moe_experts > 0): the MoE layer "
                           "is not yet ported to the PyTorch package")
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).updater(updater).learning_rate(learning_rate)
          .dtype(dtype)
          .graph_builder()
          .add_inputs("in"))
    if input_ids:
        gb.add_layer("embed",
                     EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model,
                                            activation="identity"), "in")
    else:
        gb.add_layer("embed",
                     TimeDistributedDenseLayer(n_in=vocab_size,
                                               n_out=d_model,
                                               activation="identity"), "in")
    prev = "embed"
    for i in range(n_layers):
        b = f"blk{i}"
        gb.add_layer(f"{b}_ln1", LayerNormalization(), prev)
        gb.add_layer(f"{b}_attn",
                     SelfAttentionLayer(n_in=d_model, n_out=d_model,
                                        n_heads=n_heads, causal=True,
                                        max_cache_t=max_cache_t),
                     f"{b}_ln1")
        gb.add_vertex(f"{b}_res1", ElementWiseVertex(op="add"),
                      prev, f"{b}_attn")
        gb.add_layer(f"{b}_ln2", LayerNormalization(), f"{b}_res1")
        gb.add_layer(f"{b}_ff1",
                     TimeDistributedDenseLayer(n_in=d_model, n_out=d_ff,
                                               activation="relu"),
                     f"{b}_ln2")
        gb.add_layer(f"{b}_ff2",
                     TimeDistributedDenseLayer(n_in=d_ff, n_out=d_model,
                                               activation="identity"),
                     f"{b}_ff1")
        gb.add_vertex(f"{b}_res2", ElementWiseVertex(op="add"),
                      f"{b}_res1", f"{b}_ff2")
        prev = f"{b}_res2"
    gb.add_layer("final_ln", LayerNormalization(), prev)
    gb.add_layer("out", RnnOutputLayer(
        n_in=d_model, n_out=vocab_size, activation="softmax",
        loss="sparse_mcxent" if input_ids else "mcxent"), "final_ln")
    gb.set_outputs("out")
    gb.set_input_types(InputType.recurrent(1 if input_ids else vocab_size))
    return gb.build()
