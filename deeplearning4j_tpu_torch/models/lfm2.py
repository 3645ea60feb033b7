"""A hybrid conv/attention LM with sparse experts (Liquid AI's LFM2-MoE,
``model_type: lfm2_moe``) as a ComputationGraphConfiguration, trained by
``ComputationGraph.fit`` as ``transformer_lm`` is. The port's own: the
JAX package has no such model.

Each decoder layer is ``h = x + op(RMSNorm(x))``, then ``h +
ffn(RMSNorm(h))``, where ``op`` is a gated short convolution
(``layer_types[i] == "conv"``) or grouped-query attention
(``"full_attention"``), and ``ffn`` a dense SwiGLU for the first
``num_dense_layers`` layers and a sparse mixture of SwiGLU experts after
them (``nn/conf/hybrid.py``). A final RMSNorm and an untied softmax head
with a bias follow. Vertices: ``embed``, ``blk{i}_norm1``,
``blk{i}_conv`` or ``blk{i}_attn``, ``blk{i}_res1``, ``blk{i}_norm2``,
``blk{i}_ffn`` or ``blk{i}_moe``, ``blk{i}_res2``, ``final_norm``,
``out``.

For expert parallelism each MoE layer holds ``experts_held`` of its
``n_experts`` from ``first_expert`` on (all by default); it routes over
all of them and computes its own experts' part. No decode path: the
paged arena holds K/V only, and the short convolutions' state is not
K/V (``serving/decode.py`` refuses such a net).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex
from ..nn.conf.hybrid import (GatedShortConvLayer, GroupedQueryAttentionLayer,
                              RMSNormalization, SparseMoELayer,
                              SwiGLUFeedForwardLayer)
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import EmbeddingSequenceLayer, RnnOutputLayer

LAYER_KINDS = ("conv", "full_attention")


def lfm2_moe_lm(vocab_size: int, *, layer_types: Sequence[str],
                d_model: int, n_heads: int, n_kv_heads: int, d_ff: int,
                moe_d_ff: int, n_experts: int, top_k: int,
                num_dense_layers: int, experts_held: Optional[int] = None,
                first_expert: int = 0, conv_L: int = 3,
                rope_theta: float = 1e6, norm_eps: float = 1e-5,
                routed_scaling: float = 1.0, bias_update_rate: float = 1e-3,
                updater: str = "adam", learning_rate: float = 3e-4,
                seed: int = 42, dtype: str = "float32"):
    """Causal LM of ``len(layer_types)`` decoder layers: token ids ``[b,
    t]`` → softmax over the vocabulary, scored by ``sparse_mcxent``."""
    bad = [k for k in layer_types if k not in LAYER_KINDS]
    if bad:
        raise ValueError(f"unknown layer types {sorted(set(bad))}; "
                         f"expected {LAYER_KINDS}")
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).updater(updater).learning_rate(learning_rate)
          .dtype(dtype)
          .graph_builder()
          .add_inputs("in"))
    gb.add_layer("embed", EmbeddingSequenceLayer(
        n_in=vocab_size, n_out=d_model, activation="identity"), "in")
    prev = "embed"
    for i, kind in enumerate(layer_types):
        b = f"blk{i}"
        gb.add_layer(f"{b}_norm1", RMSNormalization(eps=norm_eps), prev)
        if kind == "conv":
            op, layer = f"{b}_conv", GatedShortConvLayer(
                n_in=d_model, conv_l=conv_L)
        else:
            op, layer = f"{b}_attn", GroupedQueryAttentionLayer(
                n_in=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                rope_theta=rope_theta, norm_eps=norm_eps)
        gb.add_layer(op, layer, f"{b}_norm1")
        gb.add_vertex(f"{b}_res1", ElementWiseVertex(op="add"), prev, op)
        gb.add_layer(f"{b}_norm2", RMSNormalization(eps=norm_eps),
                     f"{b}_res1")
        if i < num_dense_layers:
            ffn, layer = f"{b}_ffn", SwiGLUFeedForwardLayer(
                n_in=d_model, d_hidden=d_ff)
        else:
            ffn, layer = f"{b}_moe", SparseMoELayer(
                name=f"{b}_moe", n_in=d_model, d_hidden=moe_d_ff,
                n_experts=n_experts, top_k=top_k, experts_held=experts_held,
                first_expert=first_expert, routed_scaling=routed_scaling,
                bias_update_rate=bias_update_rate)
        gb.add_layer(ffn, layer, f"{b}_norm2")
        gb.add_vertex(f"{b}_res2", ElementWiseVertex(op="add"),
                      f"{b}_res1", ffn)
        prev = f"{b}_res2"
    gb.add_layer("final_norm", RMSNormalization(eps=norm_eps), prev)
    gb.add_layer("out", RnnOutputLayer(
        n_in=d_model, n_out=vocab_size, activation="softmax",
        loss="sparse_mcxent"), "final_norm")
    gb.set_outputs("out")
    gb.set_input_types(InputType.recurrent(1))
    return gb.build()
