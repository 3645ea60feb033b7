"""The port's transformer LM against the JAX package's, from a reference
checkpoint.

A JAX ``transformer_lm(V=256, L=2, d=64, h=4, d_ff=128, input_ids=True)``
is initialised, saved with the reference's ``save_model`` and loaded into
the port with its ``load_model`` (parity always runs from loaded weights:
jax and torch generators differ). Inputs are explicit numpy int32/float32
(``tests/conftest.py`` turns on jax x64). The JAX side runs both attention
routes: the Pallas flash kernel in interpret mode (T=128) and the dense
XLA path.

Tolerances: f32 1e-5 — same weights and inputs, only summation order
differs. mixed_bf16: max|Δp| ≤ 5% of the largest p — bf16 keeps 8 bits
of mantissa (0.4% a rounding), and the two frameworks round activations at
different places across two blocks and the softmax (measured: 2.4%).
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.attention import \
    SelfAttentionLayer as JSelfAttentionLayer
from deeplearning4j_tpu.nn.conf.layers import \
    LayerNormalization as JLayerNormalization
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

import jax.numpy as jnp

from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.conf.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (LayerNormalization,
                                                     NotYetPorted)
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.util.serialization import load_model

V, L, D, H, FF, T = 256, 2, 64, 4, 128, 128
F32_TOL = 1e-5
BF16_REL_TOL = 0.05


def _reference(tmp_path, dtype="float32", input_ids=True, seed=7):
    conf = j_transformer_lm(V, n_layers=L, d_model=D, n_heads=H, d_ff=FF,
                            dtype=dtype, input_ids=input_ids, seed=seed)
    jnet = JComputationGraph(conf).init()
    path = str(tmp_path / f"ref_{dtype}_{input_ids}.zip")
    j_save_model(jnet, path)
    return jnet, load_model(path, device="cpu")


def _ids(batch=2, seed=0):
    return np.random.default_rng(seed).integers(0, V, (batch, T)).astype(np.int32)


@pytest.fixture(scope="module")
def f32_pair(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("f32"))


@pytest.mark.parametrize("id_dtype", [np.int32, np.float32])
@pytest.mark.parametrize("jax_flash", ["1", "0"])
@pytest.mark.parametrize("port_flash", ["1", "0"])
def test_output_matches_reference_f32(monkeypatch, f32_pair, id_dtype,
                                      jax_flash, port_flash):
    jnet, tnet = f32_pair
    ids = _ids().astype(id_dtype)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", jax_flash)
    ref = np.asarray(jnet.output(ids))
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", port_flash)
    out = tnet.output(ids)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, T, V)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)


def test_one_hot_input_matches_reference(tmp_path):
    jnet, tnet = _reference(tmp_path, input_ids=False)
    x = np.eye(V, dtype=np.float32)[_ids(batch=1, seed=3)]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               atol=F32_TOL, rtol=0)


def test_mixed_bf16_matches_reference(monkeypatch, tmp_path):
    jnet, tnet = _reference(tmp_path, dtype="mixed_bf16")
    ids = _ids(seed=1)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    ref = np.asarray(jnet.output(ids).astype(jnp.float32))
    out = tnet.output(ids)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=BF16_REL_TOL * ref.max(), rtol=0)


def test_bf16_ids_never_pass_through_bf16(tmp_path):
    """Ids past 256 survive as float32 and as int32 (bf16 would round them)."""
    conf = transformer_lm(4096, n_layers=1, d_model=D, n_heads=H, d_ff=FF,
                          dtype="mixed_bf16", input_ids=True)
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    net = ComputationGraph(conf, device="cpu").init()
    ids = np.array(([257, 4095, 1001] * 43)[:T], np.int64)[None]
    embed = conf.vertices["embed"].layer
    params = net.params["embed"]
    want = params["W"][torch.from_numpy(ids)].to(torch.bfloat16)
    for x in (ids.astype(np.float32), ids.astype(np.int32)):
        emb, _ = embed.apply(params, torch.from_numpy(x), policy=net.policy)
        assert emb.dtype == torch.bfloat16 and torch.equal(emb, want)


def test_out_of_range_ids_match_reference_take():
    """Ids in [-V, 0) wrap and any other out-of-range id gives a NaN row,
    as the reference's jnp.take does — never a device-side index error."""
    from deeplearning4j_tpu.nn.conf.layers import \
        EmbeddingSequenceLayer as JEmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.conf.layers import EmbeddingSequenceLayer
    rng = np.random.default_rng(8)
    w = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([[0, V - 1, V, -1, -V, -V - 1, 10 * V, 7]], np.int32)
    for x in (ids, ids.astype(np.float32)):
        jy, _ = JEmbeddingSequenceLayer(n_in=V, n_out=D).apply(
            {"W": jnp.asarray(w)}, jnp.asarray(x))
        ty, _ = EmbeddingSequenceLayer(n_in=V, n_out=D).apply(
            {"W": torch.from_numpy(w)}, torch.from_numpy(x))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert np.isnan(ty.numpy()[0, [2, 5, 6]]).all()


@pytest.mark.parametrize("input_ids", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "mixed_bf16"])
def test_to_json_equals_reference(input_ids, dtype):
    ref = j_transformer_lm(V, n_layers=L, d_model=D, n_heads=H, d_ff=FF,
                           dtype=dtype, input_ids=input_ids)
    port = transformer_lm(V, n_layers=L, d_model=D, n_heads=H, d_ff=FF,
                          dtype=dtype, input_ids=input_ids)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    # and the port reads the reference's JSON back to the same thing
    again = ComputationGraphConfiguration.from_json(ref.to_json())
    assert json.loads(again.to_json()) == json.loads(ref.to_json())
    assert again.topological_order() == ref.topological_order()


def test_attention_output_goes_through_sigmoid():
    """Reference behaviour the port mirrors: the builder fills
    activation="sigmoid" into the attention layer, and apply() runs it."""
    conf = transformer_lm(V, n_layers=1, d_model=D, n_heads=H, d_ff=FF)
    attn = conf.vertices["blk0_attn"].layer
    assert attn.activation == "sigmoid"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    mask = np.ones((2, T), np.float32)
    mask[1, :40] = 0.0
    gen = torch.Generator().manual_seed(0)
    params = attn.init_params(gen)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    plain = SelfAttentionLayer(n_in=D, n_out=D, n_heads=H,
                               activation="identity")
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        y, _ = attn.apply(params, torch.from_numpy(x), mask=tm)
        z, _ = plain.apply(params, torch.from_numpy(x), mask=tm)
        want = torch.sigmoid(z) if m is None else torch.sigmoid(z) * tm[..., None]
        torch.testing.assert_close(y, want, atol=1e-6, rtol=0)
        jlayer = JSelfAttentionLayer(n_in=D, n_out=D, n_heads=H,
                                     activation="sigmoid")
        jy, _ = jlayer.apply(jparams, jnp.asarray(x),
                             mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL,
                                   rtol=0)


def test_layer_norm_ignores_its_activation():
    """Reference behaviour the port mirrors: LayerNormalization carries the
    builder's "sigmoid" in its JSON and never applies it."""
    conf = transformer_lm(V, n_layers=1, d_model=D, n_heads=H, d_ff=FF)
    ln = conf.vertices["blk0_ln1"].layer
    assert ln.activation == "sigmoid"
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, D)).astype(np.float32) * 3 + 1
    params = {"gamma": torch.from_numpy(rng.standard_normal(D).astype(np.float32)),
              "beta": torch.from_numpy(rng.standard_normal(D).astype(np.float32))}
    y, _ = ln.apply(params, torch.from_numpy(x))
    z, _ = LayerNormalization(n_out=D, activation="identity").apply(
        params, torch.from_numpy(x))
    assert torch.equal(y, z)
    assert (y < 0).any()          # no sigmoid was applied
    jy, _ = JLayerNormalization(n_out=D, activation="sigmoid").apply(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL, rtol=0)
    # bf16 in, bf16 out, normalized in f32
    yb, _ = ln.apply(params, torch.from_numpy(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16


def test_builder_defaults_match_reference():
    jconf = (JNeuralNetConfiguration.builder().graph_builder()
             .add_inputs("in")
             .add_layer("ln", JLayerNormalization(), "in")
             .set_outputs("ln").build())
    tconf = (NeuralNetConfiguration.builder().graph_builder()
             .add_inputs("in")
             .add_layer("ln", LayerNormalization(), "in")
             .set_outputs("ln").build())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())


def test_unported_parts_raise_naming_them(tmp_path):
    """The MoE variant and every vertex type the reference registers are
    ported; a layer, preprocessor or vertex type no package registers
    raises NotYetPorted naming it."""
    conf = transformer_lm(V, n_layers=1, d_model=D, n_heads=H, d_ff=FF,
                          moe_experts=2)
    assert json.loads(conf.to_json()) == json.loads(j_transformer_lm(
        V, n_layers=1, d_model=D, n_heads=H, d_ff=FF,
        moe_experts=2).to_json())
    d = json.loads(j_transformer_lm(V, n_layers=1, d_model=D, n_heads=H,
                                    d_ff=FF, input_ids=True).to_json())
    d["vertices"]["blk0_ff1"]["layer"]["__layer__"]["type"] = "auto_encoder"
    with pytest.raises(NotYetPorted, match="'auto_encoder'"):
        ComputationGraphConfiguration.from_dict(d)
    d = json.loads(j_transformer_lm(V, n_layers=1, d_model=D, n_heads=H,
                                    d_ff=FF, input_ids=True).to_json())
    d["vertices"]["blk0_ff1"]["preprocessor"] = {
        "__preprocessor__": {"type": "rnn_to_ff"}}
    with pytest.raises(NotYetPorted, match="preprocessor"):
        ComputationGraphConfiguration.from_dict(d)
    d = json.loads(j_transformer_lm(V, n_layers=1, d_model=D, n_heads=H,
                                    d_ff=FF, input_ids=True).to_json())
    d["vertices"]["blk0_res1"]["type"] = "merge"
    merged = ComputationGraphConfiguration.from_dict(d)
    assert type(merged.vertices["blk0_res1"]).__name__ == "MergeVertex"
    d["vertices"]["blk0_res1"]["type"] = "attention_vertex"
    with pytest.raises(NotYetPorted, match="'attention_vertex'"):
        ComputationGraphConfiguration.from_dict(d)


def test_flash_route_taken_on_cpu_only_when_forced(monkeypatch, f32_pair):
    """auto → dense on the CPU; forcing flash runs the plain version (the
    kernel's launch count never moves on the CPU)."""
    _, tnet = f32_pair
    calls = []
    orig = tfa.flash_attention_fwd_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", spy)
    monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    tnet.output(_ids())
    assert not calls
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    before = tfa.FLASH_FWD.launches
    tnet.output(_ids())
    assert len(calls) == L and tfa.FLASH_FWD.launches == before
