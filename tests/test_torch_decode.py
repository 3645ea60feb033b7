"""The port's autoregressive decode against the JAX package's, on the CPU:
streaming ``rnn_time_step`` / ``generate``, the paged continuous-batching
engine and scheduler, the prefix cache, and ``POST /generate``.

The fixture model is the reference tests' (``tests/test_decode.py``):
``transformer_lm(11, n_layers=2, d_model=16, n_heads=2, d_ff=32,
input_ids=True, max_cache_t=32)``, engines of 8-token pages, 4 pages per
lane and prefill chunks of 4. The JAX net is initialised, saved with the
reference's ``save_model`` and loaded into the port (parity always runs
from the same weights). Inputs come from numpy seeds.

Tolerances: streaming probabilities against the JAX package at f32
within 1e-5 (same weights and inputs, only the libraries' summation
order differs). Greedy tokens are compared exactly, against the JAX
package's and against the port's own ``generate``. The engine's
probabilities after prefill are held within 1e-6 of ``rnn_time_step``'s,
not bitwise as the reference pins its own: PyTorch's CPU GEMM rounds a
row differently with the number of rows in the call (one row takes a
GEMV path; other row counts change the kernel's edge handling), and the
engine's padded [lanes, chunk] batch never has the oracle's row count.
Measured: at most 4.5e-8 (one f32 ulp of a 0.2 probability is 1.5e-8).
Under mixed_bf16, one attention layer's streaming and paged outputs are
held within 1e-6 of the reference's and the net's decode probabilities
within 8e-3 (see ``BF16_LAYER_TOL`` and ``BF16_PROB_TOL``).
"""

import json
import threading
import time
import urllib.error
import urllib.request
import warnings as _warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as j_dtypes
from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.models.transformer import generate as j_generate
from deeplearning4j_tpu.models.transformer import \
    oracle_stream_probs as j_oracle_stream_probs
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.serving.decode import \
    DecodeScheduler as JDecodeScheduler
from deeplearning4j_tpu.serving.decode import \
    PagedDecodeEngine as JPagedDecodeEngine
from deeplearning4j_tpu.util.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu.util.resilience import ManualClock as JManualClock
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch import dtypes as t_dtypes
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.transformer import (generate,
                                                         oracle_stream_probs)
from deeplearning4j_tpu_torch.nn.conf import attention as t_attention
from deeplearning4j_tpu_torch.nn.conf.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.ops import paged_attention as t_paged
from deeplearning4j_tpu_torch.serving import InferenceServer, ModelSwapRefused
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine,
                                                     SchedulerDraining,
                                                     SchedulerSaturated)
from deeplearning4j_tpu_torch.serving.kv_cache import (PageAllocator,
                                                       PrefixIndex)
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.netutil import StreamingCacheOverflow
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model

VOCAB = 11
PS = 8                      # page_size: window = 8 * 4 = 32
F32_TOL = 1e-5


def _jconf(max_cache_t=32, seed=5, n_layers=2, vocab=VOCAB,
           dtype="float32"):
    return j_transformer_lm(vocab, n_layers=n_layers, d_model=16, n_heads=2,
                            d_ff=32, seed=seed, input_ids=True,
                            max_cache_t=max_cache_t, dtype=dtype)


def _pair(tmp_path_factory, **kw):
    """(JAX net, the port's net loaded from its checkpoint, on the CPU)."""
    jnet = JComputationGraph(_jconf(**kw)).init()
    path = str(tmp_path_factory.mktemp("ckpt") / "ref.zip")
    j_save_model(jnet, path)
    return jnet, load_model(path, device="cpu")


def _tnet(max_cache_t=32, seed=5, n_layers=2):
    conf = transformer_lm(VOCAB, n_layers=n_layers, d_model=16, n_heads=2,
                          d_ff=32, seed=seed, input_ids=True,
                          max_cache_t=max_cache_t)
    return ComputationGraph(conf, device="cpu").init()


def _scheduler(net, *, max_batch=4, page_size=PS, pages_per_seq=4,
               prefill_chunk=4, registry=None, clock=None, **kw):
    registry = registry or MetricsRegistry()
    engine_kw = {k: kw.pop(k) for k in ("block_len", "num_pages",
                                        "prefix_cache") if k in kw}
    engine = PagedDecodeEngine(net, max_batch=max_batch,
                               page_size=page_size,
                               pages_per_seq=pages_per_seq,
                               prefill_chunk=prefill_chunk,
                               registry=registry, **engine_kw)
    return DecodeScheduler(engine, clock=clock or ManualClock(),
                           registry=registry, start_thread=False, **kw)


def _run(sched, reqs, limit=500):
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        sched.step_once()
        steps += 1
    assert all(r.done for r in reqs), [r.finish_reason for r in reqs]
    return steps


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory)


@pytest.fixture(scope="module")
def oracle_net(pair):
    return pair[1]


@pytest.fixture(scope="module")
def sched(oracle_net):
    return _scheduler(oracle_net)


# --------------------------------------------------------------------------
# streaming decode against the JAX package
# --------------------------------------------------------------------------


class TestStreamingAgainstReference:
    @pytest.fixture(scope="class")
    def small_window(self, tmp_path_factory):
        return _pair(tmp_path_factory, max_cache_t=8, n_layers=1, seed=4)

    @pytest.mark.parametrize("chunks", [(3, 3, 1, 1, 1, 1, 1, 2),
                                        (8, 1, 1, 4, 4, 1),
                                        (2, 2, 2, 2, 2, 2, 2)])
    def test_rnn_time_step_within_and_past_window(self, small_window,
                                                  chunks):
        """Chunks that stay inside the 8-step window, then overflow it
        one step and several steps at a time (chunk-granular eviction):
        every call's probabilities within 1e-5 of the reference's."""
        jnet, tnet = small_window
        ids = np.random.default_rng(sum(chunks)).integers(
            0, VOCAB, (2, sum(chunks), 1)).astype(np.int32)
        jnet.rnn_clear_previous_state()
        tnet.rnn_clear_previous_state()
        s0 = 0
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")        # overflow warning
            for c in chunks:
                ref = np.asarray(jnet.rnn_time_step(ids[:, s0:s0 + c]))
                got = tnet.rnn_time_step(ids[:, s0:s0 + c])
                assert tuple(got.shape) == ref.shape
                np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL,
                                           rtol=0)
                s0 += c
        assert tnet._rnn_steps_fed == jnet._rnn_steps_fed == sum(chunks)

    def test_single_step_input_is_squeezed(self, small_window):
        jnet, tnet = small_window
        ids = np.array([[3], [5]], np.int32)
        jnet.rnn_clear_previous_state()
        tnet.rnn_clear_previous_state()
        ref = np.asarray(jnet.rnn_time_step(ids))
        got = tnet.rnn_time_step(ids)
        assert tuple(got.shape) == ref.shape == (2, VOCAB)
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)

    @pytest.mark.parametrize("n", [1, 5, 8, 21])
    def test_oracle_stream_probs(self, small_window, n):
        """Inside the window and past it (the tail fed token by token)."""
        jnet, tnet = small_window
        ids = np.random.default_rng(n).integers(0, VOCAB, n)
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            ref = j_oracle_stream_probs(jnet, ids)
            got = oracle_stream_probs(tnet, ids)
        assert got.shape == ref.shape == (n, VOCAB)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)

    @pytest.mark.parametrize("n_prompt", [1, 3, 7, 13, 20])
    def test_generate_greedy_equals_reference(self, small_window, n_prompt):
        """Ragged prompts, including prompts longer than the window."""
        jnet, tnet = small_window
        prompt = np.random.default_rng(100 + n_prompt).integers(
            0, VOCAB, n_prompt)
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            ref = j_generate(jnet, prompt, 9)
            got = generate(tnet, prompt, 9)
        assert got.dtype == np.int32
        assert got.tolist() == ref.tolist()

    def test_generate_eos_equals_reference(self, pair):
        jnet, tnet = pair
        prompt = np.array([1, 2, 3, 4])
        free = generate(tnet, prompt, 8)
        eos = int(free[3])
        assert generate(tnet, prompt, 8, eos_id=eos).tolist() == \
            j_generate(jnet, prompt, 8, eos_id=eos).tolist()

    def test_window_decode_matches_truncated_full_forward(self, small_window):
        """Token-by-token decode past the window equals the full forward
        over exactly the last W tokens (real eviction, global
        positions)."""
        _, tnet = small_window
        w, t = 8, 14
        ids = np.random.default_rng(7).integers(0, VOCAB, (2, t, 1)).astype(
            np.int32)
        tnet.rnn_clear_previous_state()
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            steps = [tnet.rnn_time_step(ids[:, i]).numpy() for i in range(t)]
        for i in range(t):
            lo = max(0, i - w + 1)
            ref = tnet.output(ids[:, lo:i + 1, 0]).numpy()[:, -1]
            np.testing.assert_allclose(steps[i], ref, atol=F32_TOL, rtol=0)

    def test_overflow_warns_once(self, small_window):
        _, tnet = small_window
        ids = np.zeros((1, 5, 1), np.int32)
        tnet.rnn_clear_previous_state()
        with _warnings.catch_warnings():
            _warnings.simplefilter("error")
            tnet.rnn_time_step(ids)
        with pytest.warns(RuntimeWarning, match="max_cache_t"):
            tnet.rnn_time_step(ids)
        with _warnings.catch_warnings():
            _warnings.simplefilter("error")         # once, not per call
            tnet.rnn_time_step(ids[:, :1])

    def test_strict_mode_raises_before_dispatch(self, tmp_path):
        """Both packages refuse the overflowing chunk host-side and leave
        the cache untouched: a fitting chunk afterwards still matches."""
        conf = _jconf(max_cache_t=4, n_layers=1, seed=4)
        for v in conf.vertices.values():
            layer = getattr(v, "layer", None)
            if layer is not None and hasattr(layer, "cache_overflow"):
                layer.cache_overflow = "strict"
        jnet = JComputationGraph(conf).init()
        j_save_model(jnet, str(tmp_path / "strict.zip"))
        tnet = load_model(str(tmp_path / "strict.zip"), device="cpu")
        ids = np.array([[[1], [2], [3]]], np.int32)
        for net in (jnet, tnet):
            net.rnn_time_step(ids)
            with pytest.raises(Exception, match="max_cache_t=4") as e:
                net.rnn_time_step(ids)
            assert type(e.value).__name__ == "StreamingCacheOverflow"
            assert net._rnn_steps_fed == 3
        assert isinstance(_raise_overflow(tnet, ids), StreamingCacheOverflow)
        np.testing.assert_allclose(
            tnet.rnn_time_step(ids[:, :1]).numpy(),
            np.asarray(jnet.rnn_time_step(ids[:, :1])), atol=F32_TOL, rtol=0)
        tnet.rnn_clear_previous_state()
        tnet.rnn_time_step(ids)                     # a fresh window

    def test_bad_overflow_value_and_non_causal_refused(self):
        layer = SelfAttentionLayer(n_in=8, n_out=8, n_heads=2, causal=True,
                                   max_cache_t=8, cache_overflow="wat")
        with pytest.raises(ValueError, match="cache_overflow"):
            layer._zero_state(2, None)
        layer = SelfAttentionLayer(n_in=8, n_out=8, n_heads=2, causal=False,
                                   max_cache_t=8)
        with pytest.raises(ValueError, match="causal"):
            layer._zero_state(2, None)

    def test_generate_needs_a_streaming_cache(self):
        net = _tnet(max_cache_t=None, n_layers=1)
        with pytest.raises(ValueError, match="max_cache_t"):
            generate(net, [1, 2], 3)


# --------------------------------------------------------------------------
# decode under mixed_bf16 (the flagship's dtype) against the JAX package
# --------------------------------------------------------------------------

# One SelfAttentionLayer's streaming or paged output (f32 under mixed_bf16)
# on the same weights and inputs as the reference's: measured 6.0e-8 on
# these inputs, 1.2e-7 on other seeds (one and two f32 ulps of an output
# in (0, 1)). Leaving the softmax weights in f32 before the product with
# V, instead of rounding them to bf16 as the reference does, moves the
# same outputs by up to 6.3e-4 (streaming) and 5.7e-4 (paged).
BF16_LAYER_TOL = 1e-6
# Whole-net decode probabilities (bf16 under mixed_bf16): measured at most
# 3.9e-3 over 24 sequences of 5-20 tokens, i.e. two bf16 ulps of a
# probability in [0.25, 0.5); the layernorm, FFN and softmax output steps
# round to bf16 at points where the two libraries' f32 sums differ in the
# last bit. The planted fault above stays within this noise at the net's
# output, so the layer tests are the ones that catch it.
BF16_PROB_TOL = 8e-3


def _unrounded_cache_attention(q, kh, vh, allow, scale):
    """A planted fault: ``causal_cache_attention`` with the softmax
    weights kept in f32 for the product with V."""
    ct = torch.promote_types(q.dtype, kh.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), kh.to(ct)) * scale
    logits = torch.where(allow, logits.float(), float("-inf"))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.where(torch.isneginf(logits), 0.0, torch.exp(logits - m))
    weights = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", weights, vh.to(ct))


class TestMixedBf16AgainstReference:
    """The decode attention's dtypes under mixed_bf16: q and the weights
    in bf16, the K/V cache and pools in f32, q promoted to f32 for the
    logits, the softmax weights rounded to bf16 before the f32 product
    with V, the attention output and ``out @ Wo`` in f32, the scale
    ``1/sqrt(d)`` in bf16."""

    @pytest.fixture(scope="class")
    def bf16_pair(self, tmp_path_factory):
        return _pair(tmp_path_factory, max_cache_t=8, seed=5,
                     dtype="mixed_bf16")

    @staticmethod
    def _layers(bf16_pair):
        jnet, tnet = bf16_pair
        name = next(n for n, v in tnet.conf.vertices.items()
                    if isinstance(getattr(v, "layer", None),
                                  SelfAttentionLayer))
        return (jnet.conf.vertices[name].layer, jnet.params[name],
                tnet.conf.vertices[name].layer,
                tnet._require_params()[name])

    @staticmethod
    def _plant(monkeypatch):
        monkeypatch.setattr(t_attention, "causal_cache_attention",
                            _unrounded_cache_attention)
        monkeypatch.setattr(t_paged, "causal_cache_attention",
                            _unrounded_cache_attention)

    def _streaming_errs(self, bf16_pair):
        """Chunks inside the 8-step window and past it (the roll)."""
        jl, jp, tl, tp = self._layers(bf16_pair)
        jk, jv = jl._zero_state(2, j_dtypes.MIXED_BF16)
        js = {"h": jk, "c": jv}
        ts = tl._zero_state(2, t_dtypes.MIXED_BF16)
        rng = np.random.default_rng(1)
        errs = []
        with torch.inference_mode():
            for c in (3, 2, 1, 1, 4, 1, 2):
                x = rng.standard_normal((2, c, 16)).astype(np.float32)
                jo, js = jl.apply(jp, jnp.asarray(x), state=js,
                                  policy=j_dtypes.MIXED_BF16)
                to, ts = tl.apply(tp, torch.from_numpy(x), state=ts,
                                  policy=t_dtypes.MIXED_BF16)
                assert jo.dtype == np.float32 and to.dtype == torch.float32
                assert ts["h"].dtype == ts["c"].dtype == torch.float32
                errs.append(np.abs(np.asarray(jo, np.float64)
                                   - to.double().numpy()).max())
        return max(errs)

    def _paged_errs(self, bf16_pair):
        """Three lanes of 4-token pages: a sentinel hole, a full table,
        and a lane whose writes past its one page are dropped."""
        jl, jp, tl, tp = self._layers(bf16_pair)
        n_pages, ps = 8, 4
        jk = jnp.zeros((n_pages, ps, 2, 8), jnp.float32)
        jv = jk
        tk = torch.zeros((t_paged.pool_rows(n_pages), ps, 2, 8))
        tv = torch.zeros_like(tk)
        table = np.array([[0, 1, n_pages], [2, 3, 4],
                          [5, n_pages, n_pages]], np.int32)
        rng = np.random.default_rng(2)
        pos = np.zeros(3, np.int32)
        errs = []
        with torch.inference_mode():
            for c in (3, 1, 2, 1):
                x = rng.standard_normal((3, c, 16)).astype(np.float32)
                slots = (pos[:, None] + np.arange(c)[None]).astype(np.int32)
                slots[2] = np.where(slots[2] < ps, slots[2], -1)
                jo, jk, jv = jl.apply_paged(
                    jp, jnp.asarray(x), jk, jv, jnp.asarray(table),
                    jnp.asarray(slots), jnp.asarray(pos),
                    policy=j_dtypes.MIXED_BF16)
                to, tk, tv = tl.apply_paged(
                    tp, torch.from_numpy(x), tk, tv, torch.from_numpy(table),
                    torch.from_numpy(slots), torch.from_numpy(pos),
                    policy=t_dtypes.MIXED_BF16)
                assert jo.dtype == np.float32 and to.dtype == torch.float32
                assert tk.dtype == torch.float32
                errs.append(np.abs(np.asarray(jo, np.float64)
                                   - to.double().numpy()).max())
                pos = pos + c
        return max(errs)

    @pytest.mark.parametrize("path", ["streaming", "paged"])
    def test_attention_layer_equals_reference(self, bf16_pair, path):
        errs = (self._streaming_errs if path == "streaming"
                else self._paged_errs)
        assert errs(bf16_pair) <= BF16_LAYER_TOL

    @pytest.mark.parametrize("path", ["streaming", "paged"])
    def test_unrounded_softmax_weights_exceed_the_bound(self, bf16_pair,
                                                        path, monkeypatch):
        self._plant(monkeypatch)
        errs = (self._streaming_errs if path == "streaming"
                else self._paged_errs)
        assert errs(bf16_pair) > 50 * BF16_LAYER_TOL

    def test_rnn_time_step_equals_reference(self, bf16_pair):
        jnet, tnet = bf16_pair
        ids = np.random.default_rng(3).integers(0, VOCAB, (2, 12, 1)).astype(
            np.int32)
        jnet.rnn_clear_previous_state()
        tnet.rnn_clear_previous_state()
        s0 = 0
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")        # overflow warning
            for c in (3, 1, 4, 1, 3):
                ref = np.asarray(jnet.rnn_time_step(ids[:, s0:s0 + c]))
                got = tnet.rnn_time_step(ids[:, s0:s0 + c])
                assert got.dtype == torch.bfloat16 and ref.dtype.name == \
                    "bfloat16"
                np.testing.assert_allclose(got.double().numpy(),
                                           ref.astype(np.float64),
                                           atol=BF16_PROB_TOL, rtol=0)
                s0 += c

    @pytest.mark.parametrize("n", [5, 8, 14, 20])
    def test_oracle_stream_probs_equal_reference(self, bf16_pair, n):
        jnet, tnet = bf16_pair
        ids = np.random.default_rng(300 + n).integers(0, VOCAB, n)
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            ref = j_oracle_stream_probs(jnet, ids)
            got = oracle_stream_probs(tnet, ids)
        np.testing.assert_allclose(got, ref, atol=BF16_PROB_TOL, rtol=0)


def _raise_overflow(net, ids):
    try:
        net.rnn_time_step(ids)
    except StreamingCacheOverflow as e:
        return e
    return None


# --------------------------------------------------------------------------
# the paged engine
# --------------------------------------------------------------------------


class TestPagedParity:
    """Greedy continuous-batched decode == the port's single-sequence
    full-cache decode, token for token."""

    def test_ragged_batch_equals_generate(self, oracle_net, sched):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (3, 5, 7, 2)]
        n_new = [4, 6, 2, 8]
        oracle = [generate(oracle_net, p, n).tolist()
                  for p, n in zip(prompts, n_new)]
        reqs = [sched.submit(p, n) for p, n in zip(prompts, n_new)]
        _run(sched, reqs)
        for o, r in zip(oracle, reqs):
            assert r.tokens == o
        assert all(r.finish_reason == "max_tokens" for r in reqs)

    def test_first_token_probs_equal_rnn_time_step(self, oracle_net):
        """The engine's distribution after prefill (a lane of a 4-lane
        batch, prefilled in chunks of 4) equals rnn_time_step's on the
        same prompt within 1e-6 (see the module docstring for why not
        bitwise)."""
        sched = _scheduler(oracle_net)
        seen = {}
        emit = sched._emit_token

        def spy(seq, probs, **kw):
            if not seq.req.tokens:
                seen[id(seq.req)] = np.array(probs)
            return emit(seq, probs, **kw)

        sched._emit_token = spy
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, VOCAB, n) for n in (2, 9, 17, 30)]
        reqs = [sched.submit(p, 2) for p in prompts]
        _run(sched, reqs)
        for p, r in zip(prompts, reqs):
            oracle_net.rnn_clear_previous_state()
            ref = oracle_net.rnn_time_step(p[None, :, None])[0, -1].numpy()
            np.testing.assert_allclose(seen[id(r)], ref, atol=1e-6, rtol=0)

    def test_admission_mid_flight(self, oracle_net, sched):
        rng = np.random.default_rng(1)
        p0 = rng.integers(0, VOCAB, 4)
        first = sched.submit(p0, 10)
        for _ in range(3):
            sched.step_once()
        assert not first.done
        p1, p2 = rng.integers(0, VOCAB, 6), rng.integers(0, VOCAB, 2)
        later = [sched.submit(p1, 5), sched.submit(p2, 7)]
        _run(sched, [first] + later)
        assert first.tokens == generate(oracle_net, p0, 10).tolist()
        assert later[0].tokens == generate(oracle_net, p1, 5).tolist()
        assert later[1].tokens == generate(oracle_net, p2, 7).tolist()

    def test_multi_chunk_prefill(self, oracle_net, sched):
        prompt = np.random.default_rng(2).integers(0, VOCAB, 19)
        req = sched.submit(prompt, 6)
        _run(sched, [req])
        assert req.tokens == generate(oracle_net, prompt, 6).tolist()

    def test_eos_retires_like_generate(self, oracle_net, sched):
        prompt = np.random.default_rng(3).integers(0, VOCAB, 4)
        eos = int(generate(oracle_net, prompt, 8)[2])
        req = sched.submit(prompt, 8, eos_id=eos)
        _run(sched, [req])
        assert req.tokens == generate(oracle_net, prompt, 8,
                                      eos_id=eos).tolist()
        assert req.finish_reason == "eos" and len(req.tokens) < 8

    def test_page_table_reuse_after_free(self, oracle_net):
        """A 4-page arena with 2 lanes: the second wave decodes on the
        first wave's recycled pages, and the arena ends empty."""
        sched = _scheduler(oracle_net, max_batch=2, num_pages=4,
                           prefill_chunk=8)
        alloc = sched.engine.arena.allocator
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, VOCAB, n) for n in (5, 3, 6, 4)]
        reqs = [sched.submit(p, 5) for p in prompts]
        _run(sched, reqs)
        for p, r in zip(prompts, reqs):
            assert r.tokens == generate(oracle_net, p, 5).tolist()
        assert alloc.pages_in_use == 0 and alloc.reserved == 0
        assert sched.engine.lanes_free() == 2

    def test_long_generation_evicts_pages(self):
        """Past the window the engine slides a page at a time (no oracle
        comparison: the dense oracle slides a token at a time)."""
        reg = MetricsRegistry()
        sched = _scheduler(_tnet(max_cache_t=16, n_layers=1), max_batch=2,
                           pages_per_seq=2, prefill_chunk=8, registry=reg)
        req = sched.submit(np.arange(5) % VOCAB, 40)
        _run(sched, [req])
        assert len(req.tokens) == 40 and req.finish_reason == "max_tokens"
        assert reg.get("kv_pages_evicted_total").value() > 0
        assert sched.engine.arena.allocator.pages_in_use == 0

    def test_live_table_prefix_stays_contiguous(self):
        """Eviction while the table still has sentinel holes keeps the
        live prefix contiguous, and a long prompt through the scheduler
        reproduces itself on a second engine."""
        def engine():
            return PagedDecodeEngine(_tnet(max_cache_t=None, n_layers=1,
                                           seed=6),
                                     max_batch=1, page_size=4,
                                     pages_per_seq=3, prefill_chunk=8,
                                     registry=MetricsRegistry())
        eng = engine()
        lane = eng.acquire_lane(16)
        eng.ensure_pages(lane, 8)
        eng.advance(lane, 8)
        eng.ensure_pages(lane, 8)
        held = eng._held[lane]
        live = eng._tables[lane][:len(held)]
        assert (live != eng.arena.sentinel).all()
        assert sorted(live.tolist()) == sorted(held)
        rel = eng.rel_pos(lane)
        for s in range(rel, rel + 8):
            assert eng._tables[lane][s // 4] != eng.arena.sentinel
        eng.release_lane(lane)
        prompt = (np.arange(16) * 3) % VOCAB
        outs = []
        for e in (eng, engine()):
            s = DecodeScheduler(e, clock=ManualClock(), registry=e.registry,
                                start_thread=False)
            r = s.submit(prompt, 4)
            _run(s, [r])
            outs.append(r.tokens)
        assert outs[0] == outs[1] and len(outs[0]) == 4

    def test_temperature_sampling_reproducible(self, sched):
        outs = []
        for _ in range(2):
            req = sched.submit([1, 2, 3], 6, temperature=0.8, seed=42)
            _run(sched, [req])
            outs.append(req.tokens)
        assert outs[0] == outs[1]
        assert all(0 <= t < VOCAB for t in outs[0])


class TestEngineAgainstReference:
    def test_greedy_tokens_equal_jax_engine(self, pair):
        """One fixed submit schedule (ragged prompts, one admitted
        mid-flight, one multi-chunk, one with EOS) through the JAX engine
        and the port's: the same tokens."""
        jnet, tnet = pair
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (3, 11, 6, 2, 9)]
        n_new = [5, 7, 3, 9, 6]
        eos = [None, None, None, int(generate(tnet, prompts[3], 9)[4]), None]

        def drive(engine_cls, sched_cls, reg_cls, clock_cls, net):
            reg = reg_cls()
            eng = engine_cls(net, max_batch=4, page_size=PS,
                             pages_per_seq=4, prefill_chunk=4, registry=reg)
            s = sched_cls(eng, clock=clock_cls(), registry=reg,
                          start_thread=False)
            reqs = [s.submit(p, n, eos_id=e)
                    for p, n, e in zip(prompts[:3], n_new[:3], eos[:3])]
            for _ in range(3):
                s.step_once()
            reqs += [s.submit(p, n, eos_id=e)
                     for p, n, e in zip(prompts[3:], n_new[3:], eos[3:])]
            _run(s, reqs)
            return [(r.tokens, r.finish_reason) for r in reqs]

        ref = drive(JPagedDecodeEngine, JDecodeScheduler, JRegistry,
                    JManualClock, jnet)
        got = drive(PagedDecodeEngine, DecodeScheduler, MetricsRegistry,
                    ManualClock, tnet)
        assert got == ref
        assert got[3][1] == "eos"


class TestSchedulerPolicy:
    def test_queue_full_sheds_with_reason(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg, max_queue=1)
        sched.submit([1, 2], 4)
        with pytest.raises(SchedulerSaturated):
            sched.submit([3, 4], 4)
        assert reg.get("serving_shed_total").value(
            reason="decode_queue_full") == 1

    def test_deadline_mid_decode_returns_partial(self, oracle_net):
        clock = ManualClock()
        sched = _scheduler(oracle_net, clock=clock)
        req = sched.submit([1, 2, 3], 50, timeout_s=5.0)
        for _ in range(4):
            sched.step_once()
        got = len(req.tokens)
        assert 0 < got < 50
        clock.advance(10.0)
        sched.step_once()
        assert req.finish_reason == "deadline" and len(req.tokens) == got
        assert sched.engine.arena.allocator.pages_in_use == 0

    def test_deadline_in_queue(self, oracle_net):
        clock = ManualClock()
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, max_batch=1, registry=reg,
                           clock=clock)
        hog = sched.submit([1], 60, timeout_s=120.0)
        sched.step_once()
        waiter = sched.submit([2], 4, timeout_s=5.0)
        clock.advance(10.0)
        sched.step_once()
        assert waiter.finish_reason == "deadline" and waiter.tokens == []
        assert not hog.done
        assert reg.get("decode_retired_total").value(reason="deadline") == 1

    def test_admission_waits_on_page_pressure(self, oracle_net):
        """a's 3-page reservation + b's 2 exceed a 4-page arena: one
        sequence at a time, b admitted after a retires, both exact."""
        sched = _scheduler(oracle_net, max_batch=2, num_pages=4,
                           prefill_chunk=8)
        a = sched.submit([1, 2, 3], 18)
        b = sched.submit([4, 5, 6], 8)
        sched.step_once()
        assert sched.active_count() == 1 and sched.queue_depth() == 1
        _run(sched, [a, b])
        assert a.tokens == generate(oracle_net, [1, 2, 3], 18).tolist()
        assert b.tokens == generate(oracle_net, [4, 5, 6], 8).tolist()

    def test_drain_finishes_in_flight_then_refuses(self, oracle_net):
        sched = _scheduler(oracle_net)
        req = sched.submit([1, 2], 6)
        sched.step_once()
        assert sched.drain(timeout=30.0)
        assert req.finish_reason == "max_tokens"
        with pytest.raises(SchedulerDraining):
            sched.submit([1], 2)

    def test_stop_fails_remaining_work(self, oracle_net):
        sched = _scheduler(oracle_net)
        running = sched.submit([1, 2], 50)
        sched.step_once()
        queued = None
        for _ in range(5):
            queued = sched.submit([3], 50)
        sched.stop()
        assert running.finish_reason == "shutdown"
        assert queued.finish_reason == "shutdown"
        assert running.retryable
        assert sched.engine.arena.allocator.pages_in_use == 0

    @pytest.mark.chaos
    def test_fault_at_decode_step(self, oracle_net):
        """A scripted fault at serving.decode_step fails the in-flight
        batch (finish_reason "error"), frees its pages and rebuilds the
        pools; the next request is clean and exact."""
        sched = _scheduler(oracle_net)
        eng = sched.engine
        victim = sched.submit([1, 2, 3], 6)
        plan = faults.FaultPlan().fail_at(
            "serving.decode_step", call=2,
            exc=RuntimeError("card fell over"))
        with plan.active():
            _run(sched, [victim])
            assert victim.finish_reason == "error"
            assert "card fell over" in victim.error
            assert eng.arena.allocator.pages_in_use == 0
            retry = sched.submit([1, 2, 3], 6)
            _run(sched, [retry])
        assert retry.tokens == generate(oracle_net, [1, 2, 3], 6).tolist()
        assert plan.triggered == [("serving.decode_step", 2)]

    @pytest.mark.chaos
    def test_failed_dispatch_rebuilds_pools(self, oracle_net, monkeypatch):
        """A dispatch that fails inside the forward leaves the pools
        rebuilt as zeros (same shapes); the next request decodes
        exactly."""
        sched = _scheduler(oracle_net)
        eng = sched.engine
        warm = sched.submit([5, 6, 7], 3)
        _run(sched, [warm])
        assert any(bool(p.abs().sum() > 0) for p in eng.arena.k_pools)
        shapes = [tuple(p.shape) for p in eng.arena.k_pools]

        def boom(*a, **k):
            raise RuntimeError("device fell over mid-dispatch")
        monkeypatch.setattr(T, "paged_decode_forward", boom)
        with pytest.raises(RuntimeError, match="mid-dispatch"):
            eng.run(np.zeros((1, 1), np.int32), np.full((1, 1), -1, np.int32),
                    np.zeros(1, np.int32),
                    np.full((1, eng.pages_per_seq), eng.arena.sentinel,
                            np.int32), rows=np.zeros(1, np.int64))
        monkeypatch.undo()
        assert [tuple(p.shape) for p in eng.arena.k_pools] == shapes
        assert all(bool(p.abs().sum() == 0) for p in eng.arena.k_pools)
        req = sched.submit([1, 2], 3)
        _run(sched, [req])
        assert req.tokens == generate(oracle_net, [1, 2], 3).tolist()

    def test_dispatch_keys_fixed_under_churn(self, oracle_net):
        """Admissions and retirements over many ticks dispatch only the
        power-of-two ladder of shapes — the port's counterpart of the
        reference's one-trace-per-bucket pin — and warmup covers it."""
        sched = _scheduler(oracle_net)
        eng = sched.engine
        eng.warmup()
        warmed = set(eng.dispatch_keys)
        ladder = {f"paged_decode[S{b}xT{t}xP4]"
                  for b in (1, 2, 4) for t in (1, 4)}
        assert warmed == ladder
        rng = np.random.default_rng(9)
        reqs = []
        for wave in range(3):
            reqs += [sched.submit(rng.integers(0, VOCAB, 1 + wave + i), 3 + i)
                     for i in range(3)]
            for _ in range(4):
                sched.step_once()
        _run(sched, reqs)
        assert set(eng.dispatch_keys) == ladder
        assert eng.dispatch_keys["paged_decode[S4xT1xP4]"] > 1

    def test_decode_metrics_populated(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg)
        req = sched.submit([1, 2, 3], 6)
        _run(sched, [req])
        assert reg.get("decode_admitted_total").value() == 1
        assert reg.get("decode_retired_total").value(
            reason="max_tokens") == 1
        assert reg.get("decode_tokens_total").value(phase="decode") == 5
        assert reg.get("decode_tokens_total").value(phase="prefill") == 3
        assert reg.get("decode_ttft_seconds").count() == 1
        # ticked: one dispatch and one host sync per tick
        n = reg.get("decode_dispatches_total").value(kind="paged")
        assert n == reg.get("decode_host_syncs_total").value() == 6
        counts = {s["labels"]["component"]: s["count"] for s in
                  reg.get("decode_host_tick_seconds").snapshot()["series"]}
        # the first tick prefills and decodes (two dispatches): 5 ticks
        assert counts["dispatch"] == 6 and counts["bookkeeping"] == 5
        assert set(req.ttft_breakdown) == {"queue_wait", "prefill",
                                           "compile", "dispatch"}
        text = reg.expose()
        for name in ("decode_batch_occupancy", "kv_pages_in_use",
                     "decode_retired_total", "decode_ttft_seconds",
                     "decode_host_syncs_total", "decode_dispatches_total"):
            assert name in text


class TestPageAllocator:
    def test_reserve_draw_free_invariants(self):
        a = PageAllocator(4, registry=MetricsRegistry())
        assert a.available() == 4
        assert a.reserve(3)
        assert not a.reserve(2)
        p1, p2 = a.draw(), a.draw()
        assert {p1, p2} <= {0, 1, 2, 3} and p1 != p2
        a.unreserve(1)
        with pytest.raises(RuntimeError):
            a.draw()
        a.free([p1, p2])
        assert a.pages_in_use == 0 and a.available() == 4
        with pytest.raises(ValueError):
            a.unreserve(1)

    def test_reuse_is_fifo(self):
        a = PageAllocator(2, registry=MetricsRegistry())
        assert a.reserve(2)
        first = a.draw()
        a.free([first])
        assert a.reserve(1)
        second, third = a.draw(), a.draw()
        assert third == first and second != first


class TestEngineValidation:
    def test_rejects_one_hot_input_net(self):
        net = ComputationGraph(transformer_lm(
            7, n_layers=1, d_model=16, n_heads=2, d_ff=32, max_cache_t=8),
            device="cpu").init()
        with pytest.raises(ValueError, match="input_ids"):
            PagedDecodeEngine(net, registry=MetricsRegistry())

    def test_rejects_strict_overflow_and_window_mismatch(self):
        strict = transformer_lm(VOCAB, n_layers=1, d_model=16, n_heads=2,
                                d_ff=32, input_ids=True, max_cache_t=32)
        for v in strict.vertices.values():
            layer = getattr(v, "layer", None)
            if layer is not None and hasattr(layer, "cache_overflow"):
                layer.cache_overflow = "strict"
        with pytest.raises(ValueError, match="strict"):
            PagedDecodeEngine(ComputationGraph(strict, device="cpu").init(),
                              page_size=8, pages_per_seq=4,
                              registry=MetricsRegistry())
        with pytest.raises(ValueError, match="window"):
            PagedDecodeEngine(_tnet(max_cache_t=32), page_size=8,
                              pages_per_seq=8, registry=MetricsRegistry())

    def test_pools_are_f32_on_the_nets_device_for_bf16_compute(self):
        conf = transformer_lm(VOCAB, n_layers=1, d_model=16, n_heads=2,
                              d_ff=32, input_ids=True, max_cache_t=32,
                              dtype="mixed_bf16")
        eng = PagedDecodeEngine(ComputationGraph(conf, device="cpu").init(),
                                page_size=8, pages_per_seq=4, max_batch=2,
                                registry=MetricsRegistry())
        pool = eng.arena.k_pools[0]
        assert pool.dtype == torch.float32 and pool.device.type == "cpu"
        # 8 pages, the zero page and the trash page
        assert tuple(pool.shape) == (10, 8, 2, 8)
        assert eng.arena.nbytes() == 2 * 10 * 8 * 16 * 4

    def test_swap_net_checks_topology_and_fence(self, oracle_net):
        sched = _scheduler(_tnet(seed=5))
        with pytest.raises(ValueError, match="topology"):
            sched.engine.swap_net(_tnet(n_layers=1))
        swapped = _tnet(seed=99)
        with sched.fence() as active:
            assert active == 0
            sched.engine.swap_net(swapped)
        req = sched.submit([1, 2, 3], 4)
        _run(sched, [req])
        assert req.tokens == generate(swapped, [1, 2, 3], 4).tolist()

    @pytest.mark.parametrize("draft_k", [0, 17, 40])
    def test_draft_k_out_of_range_is_refused(self, oracle_net, draft_k):
        """``draft_k`` must lie in [1, 16] and leave room for K+1 tokens
        in the window (32 here, so 40 fails both ways)."""
        with pytest.raises(ValueError, match="draft_k"):
            PagedDecodeEngine(oracle_net, draft_net=oracle_net,
                              draft_k=draft_k, page_size=8, pages_per_seq=4,
                              registry=MetricsRegistry())

    def test_draft_k_must_fit_the_window(self):
        net = _tnet(max_cache_t=8)
        with pytest.raises(ValueError, match="exceeds the window"):
            PagedDecodeEngine(net, draft_net=net, draft_k=8, page_size=4,
                              pages_per_seq=2, registry=MetricsRegistry())

    def test_draft_vocab_mismatch_is_refused(self, oracle_net):
        other = ComputationGraph(transformer_lm(
            VOCAB + 2, n_layers=1, d_model=16, n_heads=2, d_ff=32,
            input_ids=True, max_cache_t=32), device="cpu").init()
        with pytest.raises(ValueError, match="vocab"):
            PagedDecodeEngine(oracle_net, draft_net=other, page_size=8,
                              pages_per_seq=4, registry=MetricsRegistry())

    def test_draft_excludes_fused_blocks(self, oracle_net):
        with pytest.raises(ValueError, match="mutually exclusive"):
            PagedDecodeEngine(oracle_net, draft_net=oracle_net, block_len=4,
                              page_size=8, pages_per_seq=4,
                              registry=MetricsRegistry())

    @pytest.mark.parametrize("kv_dtype", ["fp8", "int4", "float16"])
    def test_kv_dtype_other_than_int8_is_refused(self, oracle_net, kv_dtype):
        with pytest.raises(ValueError, match="kv_dtype"):
            PagedDecodeEngine(oracle_net, kv_dtype=kv_dtype, page_size=8,
                              pages_per_seq=4, registry=MetricsRegistry())


# --------------------------------------------------------------------------
# the prefix cache
# --------------------------------------------------------------------------


_RNG = np.random.default_rng(21)
PROMPT16 = _RNG.integers(0, VOCAB, 16).astype(np.int32)


@pytest.fixture(scope="module")
def psched(oracle_net):
    """Prefix-cache scheduler shared by the parity tests (later tests hit
    the chains earlier ones seeded); every test leaves it drained."""
    return _scheduler(oracle_net, prefix_cache=True)


class TestPrefixHitParity:
    def test_miss_then_full_hit(self, oracle_net, psched):
        oracle = generate(oracle_net, PROMPT16, 6).tolist()
        first = psched.submit(PROMPT16, 6)
        _run(psched, [first])
        assert first.tokens == oracle and first.prefix_covered_tokens == 0
        assert psched.engine.arena.prefix_index.cached_pages == 2
        hit = psched.submit(PROMPT16, 6)
        _run(psched, [hit])
        assert hit.tokens == oracle
        assert hit.prefix_covered_tokens == 16
        hits = psched.registry.get("kv_prefix_hits_total")
        assert hits.value(result="full") >= 1
        assert hits.value(result="miss") >= 1
        assert psched.registry.get(
            "kv_prefix_hit_pages_total").value() >= 2

    def test_partial_hit(self, oracle_net, psched):
        prompt = np.concatenate([PROMPT16[:8],
                                 np.asarray([7, 3, 9, 1, 5], np.int32)])
        req = psched.submit(prompt, 5)
        _run(psched, [req])
        assert req.tokens == generate(oracle_net, prompt, 5).tolist()
        assert req.prefix_covered_tokens == 8
        assert psched.registry.get(
            "kv_prefix_hits_total").value(result="partial") >= 1

    def test_unaligned_tail_reprefills_from_page_boundary(self, oracle_net,
                                                          psched):
        prompt = PROMPT16[:11]
        oracle = generate(oracle_net, prompt, 4).tolist()
        r1 = psched.submit(prompt, 4)
        _run(psched, [r1])
        r2 = psched.submit(prompt, 4)
        _run(psched, [r2])
        assert r1.tokens == r2.tokens == oracle
        assert r2.prefix_covered_tokens == 8

    def test_short_prompt_never_registers(self, oracle_net, psched):
        idx = psched.engine.arena.prefix_index
        before = idx.cached_pages
        prompt = np.asarray([2, 4, 6], np.int32)
        oracle = generate(oracle_net, prompt, 4).tolist()
        for _ in range(2):
            r = psched.submit(prompt, 4)
            _run(psched, [r])
            assert r.tokens == oracle and r.prefix_covered_tokens == 0
        assert idx.cached_pages == before

    def test_concurrent_hit_lanes_share_pages(self, oracle_net, psched):
        oracle = generate(oracle_net, PROMPT16, 8).tolist()
        reqs = [psched.submit(PROMPT16, 8) for _ in range(2)]
        for _ in range(3):
            psched.step_once()
        alloc = psched.engine.arena.allocator
        assert not any(r.done for r in reqs)
        assert alloc.shared_pages >= 2
        assert all(alloc.refcount(p) == 3 for p in
                   psched.engine.arena.prefix_index.lookup(PROMPT16, 4))
        _run(psched, reqs)
        assert all(r.tokens == oracle for r in reqs)
        assert alloc.shared_pages == 0

    def test_sliding_prompt_never_registers(self, psched):
        idx = psched.engine.arena.prefix_index
        before = idx.cached_pages
        prompt = _RNG.integers(0, VOCAB, 40).astype(np.int32)  # > window
        req = psched.submit(prompt, 3)
        _run(psched, [req])
        assert req.finish_reason == "max_tokens"
        assert idx.cached_pages == before


class TestPrefixAccounting:
    @pytest.fixture()
    def warm(self, oracle_net):
        sched = _scheduler(oracle_net, prefix_cache=True)
        _run(sched, [sched.submit(PROMPT16, 2)])
        return sched

    def test_hit_reserves_only_uncovered_pages(self, warm):
        eng = warm.engine
        alloc = eng.arena.allocator
        lane = eng.acquire_lane(22, prompt=PROMPT16)
        assert int(eng._covered[lane]) == 16
        assert alloc.reserved == 1 and alloc.shared_pages == 2
        assert int(eng._pos[lane]) == 15       # re-feeds the last token
        eng.release_lane(lane)
        assert alloc.reserved == 0 and alloc.shared_pages == 0

    def test_window_overflow_hit_reserves_full_quota(self, warm):
        eng = warm.engine
        lane = eng.acquire_lane(56, prompt=PROMPT16)
        assert int(eng._covered[lane]) == 16
        assert eng.arena.allocator.reserved == eng.pages_per_seq
        eng.release_lane(lane)
        assert eng.arena.allocator.reserved == 0

    def test_admit_is_atomic(self):
        a = PageAllocator(2, registry=MetricsRegistry())
        assert a.reserve(2)
        p0, p1 = a.draw(), a.draw()
        assert not a.admit(1, [p0])
        assert a.refcount(p0) == 1
        assert not a.admit(0, [p0, 999])
        assert a.refcount(p0) == 1
        assert a.admit(0, [p0]) and a.refcount(p0) == 2
        a.free([p0, p0, p1])
        assert a.pages_in_use == 0

    def test_full_cover_admit_fails_when_pin_breaks_invariant(self):
        a = PageAllocator(2, registry=MetricsRegistry())
        idx = PrefixIndex(a, page_size=2)
        assert a.reserve(2)
        pages = [a.draw(), a.draw()]
        idx.register([1, 2, 3, 4], pages)
        a.free(pages)
        assert idx.reclaimable == 2
        assert a.reserve(2)
        assert not a.admit(0, pages)
        assert all(a.refcount(p) == 1 for p in pages)
        assert idx.reclaimable == 2

    def test_shared_page_eviction_refused_until_last_ref_drops(self):
        a = PageAllocator(2, registry=MetricsRegistry())
        idx = PrefixIndex(a, page_size=2)
        assert a.reserve(1)
        p0 = a.draw()
        idx.register([5, 6], [p0])
        assert a.refcount(p0) == 2
        assert a.reserve(1)
        p1 = a.draw()
        assert not a.reserve(1)
        a.free([p0])
        assert a.reserve(1)
        p2 = a.draw()
        assert p2 == p0 and idx.cached_pages == 0
        a.free([p1, p2])

    def test_reclaim_is_lru_over_chains(self):
        a = PageAllocator(4, registry=MetricsRegistry())
        idx = PrefixIndex(a, page_size=2)
        assert a.reserve(4)
        pa = [a.draw(), a.draw()]
        pb = [a.draw(), a.draw()]
        idx.register([1, 2, 3, 4], pa)
        idx.register([5, 6, 7, 8], pb)
        a.free(pa + pb)
        idx.lookup([1, 2, 3, 4], 4)
        assert a.reserve(2)
        drawn = {a.draw(), a.draw()}
        assert drawn == set(pb)
        assert idx.cached_pages == 2
        assert idx.lookup([1, 2, 3, 4], 4) == pa
        a.free(list(drawn))


class TestPrefixChurnAndStaleness:
    @pytest.mark.chaos
    def test_churn_leaks_no_page(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, prefix_cache=True, registry=reg)
        alloc = sched.engine.arena.allocator
        idx = sched.engine.arena.prefix_index
        rng = np.random.default_rng(3)
        bases = [rng.integers(0, VOCAB, 16).astype(np.int32)
                 for _ in range(3)]
        reqs = []
        for wave in range(6):
            for _ in range(3):
                kind = rng.integers(0, 3)
                if kind == 0:
                    prompt = bases[rng.integers(0, 3)]
                elif kind == 1:
                    prompt = np.concatenate(
                        [bases[rng.integers(0, 3)][:8],
                         rng.integers(0, VOCAB, 5).astype(np.int32)])
                else:
                    prompt = rng.integers(0, VOCAB, 1 + int(
                        rng.integers(0, 16))).astype(np.int32)
                reqs.append(sched.submit(prompt, int(rng.choice([2, 5, 24]))))
            for _ in range(4):
                sched.step_once()
                with alloc._lock:
                    assert alloc._reserved <= (len(alloc._free)
                                               + idx.reclaimable)
        _run(sched, reqs)
        assert all(r.finish_reason == "max_tokens" for r in reqs)
        assert alloc.reserved == 0 and alloc.shared_pages == 0
        assert alloc.pages_in_use == idx.cached_pages
        with alloc._lock:
            for e in idx._entries.values():
                assert alloc._refcount[e.page] == 1
                assert idx._bypage[e.page] == e.key
        assert reg.get("kv_pages_cow_total").value() >= 1
        idx.flush()
        assert alloc.pages_in_use == 0
        assert alloc.available() == alloc.num_pages

    def test_cow_overflow_equals_uncached_engine(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, prefix_cache=True, registry=reg)
        plain = _scheduler(oracle_net)
        _run(sched, [sched.submit(PROMPT16, 2)])
        cow0 = reg.get("kv_pages_cow_total").value()
        hit = sched.submit(PROMPT16, 24)        # 16 + 24 > window
        _run(sched, [hit])
        ref = plain.submit(PROMPT16, 24)
        _run(plain, [ref])
        assert hit.prefix_covered_tokens == 16
        assert hit.tokens == ref.tokens
        assert reg.get("kv_pages_cow_total").value() > cow0
        assert sched.engine.arena.prefix_index.cached_pages == 2
        rehit = sched.submit(PROMPT16, 2)
        _run(sched, [rehit])
        assert rehit.prefix_covered_tokens == 16
        assert rehit.tokens == ref.tokens[:2]

    def test_reclaim_under_page_pressure(self, oracle_net):
        sched = _scheduler(oracle_net, prefix_cache=True, num_pages=8)
        idx = sched.engine.arena.prefix_index
        seeds = [_RNG.integers(0, VOCAB, 16).astype(np.int32)
                 for _ in range(2)]
        for p in seeds:
            _run(sched, [sched.submit(p, 2)])
        assert idx.cached_pages == 4
        prompts = [_RNG.integers(0, VOCAB, 8).astype(np.int32)
                   for _ in range(2)]
        reqs = [sched.submit(p, 24) for p in prompts]
        _run(sched, reqs)
        for p, r in zip(prompts, reqs):
            assert r.tokens == generate(oracle_net, p, 24).tolist()
        assert idx.cached_pages < 4

    @pytest.mark.chaos
    def test_failed_dispatch_flushes_index(self, oracle_net, monkeypatch):
        sched = _scheduler(oracle_net, prefix_cache=True)
        eng = sched.engine
        _run(sched, [sched.submit(PROMPT16, 2)])
        assert eng.arena.prefix_index.cached_pages == 2

        def boom(*a, **k):
            raise RuntimeError("device fell over mid-dispatch")
        monkeypatch.setattr(T, "paged_decode_forward", boom)
        with pytest.raises(RuntimeError, match="mid-dispatch"):
            eng.run(np.zeros((2, 1), np.int32), np.full((2, 1), -1, np.int32),
                    np.zeros(2, np.int32),
                    np.full((2, eng.pages_per_seq), eng.arena.sentinel,
                            np.int32), rows=np.zeros(2, np.int64))
        monkeypatch.undo()
        assert eng.arena.prefix_index.cached_pages == 0
        assert eng.arena.allocator.pages_in_use == 0
        retry = sched.submit(PROMPT16, 2)
        _run(sched, [retry])
        assert retry.prefix_covered_tokens == 0
        assert retry.tokens == generate(oracle_net, PROMPT16, 2).tolist()

    def test_swap_net_flushes_index(self, oracle_net):
        sched = _scheduler(oracle_net, prefix_cache=True)
        _run(sched, [sched.submit(PROMPT16, 2)])
        assert sched.engine.arena.prefix_index.cached_pages == 2
        net2 = _tnet(seed=7)
        sched.engine.swap_net(net2)
        assert sched.engine.arena.prefix_index.cached_pages == 0
        req = sched.submit(PROMPT16, 4)
        _run(sched, [req])
        assert req.prefix_covered_tokens == 0
        assert req.tokens == generate(net2, PROMPT16, 4).tolist()


# --------------------------------------------------------------------------
# POST /generate
# --------------------------------------------------------------------------


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_error(base, path, payload):
    try:
        _post(base, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)
    raise AssertionError("the request did not fail")


def _decode_server(net, **kw):
    cfg = {"max_batch": 4, "page_size": PS, "pages_per_seq": 4,
           "prefill_chunk": 4}
    cfg.update(kw)
    return InferenceServer(net, port=0, decode=cfg, device="cpu")


class TestGenerateHTTP:
    @pytest.fixture(scope="class")
    def server(self, oracle_net):
        server = _decode_server(oracle_net)
        yield server
        server.stop(drain=False)

    def test_generate_equals_oracle_and_healthz(self, oracle_net, server):
        base = f"http://127.0.0.1:{server.port}"
        out = _post(base, "/generate", {"prompt_ids": [1, 2, 3, 4],
                                        "max_new_tokens": 6})
        assert out["tokens"] == generate(oracle_net, [1, 2, 3, 4],
                                         6).tolist()
        assert out["finish_reason"] == "max_tokens"
        assert out["n_generated"] == 6 and out["ttft_ms"] >= 0
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=5).read())
        assert health["decode"]["active"] == 0
        assert health["decode"]["queued"] == 0
        pane = health["decode"]["prefix_cache"]    # on by default
        assert pane["misses"] >= 1 and pane["cached_pages"] == 0
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=5).read().decode()
        for name in ("decode_batch_occupancy", "kv_pages_in_use",
                     "decode_goodput_tokens_total"):
            assert name in metrics

    def test_sampled_generate_reproducible(self, server):
        base = f"http://127.0.0.1:{server.port}"
        body = {"prompt_ids": [3, 1, 4], "max_new_tokens": 5,
                "temperature": 0.9, "top_k": 5, "top_p": 0.9, "seed": 7}
        assert _post(base, "/generate", body)["tokens"] == \
            _post(base, "/generate", body)["tokens"]

    def test_concurrent_generates_are_batched(self, oracle_net, server):
        base = f"http://127.0.0.1:{server.port}"
        occ = server.registry.get("decode_batch_occupancy")
        sum0, count0 = occ.sum(), occ.count()
        prompts = [[i + 1, i + 2] for i in range(4)]
        results = [None] * 4

        def call(i):
            results[i] = _post(base, "/generate",
                               {"prompt_ids": prompts[i],
                                "max_new_tokens": 20 + i})
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(4):
            assert results[i]["tokens"] == generate(
                oracle_net, prompts[i], 20 + i).tolist()
        # the four sequences shared decode steps: more than one lane per
        # step on average
        assert (occ.sum() - sum0) / (occ.count() - count0) > 1.0

    @pytest.mark.parametrize("payload,want", [
        ({"max_new_tokens": 3}, "prompt_ids"),
        ({"prompt_ids": []}, "empty prompt"),
        ({"prompt_ids": [1, 99]}, "outside"),
        ({"prompt_ids": [1], "max_new_tokens": 0}, "max_new_tokens"),
        ({"prompt_ids": [1], "top_p": 0.0}, "top_p"),
        ({"prompt_ids": [1], "top_k": -2}, "top_k"),
        ({"prompt_ids": [1], "timeout_s": "soon"}, "timeout_s"),
        ({"prompt_ids": [1], "temperature": "hot"}, "bad request"),
    ])
    def test_bad_parameters_answer_400(self, server, payload, want):
        code, body, _ = _post_error(f"http://127.0.0.1:{server.port}",
                                    "/generate", payload)
        assert code == 400 and want in body["error"]

    def test_timelines_and_fleet_start_up_not_yet_ported(self, oracle_net,
                                                         server):
        """Request timelines (/debug/timeline) answer with the server's
        request spans, and the fleet's background warm-up starts a server
        that reports ready=false (warming) until its ladder is built.
        (The name dates from when both were stubs.)"""
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/debug/timeline",
            timeout=5).read())
        assert set(body) == {"requests", "traces"}
        warm = InferenceServer(oracle_net, port=0, device="cpu",
                               decode={"max_batch": 2, "page_size": PS,
                                       "pages_per_seq": 4,
                                       "prefill_chunk": 4},
                               warmup_background=True)
        try:
            deadline = time.monotonic() + 60
            while not warm.ready and time.monotonic() < deadline:
                assert warm.readiness_reasons() == ["warming"]
                time.sleep(0.01)
            assert warm.ready
        finally:
            warm.stop(drain=False)

    def test_without_decode_generate_is_400(self, oracle_net):
        server = InferenceServer(oracle_net, port=0, device="cpu")
        try:
            code, body, _ = _post_error(f"http://127.0.0.1:{server.port}",
                                        "/generate", {"prompt_ids": [1]})
            assert code == 400 and "decode=" in body["error"]
        finally:
            server.stop(drain=False)

    @pytest.mark.chaos
    def test_queue_full_answers_503_with_retry_after(self, oracle_net):
        # a threadless scheduler never drains its queue
        engine = PagedDecodeEngine(oracle_net, max_batch=1, page_size=PS,
                                   pages_per_seq=4, registry=MetricsRegistry())
        sched = DecodeScheduler(engine, max_queue=1, start_thread=False,
                                registry=engine.registry)
        sched.submit([1], 2)
        server = InferenceServer(oracle_net, port=0, device="cpu",
                                 decode=sched)
        try:
            code, body, headers = _post_error(
                f"http://127.0.0.1:{server.port}", "/generate",
                {"prompt_ids": [1]})
            assert code == 503 and "Retry-After" in headers
        finally:
            server.stop(drain=False)

    @pytest.mark.chaos
    def test_failed_decode_answers_500_retryable(self, oracle_net):
        server = _decode_server(oracle_net)
        base = f"http://127.0.0.1:{server.port}"
        plan = faults.FaultPlan().fail_at(
            "serving.decode_step", call=2, exc=RuntimeError("card fell over"))
        try:
            with plan.active():
                code, body, _ = _post_error(base, "/generate",
                                            {"prompt_ids": [1, 2],
                                             "max_new_tokens": 5})
            assert code == 500 and body["retryable"] is True
            assert body["n_generated"] == len(body["tokens"]) == 1
        finally:
            server.stop(drain=False)

    @pytest.mark.chaos
    def test_short_deadline_answers_504(self, oracle_net):
        server = _decode_server(oracle_net)
        try:
            code, body, _ = _post_error(
                f"http://127.0.0.1:{server.port}", "/generate",
                {"prompt_ids": [1, 2], "max_new_tokens": 5,
                 "timeout_s": 0.0})
            assert code == 504 and "deadline" in body["error"]
        finally:
            server.stop(drain=False)

    @pytest.mark.chaos
    def test_drain_waits_for_in_flight_decode_and_swap_is_fenced(
            self, oracle_net):
        server = _decode_server(oracle_net)
        base = f"http://127.0.0.1:{server.port}"
        done = {}

        def long_call():
            done["r"] = _post(base, "/generate",
                              {"prompt_ids": [1], "max_new_tokens": 600,
                               "timeout_s": 120})
        t = threading.Thread(target=long_call)
        t.start()
        try:
            for _ in range(2000):
                if server.decode.active_count() > 0:
                    break
                threading.Event().wait(0.005)
            assert server.decode.active_count() == 1
            with pytest.raises(ModelSwapRefused, match="in flight"):
                server.set_model(_tnet(seed=99))
            assert server.drain(timeout=120)
            t.join(timeout=60)
            assert done["r"]["finish_reason"] == "max_tokens"
            assert len(done["r"]["tokens"]) == 600
            assert server.decode.active_count() == 0
            server.set_model(_tnet(seed=99))
            code, _, _ = _post_error(base, "/generate", {"prompt_ids": [1]})
            assert code == 503
        finally:
            t.join(timeout=10)
            server.stop(drain=False)
