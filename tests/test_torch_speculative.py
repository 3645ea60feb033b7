"""The port's speculative decoding against the JAX package's, on the CPU.

1. **The device halves**: ``draft_decode_loop`` and ``spec_verify`` against
   the reference's on the same loaded weights, the same prefilled pools
   and the same uniforms, for a greedy lane beside a sampled one:
   draft tokens and accepts equal exactly, the drafts' filtered
   distributions within 1e-6 (f32 log/exp/cumsum of two libraries: a few
   ulps), the emitted tokens and their validity equal.
2. **The engine**: the reference's ``TestSpeculative`` cases
   (``tests/test_fused_decode.py``): greedy speculative output equals
   target-only decode, a perfect draft (the target itself) accepts
   everything, the acceptance counter accounts every chanced draft, EOS
   inside the accepted prefix, sampled output reproducible (and equal to
   the JAX engine's), exact up to the window edge, past the window by
   page eviction, the pools-only draft arena; and the chaos case: a
   fault mid-block zeroes both arenas in place.

The fixture models are the reference tests' (target: VOCAB 11, d_model
16, 2 heads, d_ff 32, 2 layers, max_cache_t 32; draft:
``draft_transformer_lm(11, d_model=16, n_heads=2, d_ff=32, seed=123)``),
built by the JAX package, saved and loaded into the port; engines of
8-token pages, 4 pages per lane, prefill chunks of 4, ``draft_k`` 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as j_T
from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.serving.decode import \
    DecodeScheduler as JDecodeScheduler
from deeplearning4j_tpu.serving.decode import \
    PagedDecodeEngine as JPagedDecodeEngine
from deeplearning4j_tpu.serving.kv_cache import PagedKVArena as JArena
from deeplearning4j_tpu.util.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu.util.resilience import ManualClock as JManualClock
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.transformer import generate
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.serving.kv_cache import PagedKVArena
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model

VOCAB = 11
K = 3
DIST_TOL = 1e-6


def _save_load(jnet, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name) / "ref.zip")
    j_save_model(jnet, path)
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def target_pair(tmp_path_factory):
    jnet = JComputationGraph(j_transformer_lm(
        VOCAB, n_layers=2, d_model=16, n_heads=2, d_ff=32, seed=5,
        input_ids=True, max_cache_t=32)).init()
    return jnet, _save_load(jnet, tmp_path_factory, "target")


@pytest.fixture(scope="module")
def draft_pair(tmp_path_factory):
    jnet = JComputationGraph(j_T.draft_transformer_lm(
        VOCAB, d_model=16, n_heads=2, d_ff=32, seed=123,
        max_cache_t=32)).init()
    return jnet, _save_load(jnet, tmp_path_factory, "draft")


@pytest.fixture(scope="module")
def oracle_net(target_pair):
    return target_pair[1]


@pytest.fixture(scope="module")
def draft_net(draft_pair):
    return draft_pair[1]


def _scheduler(net, *, max_batch=4, page_size=8, pages_per_seq=4,
               prefill_chunk=4, registry=None, **engine_kw):
    registry = registry or MetricsRegistry()
    engine = PagedDecodeEngine(net, max_batch=max_batch, page_size=page_size,
                               pages_per_seq=pages_per_seq,
                               prefill_chunk=prefill_chunk,
                               registry=registry, **engine_kw)
    return DecodeScheduler(engine, clock=ManualClock(), registry=registry,
                           start_thread=False)


def _run(sched, reqs, limit=500):
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        sched.step_once()
        steps += 1
    assert all(r.done for r in reqs), [r.finish_reason for r in reqs]
    return steps


@pytest.fixture(scope="module")
def spec_sched(oracle_net, draft_net):
    return _scheduler(oracle_net, draft_net=draft_net, draft_k=K)


# --------------------------------------------------------------------------
# the device halves against the reference
# --------------------------------------------------------------------------

# two lanes of 4 pages: lane 0 greedy, lane 1 sampled (T 0.8, top_k 5,
# top_p 0.9); lane 1's write budget (2) stops short of the block
TABLES = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
PROMPT = np.random.default_rng(3).integers(0, VOCAB, (2, 6)).astype(np.int32)
LAST = np.array([4, 9], np.int32)
REL = np.array([6, 6], np.int32)
ACTIVE = np.array([True, True])
BUDGET = np.array([K + 1, 2], np.int32)


def _sampling(sampled):
    temps = np.array([0.0, 0.8 if sampled else 0.0], np.float32)
    return temps, np.array([0, 5], np.int32), np.array([1.0, 0.9],
                                                       np.float32)


def _prefilled(jnet, tnet):
    """Both packages' pools over 8 pages holding PROMPT at slots 0..5."""
    dims = {}
    for name in T.attention_vertices(tnet):
        layer = tnet.conf.vertices[name].layer
        dims[name] = (layer.n_heads, layer.n_in // layer.n_heads)
    ja = JArena(dims, num_pages=8, page_size=8, with_allocator=False)
    ta = PagedKVArena(dims, num_pages=8, page_size=8, with_allocator=False)
    slots = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    _, jk, jv = j_T.paged_decode_forward(
        jnet, jnet.params, ja.k_pools, ja.v_pools, jnp.asarray(PROMPT),
        jnp.asarray(TABLES), jnp.asarray(slots), jnp.zeros(2, jnp.int32))
    with torch.inference_mode():
        T.paged_decode_forward(
            tnet, tnet.params, ta.k_pools, ta.v_pools,
            torch.from_numpy(PROMPT), torch.from_numpy(TABLES),
            torch.from_numpy(slots), torch.zeros(2, dtype=torch.int32))
    return list(jk), list(jv), ta


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _uniforms(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


class TestDeviceHalvesAgainstReference:
    @pytest.mark.parametrize("sampled", [False, True])
    def test_draft_decode_loop(self, draft_pair, sampled):
        jnet, tnet = draft_pair
        jk, jv, ta = _prefilled(jnet, tnet)
        temps, tk, tp = _sampling(sampled)
        u = _uniforms(7, (2, K + 1))
        j_toks, j_dists, _, _ = j_T.draft_decode_loop(
            jnet, jnet.params, jk, jv, _j(LAST), _j(TABLES), _j(REL),
            _j(ACTIVE), _j(BUDGET), _j(temps), _j(tk), _j(tp), _j(u))
        with torch.inference_mode():
            toks, dists, _, _ = T.draft_decode_loop(
                tnet, tnet.params, ta.k_pools, ta.v_pools, _t(LAST),
                _t(TABLES), _t(REL), _t(ACTIVE), _t(BUDGET), _t(temps),
                _t(tk), _t(tp), _t(u), any_sampled=sampled)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
        assert dists.shape == (2, K, VOCAB)
        np.testing.assert_allclose(dists.numpy(), np.asarray(j_dists),
                                   atol=DIST_TOL, rtol=0)

    @pytest.mark.parametrize("sampled", [False, True])
    def test_spec_verify(self, target_pair, draft_pair, sampled):
        """The same drafts (the reference draft's tokens and
        distributions) through both verifies."""
        jd, _ = draft_pair
        jdk, jdv, _ = _prefilled(jd, draft_pair[1])
        temps, tk, tp = _sampling(sampled)
        d_toks, d_dists, _, _ = j_T.draft_decode_loop(
            jd, jd.params, jdk, jdv, _j(LAST), _j(TABLES), _j(REL),
            _j(ACTIVE), _j(BUDGET), _j(temps), _j(tk), _j(tp),
            _j(_uniforms(7, (2, K + 1))))
        d_toks, d_dists = np.asarray(d_toks), np.asarray(d_dists)
        jnet, tnet = target_pair
        jk, jv, ta = _prefilled(jnet, tnet)
        ua, uf = _uniforms(8, (2, K)), _uniforms(9, (2, K + 1))
        j_em, j_valid, j_acc, _, _ = j_T.spec_verify(
            jnet, jnet.params, jk, jv, _j(LAST), _j(TABLES), _j(REL),
            _j(ACTIVE), _j(BUDGET), _j(d_toks), _j(d_dists), _j(temps),
            _j(tk), _j(tp), _j(ua), _j(uf))
        with torch.inference_mode():
            em, valid, acc, _, _ = T.spec_verify(
                tnet, tnet.params, ta.k_pools, ta.v_pools, _t(LAST),
                _t(TABLES), _t(REL), _t(ACTIVE), _t(BUDGET), _t(d_toks),
                _t(d_dists), _t(temps), _t(tk), _t(tp), _t(ua), _t(uf),
                any_sampled=sampled)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
        np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))

    def test_budget_drops_writes_past_it(self, draft_pair):
        """Lane 0 may emit K + 1 = 4 tokens: slots 6..9, across its first
        two pages. Lane 1 may emit 2: slots 6 and 7, and nothing past
        them."""
        jnet, tnet = draft_pair
        _, _, ta = _prefilled(jnet, tnet)
        before = [p.clone() for p in ta.k_pools]
        temps, tk, tp = _sampling(False)
        with torch.inference_mode():
            T.draft_decode_loop(
                tnet, tnet.params, ta.k_pools, ta.v_pools, _t(LAST),
                _t(TABLES), _t(REL), _t(ACTIVE), _t(BUDGET), _t(temps),
                _t(tk), _t(tp), _t(_uniforms(7, (2, K + 1))),
                any_sampled=False)
        for old, new in zip(before, ta.k_pools):
            changed = (old != new).flatten(2).any(-1)      # [rows, slots]
            assert changed[0, 6:].all() and not changed[0, :6].any()
            assert changed[1, :2].all() and not changed[1, 2:].any()
            assert changed[4, 6:].all() and not changed[4, :6].any()
            # pages 2, 3, 5..7 and the sentinel (8) untouched; the
            # dropped writes went to the trash page (9)
            assert not changed[2:4].any() and not changed[5:9].any()


# --------------------------------------------------------------------------
# the engine (the reference's TestSpeculative)
# --------------------------------------------------------------------------


class TestSpeculative:
    def test_spec_greedy_equals_target_only(self, oracle_net, spec_sched):
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (3, 6, 2)]
        n_new = [5, 8, 3]
        oracle = [generate(oracle_net, p, n).tolist()
                  for p, n in zip(prompts, n_new)]
        reqs = [spec_sched.submit(p, n) for p, n in zip(prompts, n_new)]
        _run(spec_sched, reqs)
        for o, r in zip(oracle, reqs):
            assert r.tokens == o
        assert spec_sched.engine.arena.allocator.pages_in_use == 0

    def test_perfect_draft_accepts_everything(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg, draft_net=oracle_net,
                           draft_k=K)
        req = sched.submit([1, 2, 3], 8)
        _run(sched, [req])
        assert req.tokens == generate(oracle_net, [1, 2, 3], 8).tolist()
        acc = reg.get("decode_draft_tokens_total").value(result="accepted")
        rej = reg.get("decode_draft_tokens_total").value(result="rejected")
        assert acc > 0 and rej == 0

    def test_acceptance_rate_sanity(self, oracle_net, spec_sched):
        reg = spec_sched.registry
        acc0 = reg.get("decode_draft_tokens_total").value(result="accepted")
        rej0 = reg.get("decode_draft_tokens_total").value(result="rejected")
        blk0 = reg.get("decode_dispatches_total").value(kind="verify")
        req = spec_sched.submit([4, 5, 6], 9)
        _run(spec_sched, [req])
        assert req.tokens == generate(oracle_net, [4, 5, 6], 9).tolist()
        acc = reg.get("decode_draft_tokens_total").value(
            result="accepted") - acc0
        rej = reg.get("decode_draft_tokens_total").value(
            result="rejected") - rej0
        blocks = reg.get("decode_dispatches_total").value(
            kind="verify") - blk0
        drafted = acc + rej
        assert 0 < drafted <= blocks * K
        assert 0.0 <= acc / drafted < 1.0

    def test_two_dispatches_one_sync_per_block(self, oracle_net, draft_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg, draft_net=draft_net,
                           draft_k=K)
        _run(sched, [sched.submit([1, 2, 3, 4], 9)])
        d = reg.get("decode_dispatches_total")
        blocks = d.value(kind="verify")
        assert blocks > 0 and d.value(kind="draft") == blocks
        assert d.value(kind="draft_prefill") == d.value(kind="paged") == 1
        # one sync per prefill chunk, one per block
        assert reg.get("decode_host_syncs_total").value() == blocks + 1

    def test_spec_eos_stops_inside_accepted_prefix(self, oracle_net,
                                                   spec_sched):
        rng = np.random.default_rng(4)
        prompt = rng.integers(0, VOCAB, 4)
        free_run = generate(oracle_net, prompt, 8)
        eos = int(free_run[2])
        oracle = generate(oracle_net, prompt, 8, eos_id=eos)
        req = spec_sched.submit(prompt, 8, eos_id=eos)
        _run(spec_sched, [req])
        assert req.tokens == oracle.tolist()
        assert req.finish_reason == "eos"

    def test_spec_sampled_reproducible(self, spec_sched):
        outs = []
        for _ in range(2):
            req = spec_sched.submit([2, 3], 6, temperature=0.7, seed=11,
                                    top_k=8)
            _run(spec_sched, [req])
            outs.append(req.tokens)
        assert outs[0] == outs[1]
        assert all(0 <= t < VOCAB for t in outs[0])

    def test_spec_sampled_equals_jax_engine(self, target_pair, draft_pair):
        """Sampled and greedy lanes in one batch: the same tokens as the
        JAX package's speculative engine (the uniforms come from each
        request's seeded generator in the same order)."""
        jreg = JRegistry()
        jeng = JPagedDecodeEngine(target_pair[0], max_batch=4, page_size=8,
                                  pages_per_seq=4, prefill_chunk=4,
                                  registry=jreg, draft_net=draft_pair[0],
                                  draft_k=K)
        jsched = JDecodeScheduler(jeng, clock=JManualClock(), registry=jreg,
                                  start_thread=False)
        sched = _scheduler(target_pair[1], draft_net=draft_pair[1],
                           draft_k=K)
        out = []
        for s in (jsched, sched):
            reqs = [s.submit([2, 3], 10, temperature=0.7, seed=11, top_k=8),
                    s.submit([5, 1, 4], 10),
                    s.submit([7], 10, temperature=1.2, seed=3, top_p=0.8)]
            _run(s, reqs)
            out.append([r.tokens for r in reqs])
        assert out[0] == out[1]

    def test_spec_bitexact_up_to_window_edge(self, tmp_path_factory):
        jnet = JComputationGraph(j_transformer_lm(
            VOCAB, n_layers=1, d_model=16, n_heads=2, d_ff=32, seed=5,
            input_ids=True, max_cache_t=16)).init()
        jdraft = JComputationGraph(j_T.draft_transformer_lm(
            VOCAB, d_model=16, n_heads=2, d_ff=32, seed=123,
            max_cache_t=16)).init()
        net = _save_load(jnet, tmp_path_factory, "edge_t")
        draft = _save_load(jdraft, tmp_path_factory, "edge_d")
        sched = _scheduler(net, max_batch=2, page_size=8, pages_per_seq=2,
                           prefill_chunk=8, draft_net=draft, draft_k=K)
        prompt = np.arange(4) % VOCAB
        req = sched.submit(prompt, 12)          # 4 + 12 = 16 = window
        _run(sched, [req])
        assert req.tokens == generate(net, prompt, 12).tolist()
        assert sched.registry.get("kv_pages_evicted_total").value() == 0
        # past the window the spec path slides by page eviction
        req = sched.submit(np.arange(5) % VOCAB, 30)
        _run(sched, [req])
        assert len(req.tokens) == 30
        assert sched.engine.arena.allocator.pages_in_use == 0
        assert sched.registry.get("kv_pages_evicted_total").value() > 0

    def test_draft_arena_is_pools_only(self, spec_sched):
        eng = spec_sched.engine
        assert eng.draft_arena.allocator is None
        assert eng.draft_arena.prefix_index is None
        assert len(eng.draft_arena.k_pools) == 2   # the draft has 2 layers

    def test_draft_transformer_lm_matches_reference_config(self):
        conf = T.draft_transformer_lm(VOCAB, d_model=16, n_heads=2, d_ff=32,
                                      seed=123, max_cache_t=32)
        jconf = j_T.draft_transformer_lm(VOCAB, d_model=16, n_heads=2,
                                         d_ff=32, seed=123, max_cache_t=32)
        import json
        assert json.loads(conf.to_json()) == json.loads(jconf.to_json())


class TestChaos:
    @pytest.mark.chaos
    def test_fault_mid_spec_block_resets_both_arenas(self, oracle_net,
                                                     draft_net):
        sched = _scheduler(oracle_net, draft_net=draft_net, draft_k=K)
        eng = sched.engine
        pools = eng.arena.k_pools + eng.draft_arena.k_pools
        ptrs = [p.data_ptr() for p in pools]
        victim = sched.submit([1, 2, 3], 6)
        plan = faults.FaultPlan().fail_at(
            "serving.decode_step", call=2,
            exc=RuntimeError("card fell over"))
        with plan.active():
            _run(sched, [victim])
            assert victim.finish_reason == "error"
            assert eng.arena.allocator.pages_in_use == 0
            retry = sched.submit([1, 2, 3], 6)
            _run(sched, [retry])
        assert retry.tokens == generate(oracle_net, [1, 2, 3], 6).tolist()
        assert plan.triggered == [("serving.decode_step", 2)]
        assert [p.data_ptr() for p in pools] == ptrs

    @pytest.mark.chaos
    def test_failure_inside_the_verify_zeroes_both_arenas(self, oracle_net,
                                                          draft_net,
                                                          monkeypatch):
        sched = _scheduler(oracle_net, draft_net=draft_net, draft_k=K)
        eng = sched.engine
        _run(sched, [sched.submit([3, 3, 3], 5)])

        def boom(*a, **k):
            raise RuntimeError("device fell over mid-verify")
        monkeypatch.setattr(T, "spec_verify", boom)
        victim = sched.submit([1, 2, 3], 6)
        _run(sched, [victim])
        assert victim.finish_reason == "error"
        assert "mid-verify" in victim.error and len(victim.tokens) == 1
        for p in eng.arena.k_pools + eng.draft_arena.k_pools:
            assert not p.any()
        monkeypatch.undo()
        retry = sched.submit([1, 2, 3], 6)
        _run(sched, [retry])
        assert retry.tokens == generate(oracle_net, [1, 2, 3], 6).tolist()
