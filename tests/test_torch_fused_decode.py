"""The port's fused decode block and its sampler against the JAX
package's, on the CPU (the scenarios of ``tests/test_fused_decode.py``).

1. **Sampler**: ``ops.sampling`` (device sampler) and the host
   ``sample_token`` against the reference's on seeded sweeps, ties (the
   lower id wins), ``top_k`` larger than the vocabulary and a saturated
   uniform. Tokens are compared exactly; the filtered distributions within
   1e-6 (f32 log/exp/cumsum of two libraries: a few ulps).
2. **Fused block**: greedy decode through the N-step block equals the
   ticked scheduler, the port's ``generate`` and the JAX engine's fused
   block; mid-block EOS self-retires; a block straddles a page boundary;
   a budget smaller than the block; ``block_len`` bucketed; one host sync
   per block, and no host read inside the loop; sampled blocks
   reproducible; the prefix-cache hit path; a fault mid-block.

The fixture model is the reference tests' (VOCAB 11, d_model 16, 2 heads,
d_ff 32, 2 layers, max_cache_t 32), loaded into the port from the JAX
package's checkpoint; engines of 8-token pages, 4 pages per lane, prefill
chunks of 4.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.models.transformer import \
    filtered_probs_host as j_filtered_probs_host
from deeplearning4j_tpu.models.transformer import \
    sample_token as j_sample_token
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.ops import sampling as j_sampling
from deeplearning4j_tpu.serving.decode import \
    DecodeScheduler as JDecodeScheduler
from deeplearning4j_tpu.serving.decode import \
    PagedDecodeEngine as JPagedDecodeEngine
from deeplearning4j_tpu.util.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu.util.resilience import ManualClock as JManualClock
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.transformer import (filtered_probs_host,
                                                         generate,
                                                         sample_token)
from deeplearning4j_tpu_torch.ops import sampling
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine,
                                                     pow2_bucket)
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model

VOCAB = 11
FILTER_TOL = 1e-6


def _scheduler(net, *, max_batch=4, page_size=8, pages_per_seq=4,
               prefill_chunk=4, registry=None, **kw):
    registry = registry or MetricsRegistry()
    engine_kw = {k: kw.pop(k) for k in ("block_len", "num_pages",
                                        "prefix_cache") if k in kw}
    engine = PagedDecodeEngine(net, max_batch=max_batch,
                               page_size=page_size,
                               pages_per_seq=pages_per_seq,
                               prefill_chunk=prefill_chunk,
                               registry=registry, **engine_kw)
    return DecodeScheduler(engine, clock=ManualClock(), registry=registry,
                           start_thread=False, **kw)


def _run(sched, reqs, limit=500):
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        sched.step_once()
        steps += 1
    assert all(r.done for r in reqs), [r.finish_reason for r in reqs]
    return steps


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jnet = JComputationGraph(j_transformer_lm(
        VOCAB, n_layers=2, d_model=16, n_heads=2, d_ff=32, seed=5,
        input_ids=True, max_cache_t=32)).init()
    path = str(tmp_path_factory.mktemp("ckpt") / "ref.zip")
    j_save_model(jnet, path)
    return jnet, load_model(path, device="cpu")


@pytest.fixture(scope="module")
def oracle_net(pair):
    return pair[1]


@pytest.fixture(scope="module")
def fused_sched(oracle_net):
    return _scheduler(oracle_net, block_len=4)


class _FixedRng:
    """A generator stub that returns one chosen uniform."""

    def __init__(self, u):
        self.u = float(u)

    def random(self, n=None):
        return self.u if n is None else np.full(n, self.u)


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------


def _sweep(seed=7, n=60, v=24):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.dirichlet(np.ones(v) * rng.uniform(0.2, 3.0))
                  for _ in range(n)]).astype(np.float32)
    t = rng.uniform(0.2, 2.0, n).astype(np.float32)
    t[::7] = 0.0                                # greedy lanes ride along
    tk = rng.integers(0, v + 3, n).astype(np.int32)   # some top_k > V
    tp = np.where(rng.random(n) < 0.7, rng.uniform(0.1, 1.0, n),
                  1.0).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    return p, t, tk, tp, u


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestSamplerAgainstReference:
    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_sample_tokens_equal(self, seed):
        p, t, tk, tp, u = _sweep(seed)
        ref = np.asarray(j_sampling.sample_tokens(*_j(p, t, tk, tp, u)))
        got = sampling.sample_tokens(*_t(p, t, tk, tp, u))
        assert got.dtype == torch.int32
        assert got.numpy().tolist() == ref.tolist()

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_filtered_probs_within_tolerance(self, seed):
        p, t, tk, tp, _ = _sweep(seed)
        ref = np.asarray(j_sampling.filtered_probs(*_j(p, t, tk, tp)))
        got = sampling.filtered_probs(*_t(p, t, tk, tp))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=FILTER_TOL, rtol=0)
        # the same support: filtering keeps exactly the same ids
        assert np.array_equal(got.numpy() > 0, ref > 0)

    @pytest.mark.parametrize("seed", [7, 8])
    def test_inverse_cdf_equal_on_the_same_weights(self, seed):
        p, t, tk, tp, u = _sweep(seed)
        w = np.asarray(j_sampling.filtered_probs(*_j(p, t, tk, tp)))
        ref = np.asarray(j_sampling.inverse_cdf(*_j(w, u)))
        got = sampling.inverse_cdf(*_t(w, u))
        assert got.numpy().tolist() == ref.tolist()

    @pytest.mark.parametrize("seed", [7, 8])
    def test_host_sampler_equals_reference_and_device(self, seed):
        """sample_token (host, float64) equals the reference's at the same
        uniform, and the device sampler at that uniform."""
        p, t, tk, tp, u = _sweep(seed)
        dev = sampling.sample_tokens(*_t(p, t, tk, tp, u)).numpy()
        for i in range(len(p)):
            kw = dict(top_k=int(tk[i]), top_p=float(tp[i]))
            host = sample_token(p[i], float(t[i]), _FixedRng(u[i]), **kw)
            assert host == j_sample_token(p[i], float(t[i]),
                                          _FixedRng(u[i]), **kw)
            assert host == int(dev[i]), (i, t[i], tk[i], tp[i], u[i])

    def test_filtered_probs_host_equals_reference(self):
        p, t, tk, tp, _ = _sweep(3)
        for i in range(len(p)):
            if t[i] <= 0:
                continue
            args = (p[i].astype(np.float64), float(t[i]), int(tk[i]),
                    float(tp[i]))
            assert np.array_equal(filtered_probs_host(*args),
                                  j_filtered_probs_host(*args))

    def test_ties_break_toward_lower_id(self):
        p = np.full((1, 4), 0.25, np.float32)
        args = (np.ones(1, np.float32), np.ones(1, np.int32),
                np.ones(1, np.float32), np.full(1, 0.1, np.float32))
        assert int(sampling.sample_tokens(*_t(p, *args))[0]) == 0
        assert int(j_sampling.sample_tokens(*_j(p, *args))[0]) == 0
        assert sample_token(p[0], 1.0, _FixedRng(0.1), top_k=1) == 0
        # greedy: argmax ties also go to the lower id
        greedy = (np.zeros(1, np.float32),) + args[1:]
        assert int(sampling.sample_tokens(*_t(p, *greedy))[0]) == 0

    def test_top_k_larger_than_vocab_filters_nothing(self):
        p = np.array([[0.4, 0.3, 0.2, 0.1]], np.float32)
        w = sampling.filtered_probs(*_t(p, np.ones(1, np.float32),
                                        np.full(1, 99, np.int32),
                                        np.ones(1, np.float32)))
        ref = j_sampling.filtered_probs(*_j(p, np.ones(1, np.float32),
                                            np.full(1, 99, np.int32),
                                            np.ones(1, np.float32)))
        np.testing.assert_allclose(w.numpy(), np.asarray(ref),
                                   atol=FILTER_TOL, rtol=0)
        np.testing.assert_allclose(w.numpy()[0], p[0], atol=FILTER_TOL)

    def test_saturated_uniform_falls_back_to_last_support_token(self):
        """u that rounds to 1.0f cannot emit a filtered-out token: the
        draw falls back to the LAST positive-weight id (2 here, not the
        filtered-out id 0)."""
        p = np.array([[0.05, 0.5, 0.3, 0.15]], np.float32)
        args = (np.ones(1, np.float32), np.full(1, 2, np.int32),
                np.ones(1, np.float32))
        w = sampling.filtered_probs(*_t(p, *args))
        assert int(sampling.inverse_cdf(w, torch.ones(1))[0]) == 2
        jw = j_sampling.filtered_probs(*_j(p, *args))
        assert int(j_sampling.inverse_cdf(jw, jnp.ones(1))[0]) == 2
        assert sample_token(p[0], 1.0, _FixedRng(1.0), top_k=2) == 2

    def test_greedy_needs_no_rng(self):
        p = np.array([0.1, 0.5, 0.4])
        assert sample_token(p) == 1
        with pytest.raises(ValueError, match="rng"):
            sample_token(p, 0.5)

    def test_generate_accepts_filters(self, oracle_net):
        out = generate(oracle_net, [1, 2, 3], 5, temperature=0.9,
                       rng=np.random.default_rng(3), top_k=4, top_p=0.9)
        assert len(out) == 5 and all(0 <= t < VOCAB for t in out)


# --------------------------------------------------------------------------
# the fused block
# --------------------------------------------------------------------------


class TestFusedParity:
    def test_ragged_batch_equals_generate(self, oracle_net, fused_sched):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (3, 5, 7, 2)]
        n_new = [4, 6, 2, 9]          # straddles the block_len=4 boundary
        oracle = [generate(oracle_net, p, n).tolist()
                  for p, n in zip(prompts, n_new)]
        reqs = [fused_sched.submit(p, n) for p, n in zip(prompts, n_new)]
        _run(fused_sched, reqs)
        for o, r in zip(oracle, reqs):
            assert r.tokens == o
        assert all(r.finish_reason == "max_tokens" for r in reqs)

    def test_fused_equals_ticked(self, oracle_net, fused_sched):
        ticked = _scheduler(oracle_net)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (4, 6)]
        a = [fused_sched.submit(p, 7) for p in prompts]
        _run(fused_sched, a)
        b = [ticked.submit(p, 7) for p in prompts]
        _run(ticked, b)
        for x, y in zip(a, b):
            assert x.tokens == y.tokens

    def test_fused_greedy_equals_jax_engine(self, pair):
        """One fixed schedule through the reference's fused engine
        (``lax.while_loop``, early exit) and the port's (all N steps):
        the same tokens and finish reasons."""
        jnet, tnet = pair
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (5, 2, 9)]
        eos = int(generate(tnet, prompts[1], 9)[5])

        def drive(engine_cls, sched_cls, reg_cls, clock_cls, net):
            reg = reg_cls()
            eng = engine_cls(net, max_batch=4, page_size=8, pages_per_seq=4,
                             prefill_chunk=4, registry=reg, block_len=4)
            s = sched_cls(eng, clock=clock_cls(), registry=reg,
                          start_thread=False)
            reqs = [s.submit(prompts[0], 10), s.submit(prompts[1], 9,
                                                       eos_id=eos)]
            s.step_once()
            reqs.append(s.submit(prompts[2], 6))
            _run(s, reqs)
            return [(r.tokens, r.finish_reason) for r in reqs]

        ref = drive(JPagedDecodeEngine, JDecodeScheduler, JRegistry,
                    JManualClock, jnet)
        got = drive(PagedDecodeEngine, DecodeScheduler, MetricsRegistry,
                    ManualClock, tnet)
        assert got == ref
        assert got[1][1] == "eos"

    def test_mid_block_eos_self_retires(self, oracle_net, fused_sched):
        prompt = np.random.default_rng(3).integers(0, VOCAB, 4)
        eos = int(generate(oracle_net, prompt, 8)[1])   # block step 2 of 4
        req = fused_sched.submit(prompt, 8, eos_id=eos)
        _run(fused_sched, [req])
        assert req.tokens == generate(oracle_net, prompt, 8,
                                      eos_id=eos).tolist()
        assert req.finish_reason == "eos" and len(req.tokens) < 8
        assert fused_sched.engine.arena.allocator.pages_in_use == 0

    def test_block_straddles_page_boundary(self, oracle_net):
        sched = _scheduler(oracle_net, page_size=4, pages_per_seq=8,
                           block_len=8)
        prompt = np.asarray([1, 2, 3], np.int32)     # block writes 3..10
        req = sched.submit(prompt, 10)
        _run(sched, [req])
        assert req.tokens == generate(oracle_net, prompt, 10).tolist()

    def test_budget_smaller_than_block(self, oracle_net, fused_sched):
        req = fused_sched.submit([1, 2], 2)
        _run(fused_sched, [req])
        assert req.tokens == generate(oracle_net, [1, 2], 2).tolist()

    def test_sampled_block_reproducible(self, fused_sched):
        outs = []
        for _ in range(2):
            req = fused_sched.submit([1, 2, 3], 6, temperature=0.8,
                                     seed=42, top_k=6, top_p=0.9)
            _run(fused_sched, [req])
            outs.append(req.tokens)
        assert outs[0] == outs[1]
        assert all(0 <= t < VOCAB for t in outs[0])

    def test_sampled_block_matches_host_sampler(self, oracle_net):
        """A fused block samples on the device at the uniforms the host
        drew; replaying those uniforms through the host sampler over
        generate's distributions gives the same tokens."""
        sched = _scheduler(oracle_net, block_len=8)
        draws = []
        rng_cls = np.random.default_rng

        class Recording:
            def __init__(self, seed):
                self._g = rng_cls(seed)

            def random(self, n=None):
                out = self._g.random(n)
                draws.extend(np.atleast_1d(out).tolist())
                return out

        req = sched.submit([4, 2, 7], 6, temperature=0.7, top_k=5,
                           top_p=0.85)
        req.rng = Recording(5)
        _run(sched, [req])
        # replay: first token on the host from prefill, the rest on the
        # device within one block of 8 uniforms
        replay = iter(draws)

        class Replay:
            def random(self, n=None):
                return next(replay)

        want = generate(oracle_net, [4, 2, 7], 6, temperature=0.7,
                        rng=Replay(), top_k=5, top_p=0.85).tolist()
        assert req.tokens == want

    def test_one_sync_per_block(self, oracle_net):
        """Eight tokens: the first from the prefill dispatch, the other
        seven from ONE fused dispatch with one host read."""
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg, block_len=8)
        req = sched.submit([1, 2, 3, 4], 8)
        _run(sched, [req])
        assert reg.get("decode_tokens_total").value(phase="decode") == 7
        assert reg.get("decode_dispatches_total").value(kind="fused") == 1
        assert reg.get("decode_dispatches_total").value(kind="paged") == 1
        assert reg.get("decode_host_syncs_total").value() == 2

    def test_fused_loop_reads_nothing_back(self, oracle_net, monkeypatch):
        """Inside the fused loop no tensor value reaches the host: every
        host read raises while the loop runs."""
        sched = _scheduler(oracle_net, block_len=8)
        loop = T.fused_decode_loop
        reads = ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__",
                 "__int__", "__float__", "__index__")

        @contextlib.contextmanager
        def no_host_reads():
            saved = {n: getattr(torch.Tensor, n) for n in reads}

            def refuse(name):
                def fn(*a, **k):
                    raise AssertionError(f"host read Tensor.{name} inside "
                                         "the fused loop")
                return fn
            for n in reads:
                setattr(torch.Tensor, n, refuse(n))
            try:
                yield
            finally:
                for n, f in saved.items():
                    setattr(torch.Tensor, n, f)

        calls = []

        def guarded(*a, **kw):
            calls.append(1)
            with no_host_reads():
                return loop(*a, **kw)
        monkeypatch.setattr(T, "fused_decode_loop", guarded)
        reqs = [sched.submit([1, 2, 3], 9, eos_id=4),
                sched.submit([5, 6], 9, temperature=0.8, seed=3, top_k=4)]
        _run(sched, reqs)
        assert calls and all(r.finish_reason in ("eos", "max_tokens")
                             for r in reqs)

    def test_bad_sampling_params_rejected(self, fused_sched):
        with pytest.raises(ValueError, match="top_p"):
            fused_sched.submit([1], 2, top_p=0.0)
        with pytest.raises(ValueError, match="top_k"):
            fused_sched.submit([1], 2, top_k=-1)

    def test_huge_top_k_normalized_to_unfiltered(self, fused_sched):
        req = fused_sched.submit([1, 2], 3, temperature=0.8, seed=1,
                                 top_k=2**31)
        assert req.top_k == 0
        _run(fused_sched, [req])
        assert len(req.tokens) == 3

    def test_block_len_bucketed_pow2_and_capped(self, oracle_net):
        eng = PagedDecodeEngine(oracle_net, max_batch=1, page_size=8,
                                pages_per_seq=4, block_len=5,
                                registry=MetricsRegistry())
        assert eng.block_len == 8
        assert pow2_bucket(100, cap=64) == 64 and pow2_bucket(1, 64) == 1
        with pytest.raises(ValueError, match="window"):
            PagedDecodeEngine(oracle_net, max_batch=1, page_size=8,
                              pages_per_seq=4, block_len=64,
                              registry=MetricsRegistry())
        with pytest.raises(ValueError, match="power of two"):
            pow2_bucket(3, cap=48)


class TestFusedLadderAndMetrics:
    def test_warmup_then_churn_keeps_the_key_set(self, oracle_net):
        sched = _scheduler(oracle_net, block_len=4)
        eng = sched.engine
        eng.warmup()
        before = set(eng.dispatch_keys)
        # the fused block's greedy and sampled variants are two keys
        assert before == ({f"paged_decode[S{b}xT4xP4]" for b in (1, 2, 4)}
                          | {f"fused_decode[S{b}xN4xP4]{v}"
                             for b in (1, 2, 4) for v in ("", "|sampled")})
        rng = np.random.default_rng(9)
        reqs = []
        for wave in range(3):
            reqs += [sched.submit(rng.integers(0, VOCAB, 1 + wave + i),
                                  3 + i) for i in range(3)]
            for _ in range(3):
                sched.step_once()
        _run(sched, reqs)
        assert set(eng.dispatch_keys) == before

    def test_tick_split_and_dispatch_kinds_exposed(self, oracle_net):
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, registry=reg, block_len=4)
        _run(sched, [sched.submit([1, 2, 3], 6)])
        counts = {s["labels"]["component"]: s["count"] for s in
                  reg.get("decode_host_tick_seconds").snapshot()["series"]}
        assert counts.get("dispatch", 0) > 0
        assert counts.get("bookkeeping", 0) > 0
        kinds = {s["labels"]["kind"]: s["value"] for s in
                 reg.get("decode_dispatches_total").snapshot()["series"]}
        assert kinds.get("fused", 0) > 0 and kinds.get("paged", 0) > 0
        text = reg.expose()
        assert "decode_host_tick_seconds" in text
        assert "decode_host_syncs_total" in text

    def test_fused_hit_path_same_keys_and_dispatches(self, oracle_net):
        """The prefix-cache hit re-feeds at t = 1 inside the warmed
        ladder, uses as many fused dispatches as the miss that seeded it,
        and decodes the same tokens."""
        reg = MetricsRegistry()
        sched = _scheduler(oracle_net, prefix_cache=True, block_len=4,
                           registry=reg)
        eng = sched.engine
        eng.warmup()
        keys = set(eng.dispatch_keys)
        prompt = np.random.default_rng(21).integers(0, VOCAB, 16).astype(
            np.int32)
        oracle = generate(oracle_net, prompt, 8).tolist()
        disp = reg.get("decode_dispatches_total")
        f0 = disp.value(kind="fused")
        miss = sched.submit(prompt, 8)
        _run(sched, [miss])
        fused_miss = disp.value(kind="fused") - f0
        f0 = disp.value(kind="fused")
        hit = sched.submit(prompt, 8)
        _run(sched, [hit])
        fused_hit = disp.value(kind="fused") - f0
        assert miss.tokens == hit.tokens == oracle
        assert hit.prefix_covered_tokens == 16
        assert set(eng.dispatch_keys) == keys
        assert fused_hit == fused_miss > 0

    @pytest.mark.chaos
    def test_fault_mid_fused_block(self, oracle_net):
        sched = _scheduler(oracle_net, block_len=4)
        victim = sched.submit([1, 2, 3], 6)
        plan = faults.FaultPlan().fail_at(
            "serving.decode_step", call=2,
            exc=RuntimeError("card fell over"))
        with plan.active():
            _run(sched, [victim])
            assert victim.finish_reason == "error"
            assert sched.engine.arena.allocator.pages_in_use == 0
            retry = sched.submit([1, 2, 3], 6)
            _run(sched, [retry])
        assert retry.tokens == generate(oracle_net, [1, 2, 3], 6).tolist()
        assert plan.triggered == [("serving.decode_step", 2)]

    @pytest.mark.chaos
    def test_failure_inside_the_fused_loop_rebuilds_pools(self, oracle_net,
                                                          monkeypatch):
        sched = _scheduler(oracle_net, block_len=4)
        eng = sched.engine
        _run(sched, [sched.submit([3, 3, 3], 5)])

        def boom(*a, **k):
            raise RuntimeError("device fell over mid-block")
        monkeypatch.setattr(T, "fused_decode_loop", boom)
        victim = sched.submit([1, 2, 3], 6)
        _run(sched, [victim])
        assert victim.finish_reason == "error"
        assert "mid-block" in victim.error and len(victim.tokens) == 1
        assert all(bool(p.abs().sum() == 0) for p in eng.arena.k_pools)
        monkeypatch.undo()
        retry = sched.submit([1, 2, 3], 6)
        _run(sched, [retry])
        assert retry.tokens == generate(oracle_net, [1, 2, 3], 6).tolist()
