"""One captured program per dispatch shape (``util/capture.py``) in the
port's paged decode engine, on the CPU: the counterpart of the reference's
``keyed_jit`` / ``retrace_guard`` pins (``tests/test_decode.py``'s
retrace pin, ``tests/test_fused_decode.py``'s trace ladder) and of its
TTFT split (``tests/test_decode.py::TestRequestTimelines``).

On the CPU an entry's ``run()`` calls the step function eagerly on its
static inputs; the staging, keying and accounting are the code the card
runs. The tests marked ``cuda`` hold a replayed CUDA graph bitwise
against an eager call of the same step on the same inputs, on every key
of each mode's ladder; they need a card and no JAX (``python -m pytest
--noconftest -m cuda tests/test_torch_capture.py``).

The model is the reference tests' fixture (VOCAB 11, d_model 16, 2 heads,
d_ff 32, 2 layers, max_cache_t 32), built by the port from a seed;
engines of 8-token pages, 4 pages per lane, prefill chunks of 4, 4 lanes.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.models.transformer import (draft_transformer_lm,
                                                         generate)
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.util import capture
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.tracing import Tracer

VOCAB = 11


def _net(seed=5, device="cpu", n_layers=2, max_cache_t=32):
    conf = transformer_lm(VOCAB, n_layers=n_layers, d_model=16, n_heads=2,
                          d_ff=32, seed=seed, input_ids=True,
                          max_cache_t=max_cache_t)
    return ComputationGraph(conf, device=device).init()


def _draft(device="cpu"):
    return ComputationGraph(draft_transformer_lm(
        VOCAB, d_model=16, n_heads=2, d_ff=32, seed=123, max_cache_t=32),
        device=device).init()


def _scheduler(net, *, max_batch=4, registry=None, clock=None, **kw):
    registry = registry or MetricsRegistry()
    engine = PagedDecodeEngine(net, max_batch=max_batch, page_size=8,
                               pages_per_seq=4, prefill_chunk=4,
                               registry=registry, **kw)
    return DecodeScheduler(engine, clock=clock or ManualClock(),
                           registry=registry, start_thread=False)


def _run(sched, reqs, limit=500):
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        sched.step_once()
        steps += 1
    assert all(r.done for r in reqs), [r.finish_reason for r in reqs]
    return steps


def _builds(reg):
    """``jit_retraces_total`` by key: the entries built."""
    m = reg.get("jit_retraces_total")
    return {} if m is None else {s["labels"]["fn"]: s["value"]
                                 for s in m.snapshot()["series"]}


def _churn(sched, waves=3, per_wave=3, seed=9, sampled=False):
    rng = np.random.default_rng(seed)
    reqs = []
    for wave in range(waves):
        for i in range(per_wave):
            kw = ({"temperature": 0.8, "seed": wave * 10 + i, "top_k": 5}
                  if sampled and i == 1 else {})
            reqs.append(sched.submit(rng.integers(0, VOCAB, 1 + wave + i),
                                     3 + i, **kw))
        for _ in range(3):
            sched.step_once()
    _run(sched, reqs)
    return reqs


def _ladder(mode, lanes=(1, 2, 4)):
    """The keys ``warmup()`` builds for each engine mode."""
    keys = set()
    for b in lanes:
        keys.add(f"paged_decode[S{b}xT4xP4]")
        if mode in ("ticked", "prefix", "int8"):
            keys.add(f"paged_decode[S{b}xT1xP4]")
        if mode == "fused":
            keys |= {f"fused_decode[S{b}xN4xP4]{v}" for v in ("", "|sampled")}
        if mode in ("spec", "int8_spec"):
            keys.add(f"draft_prefill[S{b}xT4xP4]")
            keys |= {f"spec_{w}[S{b}xK3xP4]{v}" for w in ("draft", "verify")
                     for v in ("", "|sampled")}
    return keys


_MODES = {"ticked": {}, "prefix": {"prefix_cache": True},
          "fused": {"block_len": 4}, "int8": {"kv_dtype": "int8"},
          "spec": {"draft_k": 3}, "int8_spec": {"draft_k": 3,
                                               "kv_dtype": "int8"}}


def _mode_kw(mode, device="cpu"):
    kw = dict(_MODES[mode])
    if "draft_k" in kw:
        kw["draft_net"] = _draft(device)
    return kw


@pytest.fixture(scope="module")
def net():
    return _net()


def _pool_tensors(eng):
    out = []
    for arena in (eng.arena, eng.draft_arena):
        if arena is not None:
            for p in arena.k_pools + arena.v_pools:
                out.extend(p if isinstance(p, tuple) else (p,))
    return out


class TestKeyLadder:
    def test_one_entry_per_key_under_churn(self, net):
        """Admissions and retirements across many ticks build exactly one
        entry per (lane bucket, chunk) key, and the keys are the
        power-of-two ladder (the reference's one compile per bucket)."""
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg)
        _churn(sched)
        builds = _builds(reg)
        assert builds and all(v == 1 for v in builds.values()), builds
        names = set(builds)
        assert any("T1x" in n for n in names)       # decode steps
        assert any("T4x" in n for n in names)       # prefill chunks
        assert names <= _ladder("ticked"), names
        assert set(sched.engine._graphs.entries()) == names

    def test_warmup_then_churn_pins_the_fused_ladder(self, net):
        """warmup() builds the whole (bucket, block) ladder, both fused
        variants included, and churn with greedy and sampled lanes builds
        nothing more."""
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg, block_len=4)
        sched.engine.warmup()
        before = _builds(reg)
        assert set(before) == _ladder("fused"), before
        assert all(v == 1 for v in before.values())
        _churn(sched, sampled=True)
        assert _builds(reg) == before

    def test_speculative_ladder_under_churn(self, net):
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg, draft_net=_draft(),
                           draft_k=3, max_batch=2)
        _churn(sched, waves=2, per_wave=2, seed=10, sampled=True)
        builds = _builds(reg)
        assert all(v == 1 for v in builds.values()), builds
        assert set(builds) <= _ladder("spec", lanes=(1, 2)), builds
        assert any(n.startswith("spec_verify") for n in builds)

    @pytest.mark.parametrize("mode", sorted(_MODES))
    def test_warmup_builds_the_ladder_and_leaves_the_arena(self, net, mode):
        """Every entry of the mode's ladder is built once from
        placeholders (sentinel tables, dropped slots, inactive lanes): no
        page or the sentinel is written, nothing is allocated, no
        dispatch is counted."""
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg, **_mode_kw(mode))
        eng = sched.engine
        eng.warmup()
        builds = _builds(reg)
        assert set(builds) == _ladder(mode), set(builds) ^ _ladder(mode)
        assert all(v == 1 for v in builds.values())
        trash = eng.arena.num_pages + 1
        for t in _pool_tensors(eng):
            assert not t[:trash].any(), "warmup wrote a live page"
        assert eng.arena.allocator.pages_in_use == 0
        assert reg.get("decode_dispatches_total").value(kind="paged") == 0
        assert reg.get("decode_host_syncs_total").value() == 0
        # warmed: serving builds nothing more
        _run(sched, [sched.submit([1, 2, 3], 5),
                     sched.submit([4, 5], 6, temperature=0.7, seed=1)])
        assert _builds(reg) == builds

    def test_prefix_hits_build_nothing_after_warmup(self, net):
        """The fused hit path re-feeds at t = 1 inside the warmed ladder:
        a miss and a full hit build no entry (the reference's pin in
        ``tests/test_prefix_cache.py``)."""
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg, block_len=4,
                           prefix_cache=True)
        sched.engine.warmup()
        before = _builds(reg)
        assert "paged_decode[S1xT1xP4]" in before
        prompt = np.random.default_rng(21).integers(0, VOCAB, 16)
        miss = sched.submit(prompt, 8)
        _run(sched, [miss])
        hit = sched.submit(prompt, 8)
        _run(sched, [hit])
        assert hit.prefix_covered_tokens == 16
        assert hit.tokens == miss.tokens == generate(net, prompt, 8).tolist()
        assert _builds(reg) == before

    def test_key_counts_builds_not_dispatches(self, net):
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg)
        _run(sched, [sched.submit([1, 2, 3], 6)])
        eng = sched.engine
        assert _builds(reg) == {"paged_decode[S1xT4xP4]": 1,
                                "paged_decode[S1xT1xP4]": 1}
        assert eng.dispatch_keys["paged_decode[S1xT1xP4]"] == 5
        hist = reg.get("xla_compile_seconds")
        assert hist.count(fn="paged_decode[S1xT1xP4]") == 1
        assert hist.sum(fn="paged_decode[S1xT1xP4]") > 0


class TestSwapNet:
    def test_swap_drops_and_rebuilds_every_entry(self, net):
        """swap_net drops every entry (a captured graph reads the old
        parameters) and builds the ladder again; decode then equals a cold
        engine on the new net."""
        reg = MetricsRegistry()
        sched = _scheduler(_net(seed=5), registry=reg, block_len=4)
        eng = sched.engine
        eng.warmup()
        old = eng._graphs.entries()
        _run(sched, [sched.submit([1, 2, 3], 5)])
        swapped = _net(seed=99)
        with sched.fence():
            eng.swap_net(swapped)
        builds = _builds(reg)
        assert set(builds) == _ladder("fused")
        assert all(v == 2 for v in builds.values()), builds
        new = eng._graphs.entries()
        assert all(new[k] is not e for k, e in old.items())
        prompts = [[1, 2, 3], [7, 3, 9, 2, 2]]
        got = [sched.submit(p, 6) for p in prompts]
        _run(sched, got)
        cold = _scheduler(swapped, block_len=4)
        want = [cold.submit(p, 6) for p in prompts]
        _run(cold, want)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.tokens for r in got] == [generate(swapped, p, 6).tolist()
                                           for p in prompts]


class TestFailedDispatch:
    @pytest.mark.chaos
    @pytest.mark.parametrize("mode", ["ticked", "int8", "int8_spec"])
    def test_pools_keep_their_addresses_and_are_zeroed(self, net, mode,
                                                       monkeypatch):
        """A dispatch that fails inside the step zeroes every pool (both
        arenas) IN PLACE: the same storage, so a captured graph that
        reads it stays valid; the next request decodes exactly."""
        sched = _scheduler(net, **_mode_kw(mode))
        eng = sched.engine
        _run(sched, [sched.submit([5, 6, 7], 4)])
        tensors = _pool_tensors(eng)
        assert any(bool(t.any()) for t in tensors)
        ptrs = [t.data_ptr() for t in tensors]

        def boom(*a, **k):
            raise RuntimeError("device fell over mid-dispatch")
        monkeypatch.setattr(T, "paged_decode_forward", boom)
        victim = sched.submit([1, 2], 3)
        _run(sched, [victim])
        assert victim.finish_reason == "error"
        monkeypatch.undo()
        assert [t.data_ptr() for t in _pool_tensors(eng)] == ptrs
        assert not any(bool(t.any()) for t in _pool_tensors(eng))
        retry = sched.submit([1, 2], 3)
        _run(sched, [retry])
        if "int8" not in mode:
            assert retry.tokens == generate(net, [1, 2], 3).tolist()
        else:
            assert retry.finish_reason == "max_tokens"

    @pytest.mark.chaos
    def test_failed_build_is_not_kept(self, net, monkeypatch):
        """A build that raises leaves no entry behind: the next dispatch
        of the key builds it again."""
        reg = MetricsRegistry()
        sched = _scheduler(net, registry=reg)

        def boom(*a, **k):
            raise RuntimeError("capture fell over")
        monkeypatch.setattr(T, "paged_decode_forward", boom)
        victim = sched.submit([1, 2, 3], 3)
        _run(sched, [victim])
        assert victim.finish_reason == "error"
        assert sched.engine._graphs.entries() == {} and _builds(reg) == {}
        monkeypatch.undo()
        req = sched.submit([1, 2, 3], 3)
        _run(sched, [req])
        assert req.tokens == generate(net, [1, 2, 3], 3).tolist()
        assert all(v == 1 for v in _builds(reg).values())


class TestGraphCache:
    def test_entry_keeps_static_tensors_and_checks_shapes(self):
        reg = MetricsRegistry()
        cache = capture.GraphCache("cpu", reg)

        def step(x, y):
            return x * 2, (x + y).sum(dim=-1)

        ph = {"x": np.zeros((2, 3), np.float32),
              "y": np.zeros((2, 3), np.float32)}
        entry = cache.get("k", step, ph)
        assert cache.get("k", step, ph) is entry
        assert cache.entries() == {"k": entry}
        outs = entry.outputs
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        entry.stage(x=x, y=np.ones((2, 3)))
        a, b = entry.run()
        assert a is outs[0] and b is outs[1]
        np.testing.assert_array_equal(a.numpy(), 2 * x)
        np.testing.assert_array_equal(b.numpy(), (x + 1).sum(-1))
        with pytest.raises(ValueError, match="shape"):
            entry.stage(x=np.zeros((3, 3)), y=np.zeros((2, 3)))
        assert _builds(reg) == {"k": 1}
        cache.clear()
        assert cache.entries() == {}
        cache.get("k", step, ph)
        assert _builds(reg) == {"k": 2}
        assert cache.pool_bytes() is None      # no graph pool on the CPU


class TestTTFTBreakdown:
    """The reference's four-part TTFT split: queue wait, prefill, the
    builds (captures) of keys warmup missed, and the rest."""

    @pytest.fixture(scope="class")
    def traced(self, net):
        registry = MetricsRegistry()
        tracer = Tracer()
        engine = PagedDecodeEngine(_net(), max_batch=4, page_size=8,
                                   pages_per_seq=4, prefill_chunk=4,
                                   registry=registry)
        sched = DecodeScheduler(engine, registry=registry,
                                start_thread=False, tracer=tracer)
        rng = np.random.default_rng(21)
        reqs = [sched.submit(rng.integers(0, VOCAB, 5), 6),
                sched.submit(rng.integers(0, VOCAB, 3), 4)]
        _run(sched, reqs)
        return sched, tracer, reqs

    def test_breakdown_sums_to_measured_ttft(self, traced):
        _sched, tracer, reqs = traced
        for r in reqs:
            ttft = r.t_first_token - r.t_submit
            bd = r.ttft_breakdown
            assert set(bd) == {"queue_wait", "prefill", "compile",
                               "dispatch"}
            assert all(v >= 0 for v in bd.values())
            assert abs(sum(bd.values()) - ttft) <= 0.05 * ttft
            assert bd["prefill"] > 0
        # no warmup(): the first request's prefill tick built its key
        assert reqs[0].ttft_breakdown["compile"] > 0
        chunks = tracer.find("prefill_chunk")
        assert chunks and any(s.attributes["compile_s"] > 0 for s in chunks)

    def test_warmed_engine_pays_no_compile(self, net):
        engine = PagedDecodeEngine(net, max_batch=4, page_size=8,
                                   pages_per_seq=4, prefill_chunk=4,
                                   registry=MetricsRegistry())
        engine.warmup()
        sched = DecodeScheduler(engine, start_thread=False)
        req = sched.submit([1, 2, 3, 4, 5], 4)
        _run(sched, [req])
        assert req.ttft_breakdown["compile"] == 0.0
        assert req.ttft_breakdown["prefill"] > 0


# --------------------------------------------------------------------------
# on the card: replay against eager
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are captured there")
    return torch.device("cuda")


def replay_equals_eager(eng, name):
    """Run the key's entry twice on the same pools and inputs — replay,
    then an eager call of its step function — and compare outputs and
    pools bitwise (the trash page, which takes dropped writes in any
    order, excepted). Returns the names of what differs."""
    entry = eng._graphs.entries()[name]
    tensors = _pool_tensors(eng)
    trash = eng.arena.num_pages + 1
    before = [t.clone() for t in tensors]
    with torch.inference_mode():
        graph_out = [o.clone() for o in entry.run()]
        graph_pools = [t[:trash].clone() for t in tensors]
        for t, b in zip(tensors, before):
            t.copy_(b)
        out = entry.fn(**entry.inputs)
        eager_out = list(out if isinstance(out, tuple) else (out,))
    bad = [f"output {i}" for i, (a, b) in enumerate(zip(graph_out,
                                                         eager_out))
           if not torch.equal(a, b)]
    bad += [f"pool tensor {i}" for i, (a, t) in enumerate(zip(graph_pools,
                                                               tensors))
            if not torch.equal(a, t[:trash])]
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cuda_replay_equals_eager_on_every_key(cuda_device, mode):
    net = _net(device=cuda_device)
    sched = _scheduler(net, **_mode_kw(mode, cuda_device))
    eng = sched.engine
    eng.warmup()
    assert all(e.graph is not None for e in eng._graphs.entries().values())
    reqs = _churn(sched, waves=2, sampled=True)
    assert all(r.finish_reason == "max_tokens" for r in reqs)
    diffs = {k: replay_equals_eager(eng, k) for k in eng._graphs.entries()}
    assert not any(diffs.values()), diffs


@pytest.mark.cuda
def test_cuda_graphs_equal_the_eager_engine(cuda_device):
    """The captured engine and the eager one (the private switch) serve
    the same tokens."""
    outs = []
    for eager in (False, True):
        sched = _scheduler(_net(device=cuda_device), block_len=4)
        sched.engine._graphs._eager_cuda = eager
        reqs = _churn(sched, sampled=True)
        outs.append([r.tokens for r in reqs])
    assert outs[0] == outs[1]
