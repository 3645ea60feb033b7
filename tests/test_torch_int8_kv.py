"""The port's int8 KV pages against the JAX package's, on the CPU.

1. **The ops**: ``ops.paged_attention``'s int8 write (``_paged_write_q8``:
   monotone per-(page, head) scales by scatter-max, the touched pages
   rescaled, the new rows quantized at the new step) and the dequantizing
   gather, against the reference's on the same numpy inputs from a seed,
   over several writes that share pages, drop rows and hit sentinel
   table entries. Tolerances: codes within 1 (a row that lands on .5
   may round the other way after the libraries' f32 division), scales
   within 1e-6 relative (one f32 max and division: exact in practice),
   dequantized views within one quantization step.
2. **Quality**: the reference's ``TestInt8Quality`` cases
   (``tests/test_prefix_cache.py``) on a reference-built net saved and
   loaded into the port: the int8 paged forward over a full window
   against the dense float oracle within the reference's gate (max |Δ log
   p| < 0.25) with equal greedy argmax; fp and int8 engines
   token-identical, also through the window slide that recycles pages
   (where every recycled page's stale rows must read exact zeros, which
   a skipped scale reset breaks); int8 composed with prefix hits; the
   port's int8 engine against the JAX package's int8 engine.

The fixture model is the reference tests' (VOCAB 11, d_model 16, 2 heads,
d_ff 32, 2 layers, max_cache_t 32); engines of 8-token pages, 4 pages per
lane, prefill chunks of 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.ops import paged_attention as j_paged
from deeplearning4j_tpu.serving.decode import \
    DecodeScheduler as JDecodeScheduler
from deeplearning4j_tpu.serving.decode import \
    PagedDecodeEngine as JPagedDecodeEngine
from deeplearning4j_tpu.util.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu.util.resilience import ManualClock as JManualClock
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.models.transformer import (attention_vertices,
                                                         generate,
                                                         oracle_stream_probs,
                                                         paged_decode_forward)
from deeplearning4j_tpu_torch.ops import paged_attention as t_paged
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.serving.kv_cache import PagedKVArena
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model

VOCAB = 11
PS = 8
SCALE_RTOL = 1e-6
LOGP_GATE = 0.25          # the reference's int8 quality gate


def _scheduler(net, *, registry=None, **engine_kw):
    registry = registry or MetricsRegistry()
    engine_kw.setdefault("max_batch", 4)
    engine = PagedDecodeEngine(net, page_size=PS, pages_per_seq=4,
                               prefill_chunk=4, registry=registry,
                               **engine_kw)
    return DecodeScheduler(engine, clock=ManualClock(), registry=registry,
                           start_thread=False)


def _run(sched, reqs, limit=500, each=None):
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        sched.step_once()
        if each is not None:
            each(sched.engine)
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


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------

NUM_PAGES, H, D, P = 6, 2, 8, 3


def _write_case(seed):
    """Three writes over two lanes, [S=2, t=5] each: lane 0 walks across
    a page boundary and back into a page it wrote; lane 1 has a sentinel
    table entry and dropped (-1) slots. Amplitudes grow from write to
    write so the later writes raise the scales and rescale old codes."""
    rng = np.random.default_rng(seed)
    tables = np.array([[3, 0, 5], [1, NUM_PAGES, 4]], np.int32)
    writes = []
    for w, amp in enumerate((1.0, 3.0, 0.5)):
        new = (amp * rng.standard_normal((2, 5, H, D))).astype(np.float32)
        slots = np.stack([np.arange(5) + 5 * w,
                          np.array([w, 8 + w, -1, 16 + w, -1])]).astype(
            np.int32)
        writes.append((new, slots))
    return tables, writes


def _pools():
    j = (jnp.zeros((NUM_PAGES, PS, H, D), jnp.int8),
         jnp.zeros((NUM_PAGES, H), jnp.float32))
    rows = t_paged.pool_rows(NUM_PAGES)
    t = (torch.zeros((rows, PS, H, D), dtype=torch.int8),
         torch.zeros((rows, H), dtype=torch.float32))
    return j, t


class TestQ8OpsAgainstReference:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_write_codes_and_scales(self, seed):
        tables, writes = _write_case(seed)
        jpool, tpool = _pools()
        for new, slots in writes:
            jpool = j_paged.paged_write(jpool, jnp.asarray(new),
                                        jnp.asarray(tables),
                                        jnp.asarray(slots))
            got = t_paged.paged_write(tpool, torch.from_numpy(new),
                                      torch.from_numpy(tables),
                                      torch.from_numpy(slots))
            assert got is tpool                  # written in place
            jq, js = (np.asarray(a) for a in jpool)
            tq, ts = tpool[0][:NUM_PAGES].numpy(), tpool[1][:NUM_PAGES].numpy()
            assert np.abs(jq.astype(np.int32) - tq.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL, atol=0)
        # the sentinel page stays zero codes at scale 0; dropped rows and
        # their amax went to the trash page, never to a live page
        assert not tpool[0][NUM_PAGES].any()
        assert not tpool[1][NUM_PAGES].any()
        assert tpool[1][NUM_PAGES + 1].max() > 0

    @pytest.mark.parametrize("seed", [0, 3])
    def test_gather_dequantizes_within_one_step(self, seed):
        tables, writes = _write_case(seed)
        jpool, tpool = _pools()
        for new, slots in writes:
            jpool = j_paged.paged_write(jpool, jnp.asarray(new),
                                        jnp.asarray(tables),
                                        jnp.asarray(slots))
            t_paged.paged_write(tpool, torch.from_numpy(new),
                                torch.from_numpy(tables),
                                torch.from_numpy(slots))
        jv = np.asarray(j_paged.paged_gather(jpool, jnp.asarray(tables)))
        tv = t_paged.paged_gather(tpool, torch.from_numpy(tables)).numpy()
        assert tv.dtype == np.float32 and tv.shape == jv.shape
        step = np.asarray(jpool[1])[np.clip(tables, 0, NUM_PAGES - 1)]
        step = np.where((tables < NUM_PAGES)[..., None], step, 0.0)
        bound = np.repeat(step[:, :, None, :, None], PS, axis=2).reshape(
            tv.shape[0], -1, H, 1)
        assert np.all(np.abs(tv - jv) <= bound * (1 + 1e-6))
        # the sentinel entry (lane 1, page 1) reads exact zeros
        assert not tv[1, PS:2 * PS].any()

    def test_rows_are_half_to_even_and_clipped(self):
        """A row whose amax sets the step quantizes its largest entry to
        ±127 exactly; .5 ties round to even."""
        pool = (torch.zeros((3, 2, 1, 4), dtype=torch.int8),
                torch.zeros((3, 1), dtype=torch.float32))
        new = torch.tensor([[[[127.0, -63.5, 2.5, -1.5]]]])
        t_paged.paged_write(pool, new, torch.tensor([[0]]),
                            torch.tensor([[0]]))
        assert pool[1][0, 0].item() == 1.0
        assert pool[0][0, 0, 0].tolist() == [127, -64, 2, -2]

    def test_repeated_page_rescaled_once_per_row_identically(self):
        """Four rows of one page in one write: the page's old codes are
        rescaled by the same ratio four times over (identical writes), not
        compounded."""
        pool = (torch.zeros((3, 4, 1, 2), dtype=torch.int8),
                torch.zeros((3, 1), dtype=torch.float32))
        table = torch.tensor([[0]])
        t_paged.paged_write(pool, torch.full((1, 1, 1, 2), 1.0), table,
                            torch.tensor([[0]]))
        assert pool[0][0, 0, 0].tolist() == [127, 127]
        t_paged.paged_write(pool, torch.full((1, 3, 1, 2), 2.0), table,
                            torch.tensor([[1, 2, 3]]))
        assert pool[1][0, 0].item() == pytest.approx(2.0 / 127)
        assert pool[0][0, 0, 0].tolist() == [64, 64]     # 127 · ½, to even
        assert pool[0][0, 1:, 0].tolist() == [[127, 127]] * 3


# --------------------------------------------------------------------------
# quality and the engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp_sched(oracle_net):
    return _scheduler(oracle_net)


@pytest.fixture(scope="module")
def q8_sched(oracle_net):
    return _scheduler(oracle_net, kv_dtype="int8")


def _stale_rows_zero(eng):
    """Every live lane's allocated pages hold zero codes past the lane's
    write frontier: a fresh or recycled page's scale was reset, so its
    first write rescaled the previous owner's codes to zero."""
    ps = eng.page_size
    for lane in range(eng.lanes):
        frontier = int(eng._pos[lane] - eng._base[lane])
        for j, page in enumerate(eng._held[lane]):
            start = max(0, frontier - j * ps)
            if start >= ps:
                continue
            for codes, _ in eng.arena.k_pools + eng.arena.v_pools:
                assert not codes[page, start:].any(), (
                    f"lane {lane} page {page}: stale codes past slot "
                    f"{frontier}")


def _slide(fp_sched, q8_sched, each=None):
    """48 tokens through a 32-token window: pages recycle."""
    prompt = np.random.default_rng(17).integers(0, VOCAB, 8).astype(np.int32)
    fp = fp_sched.submit(prompt, 40)
    _run(fp_sched, [fp])
    q8 = q8_sched.submit(prompt, 40)
    _run(q8_sched, [q8], each=each)
    assert q8_sched.registry.get("kv_pages_evicted_total").value() > 0
    return fp.tokens, q8.tokens


class TestInt8Quality:
    def test_log_prob_bound_vs_dense_oracle(self, oracle_net):
        """The reference's gate: the int8 paged forward over a full window
        against the dense float oracle, max |Δ log p| < 0.25, greedy
        argmax identical."""
        dims = {}
        for name in attention_vertices(oracle_net):
            layer = oracle_net.conf.vertices[name].layer
            dims[name] = (layer.n_heads, layer.n_in // layer.n_heads)
        seq = np.random.default_rng(11).integers(
            0, VOCAB, 32).astype(np.int32)
        oracle = oracle_stream_probs(oracle_net, seq)
        q8 = PagedKVArena(dims, num_pages=4, page_size=PS,
                          kv_dtype="int8", with_allocator=False)
        with torch.inference_mode():
            probs, _, _ = paged_decode_forward(
                oracle_net, oracle_net.params, q8.k_pools, q8.v_pools,
                torch.from_numpy(seq[None]),
                torch.arange(4, dtype=torch.int32)[None],
                torch.arange(32, dtype=torch.int32)[None],
                torch.zeros(1, dtype=torch.int32))
        probs = probs[0].double().numpy()
        err = np.max(np.abs(np.log(np.maximum(probs, 1e-12))
                            - np.log(np.maximum(oracle, 1e-12))))
        assert err < LOGP_GATE, f"int8 log-prob err {err} exceeds the gate"
        assert (np.argmax(probs, axis=-1)
                == np.argmax(oracle, axis=-1)).all()

    def test_greedy_matches_fp_arena(self, fp_sched, q8_sched):
        rng = np.random.default_rng(13)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (3, 9, 16)]
        fp = [fp_sched.submit(p, 6) for p in prompts]
        _run(fp_sched, fp)
        q8 = [q8_sched.submit(p, 6) for p in prompts]
        _run(q8_sched, q8)
        for a, b in zip(fp, q8):
            assert a.tokens == b.tokens

    def test_window_slide_resets_recycled_scales(self, fp_sched, q8_sched):
        fp, q8 = _slide(fp_sched, q8_sched, each=_stale_rows_zero)
        assert fp == q8

    def test_skipped_scale_reset_fails_the_slide_check(self, oracle_net,
                                                       fp_sched,
                                                       monkeypatch):
        """Mutation: an engine that never resets a recycled page's scale
        keeps the previous owner's codes past the write frontier."""
        sched = _scheduler(oracle_net, kv_dtype="int8")
        monkeypatch.setattr(sched.engine, "_reset_page_scales",
                            lambda pages: None)
        with pytest.raises(AssertionError, match="stale codes"):
            _slide(fp_sched, sched, each=_stale_rows_zero)

    def test_int8_composes_with_prefix_hits(self, oracle_net, q8_sched):
        sched = _scheduler(oracle_net, prefix_cache=True, kv_dtype="int8")
        prompt = np.random.default_rng(21).integers(
            0, VOCAB, 16).astype(np.int32)
        ref = q8_sched.submit(prompt, 6)
        _run(q8_sched, [ref])
        miss = sched.submit(prompt, 6)
        _run(sched, [miss])
        hit = sched.submit(prompt, 6)
        _run(sched, [hit])
        assert hit.prefix_covered_tokens == 16
        assert miss.tokens == hit.tokens == ref.tokens

    @pytest.mark.parametrize("mode", [{"block_len": 4}, {"draft_k": 3}])
    def test_fused_and_speculative_int8_equal_fp(self, oracle_net, mode):
        kw = dict(mode)
        if "draft_k" in kw:
            kw["draft_net"] = oracle_net
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (2, 7)]
        out = []
        for kv in (None, "int8"):
            sched = _scheduler(oracle_net, kv_dtype=kv, **kw)
            reqs = [sched.submit(p, 9) for p in prompts]
            _run(sched, reqs)
            out.append([r.tokens for r in reqs])
            if kv == "int8" and "draft_net" in kw:
                assert sched.engine.draft_arena.kv_dtype == "int8"
        assert out[0] == out[1]

    def test_int8_engine_equals_jax_engine(self, pair):
        """Greedy tokens of the port's int8 engine equal the JAX
        package's int8 engine's, through a window slide."""
        jnet, tnet = pair
        rng = np.random.default_rng(31)
        prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
                   for n in (4, 11, 20)]
        jreg = JRegistry()
        jeng = JPagedDecodeEngine(jnet, max_batch=4, page_size=PS,
                                  pages_per_seq=4, prefill_chunk=4,
                                  registry=jreg, kv_dtype="int8")
        jsched = JDecodeScheduler(jeng, clock=JManualClock(), registry=jreg,
                                  start_thread=False)
        jreqs = [jsched.submit(p, 18) for p in prompts]
        _run(jsched, jreqs)
        sched = _scheduler(tnet, kv_dtype="int8")
        reqs = [sched.submit(p, 18) for p in prompts]
        _run(sched, reqs)
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]

    def test_arena_counts_codes_and_scales(self, oracle_net):
        eng = PagedDecodeEngine(oracle_net, max_batch=2, page_size=PS,
                                pages_per_seq=4, kv_dtype="int8",
                                registry=MetricsRegistry())
        codes, scales = eng.arena.k_pools[0]
        assert codes.dtype == torch.int8 and scales.dtype == torch.float32
        assert tuple(codes.shape) == (10, PS, 2, 8)
        assert tuple(scales.shape) == (10, 2)
        # 2 layers × (K, V) × (10·8·2·8 int8 + 10·2 f32)
        assert eng.arena.nbytes() == 4 * (10 * PS * 2 * 8 + 10 * 2 * 4)
