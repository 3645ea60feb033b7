"""The port's observability substrate against the JAX package's, on the
CPU: ``util/timeline.py`` (the same spans and store records must give the
same dict and text, exactly), ``util/profiling.py``'s FLOPs arithmetic
and ``mfu``, and the coordination stores of ``parallel/elastic.py`` (a
store written by one package is read by the other, byte for byte). The
profiler captures are tested in ``tests/test_torch_profiling.py``.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import elastic as j_elastic
from deeplearning4j_tpu.util import profiling as j_profiling
from deeplearning4j_tpu.util import timeline as j_timeline

from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.parallel import elastic as t_elastic
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.util import profiling as t_profiling
from deeplearning4j_tpu_torch.util import timeline as t_timeline
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.tracing import Tracer


# --------------------------------------------------------------------------
# timeline: per-request and per-trace views of real decode spans
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_spans():
    """Spans of three served requests (one parented on a caller's
    traceparent) from the port's scheduler, as span dicts."""
    conf = transformer_lm(11, n_layers=1, d_model=16, n_heads=2, d_ff=32,
                          seed=3, input_ids=True, max_cache_t=32)
    net = ComputationGraph(conf, device="cpu").init()
    reg = MetricsRegistry()
    tracer = Tracer(host="replica-a")
    eng = PagedDecodeEngine(net, max_batch=4, page_size=8, pages_per_seq=4,
                            prefill_chunk=4, registry=reg)
    sched = DecodeScheduler(eng, registry=reg, start_thread=False,
                            tracer=tracer)
    rng = np.random.default_rng(9)
    reqs = [sched.submit(rng.integers(0, 11, 5), 4,
                         trace_ctx="00-" + "ab" * 16 + "-" + "cd" * 8
                         + "-01"),
            sched.submit(rng.integers(0, 11, 3), 3),
            sched.submit(rng.integers(0, 11, 9), 2)]
    for _ in range(200):
        if all(r.done for r in reqs):
            break
        sched.step_once()
    assert all(r.done for r in reqs)
    return [s.to_dict() for s in tracer.finished]


class TestTimelineParity:
    def test_request_timelines_equal(self, decode_spans):
        want = j_timeline.request_timelines(decode_spans)
        got = t_timeline.request_timelines(decode_spans)
        assert len(got) == 3
        assert got == want
        one = t_timeline.request_timelines(decode_spans,
                                           trace_id="ab" * 16)
        assert one == j_timeline.request_timelines(decode_spans,
                                                   trace_id="ab" * 16)
        assert len(one) == 1 and one[0]["spans"]["parent_id"] == "cd" * 8

    def test_trace_summaries_equal(self, decode_spans):
        assert (t_timeline.trace_summaries(decode_spans)
                == j_timeline.trace_summaries(decode_spans))

    def test_fleet_timeline_and_text_equal(self, tmp_path):
        """An elastic run's exports — store records (trace_<host>.json,
        REDUCE, the membership log with an eviction that blocked a round)
        and a JSONL export — merge to the same timeline and text."""
        store_dir = str(tmp_path / "store")
        store = t_elastic.FileCoordinationStore(store_dir)
        spans, t0 = [], 1.7e9

        def span(name, host, rnd, start, ms, parent=None, sid=None):
            s = {"name": name, "trace_id": "f" * 32,
                 "span_id": sid or f"{len(spans):016x}",
                 "parent_id": parent, "host": host, "pid": 1,
                 "start_unix": t0 + start, "duration_ms": ms,
                 "status": None, "attributes": {"round": rnd}}
            spans.append(s)
            return s

        for r in range(3):
            for hi, host in enumerate(("h0", "h1")):
                if r == 2 and host == "h1":
                    continue              # h1 died before round 2
                rs = span("elastic.round", host, r, r * 1.0 + hi * 0.01,
                          900.0 + 10 * hi)
                span("local_steps", host, r, r + 0.01, 500.0 + 50 * hi,
                     rs["span_id"])
                span("publish", host, r, r + 0.6, 20.0 + 5 * r,
                     rs["span_id"])
                span("wait", host, r - 1, r + 0.7, 100.0 * hi,
                     rs["span_id"])
        by = {}
        for s in spans:
            by.setdefault((s["attributes"]["round"], s["host"]), []).append(s)
        # round 0 lives only in the store, rounds 1-2 only in the JSONL
        for (r, h), group in by.items():
            if r == 0:
                store.put_json(f"rounds/r{r:06d}/trace_{h}.json",
                               {"host": h, "incarnation": 1,
                                "spans": group})
        store.put_json("rounds/r000000/REDUCE.json",
                       {"members": ["h0", "h1"], "by": "h0"})
        store.put_json("rounds/r000001/REDUCE.json",
                       {"members": ["h0", "h1"], "by": "h1"})
        store.put_json("rounds/r000002/REDUCE.json",
                       {"members": ["h0"], "by": "h0"})
        store.put_json("log/000001_evict_h1.json",
                       {"seq": 1, "event": "evict", "host": "h1",
                        "effective_round": 2, "blocked_round": 2,
                        "by": "h0", "trace_id": "f" * 32})
        jsonl = tmp_path / "trace_h.jsonl"
        jsonl.write_text("".join(json.dumps(s) + "\n" for s in spans
                                 if s["attributes"]["round"] != 0))
        want = j_timeline.build_fleet_timeline(
            store=store_dir, jsonl_paths=[str(tmp_path / "trace_*.jsonl")])
        got = t_timeline.build_fleet_timeline(
            store=store_dir, jsonl_paths=[str(tmp_path / "trace_*.jsonl")])
        assert got == want
        assert [r["critical_phase"] for r in got["rounds"]] == [
            "local_steps", "local_steps", "evicted"]
        assert (t_timeline.render_fleet_text(got)
                == j_timeline.render_fleet_text(want))

    def test_cli_renders_the_same_text(self, tmp_path, capsys,
                                       decode_spans):
        path = tmp_path / "spans.jsonl"
        path.write_text("".join(json.dumps(s) + "\n"
                                for s in decode_spans))
        assert t_timeline.main(["--jsonl", str(path), "--requests"]) == 0
        got = capsys.readouterr().out
        assert j_timeline.main(["--jsonl", str(path), "--requests"]) == 0
        assert got == capsys.readouterr().out
        assert got.count("request ") == 3


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------

class TestProfilingArithmetic:
    @pytest.mark.parametrize("fn,args", [
        ("conv2d_flops", (7, 9, 3, 3, 16, 32)),
        ("dense_flops", (768, 3072)),
        ("lstm_flops", (50, 128, 256)),
        ("train_flops", (1.5e9,)),
    ])
    def test_flops_helpers_equal_reference(self, fn, args):
        assert getattr(t_profiling, fn)(*args) == \
            getattr(j_profiling, fn)(*args)

    def test_mfu_equals_reference_with_explicit_peak(self):
        for eps, fpe, peak in ((1234.5, 7.7e9, 989e12), (8.0, 3e12, 1e15)):
            assert t_profiling.mfu(eps, fpe, peak=peak) == \
                j_profiling.mfu(eps, fpe, peak=peak)

    def test_mfu_without_peak_raises_on_the_cpu(self):
        assert t_profiling.peak_flops_per_sec() is None
        with pytest.raises(ValueError, match="no published peak"):
            t_profiling.mfu(1.0, 1.0)

    def test_peak_table_holds_no_tpu(self):
        assert t_profiling.PEAK_FLOPS == {"h100": 989e12}

    def test_time_steps_counts_samples(self):
        calls = []
        timing = t_profiling.time_steps(lambda: calls.append(1), steps=4,
                                        warmup=1)
        assert len(calls) == 5 and timing.steps == 4
        assert 0.0 <= timing.min_ms <= timing.mean_ms <= timing.max_ms

    def test_profile_steps_env(self, monkeypatch):
        monkeypatch.setenv("DL4JTPU_PROFILE_STEPS", "2:5:/x")
        assert t_profiling.profile_steps_env() == \
            j_profiling.profile_steps_env() == (2, 5, "/x")
        monkeypatch.setenv("DL4JTPU_PROFILE_STEPS", "5:2")
        with pytest.raises(ValueError):
            t_profiling.profile_steps_env()


# --------------------------------------------------------------------------
# coordination stores shared across packages
# --------------------------------------------------------------------------

class TestStoreAcrossPackages:
    @pytest.mark.parametrize("writer,reader", [
        (t_elastic, j_elastic), (j_elastic, t_elastic)])
    def test_one_package_writes_the_other_reads(self, tmp_path, writer,
                                                reader):
        w = writer.FileCoordinationStore(str(tmp_path))
        r = reader.FileCoordinationStore(str(tmp_path))
        doc = {"b": [1, 2.5], "a": {"nested": True}, "s": "x"}
        assert w.put_json("hb/r0.json", doc, overwrite=True)
        assert w.put("rounds/r000001/REDUCE.json", b"{}")
        assert not w.put("rounds/r000001/REDUCE.json", b"{}")
        assert r.get_json("hb/r0.json") == doc
        assert r.list("rounds/r000001") == ["rounds/r000001/REDUCE.json"]
        assert not r.put("rounds/r000001/REDUCE.json", b"x")
        # the bytes on disk are the same whichever package wrote them
        other = reader.FileCoordinationStore(str(tmp_path / "o"))
        other.put_json("hb/r0.json", doc, overwrite=True)
        assert (open(tmp_path / "hb" / "r0.json", "rb").read()
                == open(tmp_path / "o" / "hb" / "r0.json", "rb").read())

    def test_lease_views_agree(self, tmp_path):
        """A member published by the port is live, with its doc, in the
        reference's lease view, and the other way round."""
        store_t = t_elastic.FileCoordinationStore(str(tmp_path))
        store_j = j_elastic.FileCoordinationStore(str(tmp_path))
        t_elastic.LeaseMembership(store_t, observer="p", lease_s=5.0) \
            .publish("port", {"status": "live", "ready": True})
        j_elastic.LeaseMembership(store_j, observer="j", lease_s=5.0) \
            .publish("ref", {"status": "live", "ready": False})
        for lm in (t_elastic.LeaseMembership(store_t, observer="o",
                                             lease_s=5.0),
                   j_elastic.LeaseMembership(store_j, observer="o",
                                             lease_s=5.0)):
            view = lm.view()
            assert set(view) == {"port", "ref"}
            assert view["port"]["alive"] and view["ref"]["alive"]
            assert view["port"]["doc"]["ready"] is True
            assert lm.next_incarnation("port") == 1

    def test_key_escaping_the_store_is_refused(self, tmp_path):
        store = t_elastic.FileCoordinationStore(str(tmp_path / "fleet"))
        with pytest.raises(ValueError, match="escapes"):
            store.put("../fleet2/x", b"1")

    def test_in_memory_store_lists_direct_children(self):
        store = t_elastic.InMemoryCoordinationStore()
        store.put("hb/a.json", b"1")
        store.put("hb/sub/b.json", b"2")
        assert store.list("hb") == ["hb/a.json"]
        assert store.get("hb/sub/b.json") == b"2"

    def test_the_elastic_trainer_is_not_yet_ported(self):
        # the trainer was a stub that raised NotYetPorted; it is ported
        # now and needs a fleet configuration naming its host
        assert t_elastic.ElasticTrainer.__init__ is not object.__init__
        with pytest.raises(ValueError, match="not in fleet"):
            t_elastic.ElasticConfig(fleet=("h0", "h1"), host="h9")
