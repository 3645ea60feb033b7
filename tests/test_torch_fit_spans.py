"""The phases of a training update (``util.tracing.phase``) on the CPU:
``fit.batch_wait``, ``fit.forward_backward``, ``fit.updater`` and
``fit.device_wait``, as profiler ranges while a ``torch.profiler``
records and as spans of the net's ``tracer`` (under a ``fit.step`` span);
nothing at all with neither; the spans on the profiler's clock; and
``fit_phase_seconds{model, phase}``, one observation per update
(``updater``) and per dispatch (``device_wait``)."""

import collections
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import deeplearning4j_tpu_torch.nn.conf.recurrent as TR
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import ingest
from deeplearning4j_tpu_torch.util import profiling as _profiling
from deeplearning4j_tpu_torch.util import tracing
from deeplearning4j_tpu_torch.util.tracing import Tracer

PHASES = ("fit.batch_wait", "fit.forward_backward", "fit.updater",
          "fit.device_wait")


def _mln():
    conf = (NeuralNetConfiguration.builder().seed(1).updater("adam")
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph():
    conf = (NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(0.01).graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf, device="cpu").init()


def _tbptt_mln():
    conf = (NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(5e-3).list()
            .layer(TR.GravesLSTM(n_out=5, activation="tanh"))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(6))
            .backprop_type("truncated_bptt")
            .t_bptt_forward_length(4).t_bptt_backward_length(4)
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


NETS = {"MultiLayerNetwork": _mln, "ComputationGraph": _graph}


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _profiled_fit(net):
    """One fit of four staged batches under a CPU profiler, after one
    unprofiled fit (the first call's one-time costs left out); returns
    (the profile, the updates it made)."""
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))
    before = net._update_count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        net.fit(ArrayDataSetIterator(x, y, 16))
    return prof, net._update_count - before


def _ranges(prof, prefix="fit."):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def _phase_counts(model):
    h = ingest.phase_histogram()
    return tuple(h.count(model=model, phase=p)
                 for p in ("updater", "device_wait"))


@pytest.mark.parametrize("model", sorted(NETS))
def test_profiled_fit_records_each_updates_phases_in_order(model):
    """Per update the four phase ranges, one after the other on the
    dispatching thread, and one more batch wait that finds the data at
    its end; the updater's arithmetic nested under ``fit.updater``."""
    prof, updates = _profiled_fit(NETS[model]())
    assert updates == 4
    ranges = sorted(_ranges(prof), key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == list(PHASES) * 4 + ["fit.batch_wait"]
    assert len({e.thread for e in ranges}) == 1
    for a, b in zip(ranges, ranges[1:]):
        assert a.time_range.end <= b.time_range.start
    for upd in (e for e in ranges if e.name == "fit.updater"):
        ops = collections.Counter()
        stack = list(upd.cpu_children)
        while stack:
            e = stack.pop()
            ops[e.name] += 1
            stack.extend(e.cpu_children)
        # adam's passes and the in-place update of two layers' W and b
        assert ops["aten::sub_"] == 4
        assert ops["aten::sqrt"] >= 4


def test_a_listener_may_switch_profiles_inside_a_step():
    """A listener that stops one profile and starts the next (as a
    benchmark's traced steps do) leaves no phase range open across the
    switch: each profile holds whole phases only, and the process goes on
    unharmed."""
    net = _graph()
    profs = []

    class Switch:
        def iteration_done(self, net, iteration, score):
            if profs:
                profs[-1].stop()
            if len(profs) < 3:
                profs.append(profile(activities=[ProfilerActivity.CPU]))
                profs[-1].start()

    net.set_listeners(Switch())
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))
    assert len(profs) == 3
    for prof in profs[:2]:
        names = [e.name for e in sorted(_ranges(prof),
                                        key=lambda e: e.time_range.start)]
        assert names == ["fit.device_wait", "fit.batch_wait",
                         "fit.forward_backward", "fit.updater"]
    gc.collect()
    net.fit(ArrayDataSetIterator(x, y, 16))


def test_no_profiler_no_tracer_creates_nothing(monkeypatch):
    """The phases' one check: no span object, no id, no profiler range."""
    made = collections.Counter()
    real_span = tracing.Span
    real_range = torch.autograd.profiler.record_function

    def span(*a, **k):
        made["span"] += 1
        return real_span(*a, **k)

    def record_function(*a, **k):
        made["range"] += 1
        return real_range(*a, **k)

    def span_id():
        made["id"] += 1
        return "0" * 16

    monkeypatch.setattr(tracing, "Span", span)
    monkeypatch.setattr(tracing, "_new_span_id", span_id)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    for model in sorted(NETS):
        net = NETS[model]()
        x, y = _data()
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        assert net.iteration_count == 8
    assert made == {}
    assert tracing.phase("fit.step") is tracing.phase("fit.updater")


def test_spans_line_up_with_the_profiler_ranges():
    """With a tracer attached, each exported phase span starts and lasts
    within 1 ms of the profiler's range for it on the profiler's absolute
    (Unix-epoch) clock, and hangs under its step's span."""
    net = _mln()
    net.tracer = Tracer()
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))
    net.tracer.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        net.fit(ArrayDataSetIterator(x, y, 16))
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = [s.to_dict() for s in net.tracer.finished]
    steps = {s["span_id"]: s for s in spans if s["name"] == "fit.step"}
    assert len(steps) == 5
    assert not [e for e in _ranges(prof) if e.name == "fit.step"]
    for s in spans:
        if s["name"] in PHASES:
            parent = steps[s["parent_id"]]
            assert parent["trace_id"] == s["trace_id"]
            assert parent["start_unix"] <= s["start_unix"]
    ranges = collections.defaultdict(list)
    for e in _ranges(prof):
        ranges[e.name].append(e)
    for name in PHASES:
        got = sorted((s for s in spans if s["name"] == name),
                     key=lambda s: s["start_unix"])
        want = sorted(ranges[name], key=lambda e: e.time_range.start)
        assert len(got) == len(want) > 0
        for s, e in zip(got, want):
            start_unix = (base_ns + e.time_range.start * 1e3) * 1e-9
            assert abs(s["start_unix"] - start_unix) < 1e-3, name
            dur_ms = (e.time_range.end - e.time_range.start) * 1e-3
            assert abs(s["duration_ms"] - dur_ms) < 1.0, name


def test_the_tracer_reaches_the_stager():
    """One ``tracer`` attribute serves the fit loop and its stager: each
    staged batch is an ``ingest.stage`` span with its bytes."""
    net = _graph()
    assert net.tracer is None
    net.tracer = Tracer()
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))
    stages = net.tracer.find("ingest.stage")
    assert len(stages) == 4
    assert all(s.attributes == {"stage": "fit", "bytes": 16 * (4 + 3) * 4}
               for s in stages)
    assert len(net.tracer.find("fit.updater")) == 4


def test_stage_range_lands_in_an_all_threads_profile():
    """The stager's producer thread emits its ``ingest.stage`` range, with
    its copies inside, while a profile of every thread (the program's own
    captures) records."""
    batches = [(np.zeros((4, 2), np.float32), None, None)] * 3
    prof = _profiling._profiler()
    prof.start()
    try:
        with torch.profiler.record_function("consumer"):
            list(ingest.stage(iter(batches), stage_name="t_range",
                              device="cpu"))
    finally:
        prof.stop()
    got = [e for e in prof.events() if e.name == "ingest.stage"]
    (consumer,) = [e for e in prof.events() if e.name == "consumer"]
    assert len(got) == 3
    assert {e.thread for e in got} != {consumer.thread}
    assert all(any(c.name == "aten::to" for c in e.cpu_children)
               for e in got)


@pytest.mark.parametrize("path", ["fit", "scan", "tbptt"])
def test_phase_counter_counts_each_update(path):
    """``fit_phase_seconds``: ``updater`` once per update, ``fit_scan``'s
    and TBPTT's several updates a dispatch included; ``device_wait`` once
    per dispatch."""
    if path == "tbptt":
        net, model = _tbptt_mln(), "MultiLayerNetwork"
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 12, 6)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 12))]
        upd0, wait0 = _phase_counts(model)
        u0 = net._update_count
        net.fit(x, y, epochs=2)
        dispatches = 2
    else:
        net, model = _graph(), "ComputationGraph"
        x, y = _data()
        upd0, wait0 = _phase_counts(model)
        u0 = net._update_count
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=2,
                coalesce=4 if path == "scan" else None)
        dispatches = 2 if path == "scan" else 8
    upd1, wait1 = _phase_counts(model)
    updates = net._update_count - u0
    assert updates == (6 if path == "tbptt" else 8)
    assert upd1 - upd0 == updates
    assert wait1 - wait0 == dispatches


def test_batch_wait_is_the_host_gap():
    """``fit.batch_wait`` is the interval ``fit_host_gap_seconds`` times:
    one observation per dispatch after the first, each enclosing that
    dispatch's batch-wait span by no more than the phases' own entry."""
    net = _mln()
    net.tracer = Tracer()
    h = ingest.host_gap_histogram()
    count0 = h.count(model="MultiLayerNetwork")
    sum0 = h.sum(model="MultiLayerNetwork")
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))
    count = h.count(model="MultiLayerNetwork") - count0
    gap_s = h.sum(model="MultiLayerNetwork") - sum0
    waits = sorted(net.tracer.find("fit.batch_wait"),
                   key=lambda s: s.start_unix)
    assert len(waits) == 5 and count == 3
    # the second to fourth fetches are the three observed gaps; the
    # fifth finds the data at its end
    wait_s = sum(s.duration_ms for s in waits[1:4]) * 1e-3
    assert wait_s <= gap_s < wait_s + 3e-3
