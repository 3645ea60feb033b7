"""The port's stats storage (``storage/``) and training dashboard (``ui/``:
``StatsListener``, ``ConvolutionalIterationListener``, the components
DSL, ``UIServer``) against the JAX package's, on the CPU.

Equal JSON and HTML: ``Persistable`` records and ``FileStatsStorage``
files read across the packages; every component's ``to_json`` and
``render()``; ``TrainingStats.export_html``; each ``UIServer`` endpoint's
JSON over the same stored records; records POSTed by one package's
``RemoteUIStatsStorageRouter`` to the other's server.

The listener runs on the reference test's MLP (dense 16 relu → dense 8
tanh → softmax over 5 inputs, adam 1e-3), initialised and saved by the
reference and loaded by the port. Host path: norms, means and stds within
1e-6 relative before a step (histograms exactly), within ``STEP_TOL``
1e-4 after one (a mean is compared relative to the tensor's RMS, since a
mean near 0 has no relative precision). Device path (the cases of
``tests/test_health.py::TestStatsListenerDevicePath``): one host sync per
collected window, the per-layer projection within 1e-5 relative of the
reference's (histograms exactly: no updated element sits within f32
rounding of a log10 edge, checked), the warn-once fallback to the host
path, norms without histograms. ``ConvolutionalIterationListener``'s grid
on a loaded conv net within 1e-6.
"""

import json
import logging
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.conf.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.stats import TrainingStats as JStats
import deeplearning4j_tpu.storage as j_storage
import deeplearning4j_tpu.ui as j_ui
import deeplearning4j_tpu.ui.components as j_comp
from deeplearning4j_tpu.util.serialization import load_model as j_load
from deeplearning4j_tpu.util.serialization import save_model as j_save

from deeplearning4j_tpu_torch.optimize.listeners import sync_counter
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats as TStats
import deeplearning4j_tpu_torch.storage as t_storage
import deeplearning4j_tpu_torch.ui as t_ui
import deeplearning4j_tpu_torch.ui.components as t_comp
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.serialization import load_model

PRE_STEP = 1e-6
STEP_TOL = 1e-4
REL = 1e-5
GRID = 1e-6


def _mlp_conf():
    return (JNNC.builder().seed(1).updater("adam").learning_rate(1e-3)
            .list()
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(5)).build())


def _conv_conf():
    return (JNNC.builder().seed(7).learning_rate(0.05).list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())


def _batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ui")
    mlp, conv = str(d / "mlp.zip"), str(d / "conv.zip")
    j_save(JMLN(_mlp_conf()).init(), mlp)
    j_save(JMLN(_conv_conf()).init(), conv)
    return {"mlp": mlp, "conv": conv}


def _pair(path):
    return j_load(path), load_model(path, device="cpu")


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, json.loads(r.read())


def post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def records_of(st):
    """Every record of a storage, as JSON-ready dicts, in a fixed order."""
    out = []
    for sid in st.list_session_ids():
        for tid in st.list_type_ids(sid):
            for wid in st.list_workers(sid, tid):
                s = st.get_static_info(sid, tid, wid)
                out.append(["static", None if s is None
                            else json.loads(s.to_json())])
                out.extend(["update", json.loads(r.to_json())] for r in
                           st.get_all_updates_after(sid, tid, wid, -1.0))
    return out


# ----------------------------------------------------------------------
# storage
# ----------------------------------------------------------------------

class TestStorage:
    def _records(self, pkg):
        P = pkg.Persistable
        return [("static", P("s1", "T", "w0", 1.0, {"a": 1, "nested": {
                    "x": [1.5, None, "s"]}})),
                ("update", P("s1", "T", "w0", 2.0, {"score": 0.5})),
                ("update", P("s1", "T", "w1", 2.5, {"score": 0.25})),
                ("update", P("s2", "U", "w0", 3.0, {"k": [0.1, 0.2]}))]

    def test_persistable_json_round_trip_across_packages(self):
        for (_, t), (_, j) in zip(self._records(t_storage),
                                  self._records(j_storage)):
            assert t.to_json() == j.to_json()
            assert j_storage.Persistable.from_json(t.to_json()) == j
            assert t_storage.Persistable.from_json(j.to_json()) == t

    @pytest.mark.parametrize("writer,reader", [
        (t_storage, j_storage), (j_storage, t_storage)],
        ids=["torch_file_read_by_jax", "jax_file_read_by_torch"])
    def test_file_storage_read_across_packages(self, tmp_path, writer,
                                               reader):
        p = str(tmp_path / "stats.jsonl")
        with writer.FileStatsStorage(p) as st:
            for kind, rec in self._records(writer):
                (st.put_static_info if kind == "static"
                 else st.put_update)(rec)
            want = records_of(st)
        text = open(p).read()
        with reader.FileStatsStorage(p) as st2:
            assert records_of(st2) == want
            assert st2.list_type_ids("s1") == ["T"]
            assert st2.list_workers("s1", "T") == ["w0", "w1"]
            assert st2.get_latest_update("s1", "T", "w0").data == \
                {"score": 0.5}
            st2.put_update(reader.Persistable("s3", "T", "w", 4.0, {}))
        # appending keeps the writer's lines; both packages write one
        # JSON object per line in the same form
        lines = open(p).read()
        assert lines.startswith(text)
        with writer.FileStatsStorage(p) as st3:
            assert st3.list_session_ids() == ["s1", "s2", "s3"]

    def test_listeners_and_metrics(self, tmp_path):
        st = t_storage.InMemoryStatsStorage()
        events = []

        class L(t_storage.StatsStorageListener):
            def notify(self, event, record):
                events.append((event, record.session_id))

        reg = MetricsRegistry()
        st.register_listener(L())
        st.register_listener(t_storage.StatsStorageMetricsListener(reg))
        st.put_static_info(t_storage.Persistable("s", "T", "w", 0.0, {}))
        st.put_update(t_storage.Persistable("s", "T", "w", 1.0, {}))
        st.put_update(t_storage.Persistable("s", "U", "w", 2.0, {}))
        assert events == [("static", "s"), ("update", "s"), ("update", "s")]
        c = reg.counter("stats_records_total", "", ("event", "type_id"))
        assert c.value(event="update", type_id="T") == 1
        assert c.value(event="static", type_id="T") == 1
        f = t_storage.FileStatsStorage(str(tmp_path / "x.jsonl"))
        f.close()
        with pytest.raises(ValueError, match="is closed"):
            f.put_update(t_storage.Persistable("s", "T", "w", 1.0, {}))


# ----------------------------------------------------------------------
# components and the HTML export
# ----------------------------------------------------------------------

def _components(c):
    comps = [
        c.ChartLine("l", width=300).add_series("a", [0, 1, 2], [2, 3, 1])
        .add_series("b<&>", [0.5, 1.5], [1.0, -1.0]),
        c.ChartLine("empty"),
        c.ChartScatter("s").add_series("b", [0.5, 2.0], [1.5, 0.25]),
        c.ChartHistogram("h").add_bin(0, 1, 4).add_bin(1, 2.5, 6),
        c.ChartTimeline("t").add_lane("lane", [(0, 2, "e1"), (3, 5, "e<2>")])
        .add_lane("other", [(1.25, 1.5, "x")]),
        c.ComponentTable(["x", "y"], [[1, 2.5], ["a&b", None]], title="tab"),
        c.ComponentText("hello <world>", size=11),
    ]
    comps.append(c.ComponentDiv(*comps[:3], style='margin:0;font:"x"'))
    return comps


@pytest.mark.parametrize("i", range(8))
def test_component_json_and_html_equal(i):
    t, j = _components(t_comp)[i], _components(j_comp)[i]
    assert t.to_json() == j.to_json()
    assert t.render() == j.render()
    # each package reads the other's JSON back into an equal component
    assert t_comp.Component.from_json(j.to_json()).render() == j.render()
    assert j_comp.Component.from_json(t.to_json()).render() == t.render()


def test_static_page_and_errors_equal(tmp_path):
    assert t_comp.StaticPageUtil.render_html(_components(t_comp)) == \
        j_comp.StaticPageUtil.render_html(_components(j_comp))
    t_comp.StaticPageUtil.save_html(_components(t_comp)[:2],
                                    str(tmp_path / "a.html"), title="r")
    j_comp.StaticPageUtil.save_html(_components(j_comp)[:2],
                                    str(tmp_path / "b.html"), title="r")
    assert (tmp_path / "a.html").read_text() == \
        (tmp_path / "b.html").read_text()
    with pytest.raises(ValueError):
        t_comp.ChartLine("l").add_series("a", [0, 1], [2])
    with pytest.raises(ValueError, match="unknown component type"):
        t_comp.Component.from_dict({"type": "Nope"})


def test_training_stats_export_html_equal(tmp_path):
    ts, js = TStats(), JStats()
    for s in (ts, js):
        s.record("step", 0.0, 5.0)
        s.record("average", 5.0, 2.0)
        s.record("step", 7.25, 4.5)
    assert [c.to_json() for c in ts.as_components()] == \
        [c.to_json() for c in js.as_components()]
    ts.export_html(str(tmp_path / "t.html"))
    js.export_html(str(tmp_path / "j.html"))
    html = (tmp_path / "t.html").read_text()
    assert html == (tmp_path / "j.html").read_text()
    assert "Phase timeline" in html and "average" in html


# ----------------------------------------------------------------------
# StatsListener
# ----------------------------------------------------------------------

def _close(have, want, tol, scale=None):
    return abs(have - want) <= tol * (abs(want) if scale is None else scale)


def _assert_param_stats(got, want, tol, exact_hist):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w), name
        rms = math.sqrt(w["norm"] ** 2 / max(1, sum(
            w.get("histogram", {}).get("counts", [1]))))
        for k in ("norm", "std"):
            assert _close(g[k], w[k], tol), (name, k, g[k], w[k])
        assert _close(g["mean"], w["mean"], tol,
                      scale=max(abs(w["mean"]), w["std"], rms)), name
        if "histogram" in w:
            if exact_hist:
                assert g["histogram"] == w["histogram"], name
            else:
                assert sum(g["histogram"]["counts"]) == \
                    sum(w["histogram"]["counts"])
        if "update" in w:
            u, wu = g["update"], w["update"]
            assert _close(u["norm"], wu["norm"], tol), name
            assert _close(g["update_ratio"], w["update_ratio"], tol), name


class TestHostPath:
    def test_param_stats_before_a_step(self, ckpts):
        jnet, tnet = _pair(ckpts["mlp"])
        kw = dict(collect_histograms=True, device_stats=False)
        got = t_ui.StatsListener(t_storage.InMemoryStatsStorage(),
                                 **kw)._param_stats(tnet)
        want = j_ui.StatsListener(j_storage.InMemoryStatsStorage(),
                                  **kw)._param_stats(jnet)
        assert list(got) == ["['layer_0']['W']", "['layer_0']['b']",
                             "['layer_1']['W']", "['layer_1']['b']",
                             "['layer_2']['W']", "['layer_2']['b']"]
        _assert_param_stats(got, want, PRE_STEP, exact_hist=True)

    def test_records_after_steps(self, ckpts):
        """Two fit_batch steps with collect_histograms at frequency 1: the
        posted records (score, parameters, updates) against the
        reference's."""
        jnet, tnet = _pair(ckpts["mlp"])
        x, y = _batch()
        out = {}
        for pkg_ui, pkg_st, net, key in ((t_ui, t_storage, tnet, "t"),
                                         (j_ui, j_storage, jnet, "j")):
            st = pkg_st.InMemoryStatsStorage()
            net.set_listeners(pkg_ui.StatsListener(
                st, frequency=1, session_id="h", collect_histograms=True,
                histogram_frequency=1, device_stats=False))
            for _ in range(2):
                net.fit_batch(x, y)
            out[key] = st.get_all_updates_after("h", "StatsListener",
                                                "worker_0", 0.0)
        assert len(out["t"]) == len(out["j"]) == 2
        for t, j in zip(out["t"], out["j"]):
            assert t.data["iteration"] == j.data["iteration"]
            assert _close(t.data["score"], j.data["score"], STEP_TOL)
            _assert_param_stats(t.data["parameters"], j.data["parameters"],
                                STEP_TOL, exact_hist=False)
        assert "update" in out["t"][1].data["parameters"]["['layer_0']['W']"]

    def test_norms_without_histograms(self, ckpts):
        _, tnet = _pair(ckpts["mlp"])
        st = t_storage.InMemoryStatsStorage()
        tnet.set_listeners(t_ui.StatsListener(
            st, frequency=1, session_id="legacy", collect_norms=True,
            histogram_frequency=1, device_stats=False))
        x, y = _batch()
        for _ in range(2):
            tnet.fit_batch(x, y)
        ups = st.get_all_updates_after("legacy", "StatsListener",
                                       "worker_0", 0.0)
        entry = next(iter(ups[-1].data["parameters"].values()))
        assert "norm" in entry and "histogram" not in entry
        assert entry["update"] and "histogram" not in entry["update"]

    def test_static_record(self, ckpts):
        _, tnet = _pair(ckpts["mlp"])
        st = t_storage.InMemoryStatsStorage()
        tnet.set_listeners(t_ui.StatsListener(st, session_id="s"))
        tnet.fit_batch(*_batch())
        s = st.get_static_info("s", "StatsListener", "worker_0").data
        assert s["model_class"] == "MultiLayerNetwork"
        assert s["num_params"] == tnet.num_params() == 259
        assert json.loads(s["config_json"]) == json.loads(
            tnet.conf.to_json())
        assert s["devices"] == ["cpu"]           # no card on this box
        up = st.get_latest_update("s", "StatsListener", "worker_0").data
        assert "device_memory" not in up and up["host_memory_bytes"] > 0


def _near_edges(arr):
    a = np.abs(np.asarray(arr, np.float64).ravel())
    ok = np.isfinite(a) & (a > 0)
    lg = np.log10(np.where(ok, a, 1.0))
    return np.flatnonzero(ok & (np.abs(lg - np.round(lg)) < 1e-6)
                          & (lg >= -12) & (lg <= 4))


class TestDevicePath:
    def test_one_sync_per_window_and_the_projection(self, ckpts):
        jnet, tnet = _pair(ckpts["mlp"])
        x, y = _batch()
        syncs = sync_counter()
        ups = {}
        for pkg_ui, pkg_st, net, key in ((t_ui, t_storage, tnet, "t"),
                                         (j_ui, j_storage, jnet, "j")):
            st = pkg_st.InMemoryStatsStorage()
            net.set_listeners(pkg_ui.StatsListener(
                st, frequency=2, session_id="dev", device_stats=True))
            s0 = syncs.total()
            for _ in range(8):
                net.fit_batch(x, y)
            if key == "t":
                assert syncs.total() - s0 == 4           # 4 windows
            ups[key] = st.get_all_updates_after("dev", "StatsListener",
                                                "worker_0", 0.0)
        for v, ps in tnet.params.items():
            for k, p in ps.items():
                assert _near_edges(p.detach().numpy()).size == 0, (v, k)
        assert [u.data["iteration"] for u in ups["t"]] == [2, 4, 6, 8]
        for t, j in zip(ups["t"], ups["j"]):
            assert t.data["iteration"] == j.data["iteration"]
            assert _close(t.data["score"], j.data["score"], REL)
            tp, jp = t.data["parameters"], j.data["parameters"]
            assert list(tp) == list(jp) == ["layer_0", "layer_1", "layer_2"]
            for name, w in jp.items():
                g = tp[name]
                assert set(g) == set(w), name
                for k in ("norm", "update_ratio"):
                    assert _close(g[k], w[k], REL), (name, k)
                assert _close(g["update"]["norm"], w["update"]["norm"], REL)
                assert g["histogram"] == w["histogram"], name
                assert g["update"]["histogram"] == w["update"]["histogram"]
                for k in ("act_mean", "act_std", "act_zero_frac"):
                    if k in w:
                        assert abs(g[k] - w[k]) <= REL * abs(w[k]) + 1e-6
        last = ups["t"][-1].data
        from deeplearning4j_tpu_torch.util import health
        snap = health.latest_stats(tnet).value()
        proj = t_ui.StatsListener(None)._device_param_view(snap)
        assert json.loads(json.dumps(proj)) == last["parameters"]
        assert last["model_stats"]["layers"] == json.loads(json.dumps(snap))

    def test_device_stats_true_enables_on_model(self):
        class FakeModel:
            enabled = False

            def enable_health_stats(self, config=True):
                self.enabled = True

        m = FakeModel()
        t_ui.StatsListener(t_storage.InMemoryStatsStorage(),
                           device_stats=True).on_epoch_start(m, 0)
        assert m.enabled

    def test_falls_back_once_when_the_step_has_no_stats(self, ckpts,
                                                         caplog):
        """A net whose step never produces stats (here its
        enable_health_stats is a no-op): after the first, expected miss
        the listener warns once and posts the host parameter path."""
        _, tnet = _pair(ckpts["mlp"])
        tnet.enable_health_stats = lambda config=True: None
        st = t_storage.InMemoryStatsStorage()
        tnet.set_listeners(t_ui.StatsListener(
            st, frequency=1, session_id="fb", histogram_frequency=1,
            device_stats=True))
        x, y = _batch()
        with caplog.at_level(logging.WARNING, "deeplearning4j_tpu_torch"):
            for _ in range(3):
                tnet.fit_batch(x, y)
        ups = st.get_all_updates_after("fb", "StatsListener", "worker_0",
                                       0.0)
        assert "parameters" not in ups[0].data
        assert ups[-1].data["parameters"]["['layer_0']['W']"]["norm"] > 0
        warned = [r for r in caplog.records
                  if "falling back to the host parameter path" in r.message]
        assert len(warned) == 1


def test_conv_activation_grid(ckpts):
    """ConvolutionalIterationListener on a loaded conv net: the posted
    grid against the reference's, then served by /api/activations."""
    jnet, tnet = _pair(ckpts["conv"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    got = {}
    for pkg_ui, pkg_st, net, key in ((t_ui, t_storage, tnet, "t"),
                                     (j_ui, j_storage, jnet, "j")):
        st = pkg_st.InMemoryStatsStorage()
        net.set_listeners(pkg_ui.ConvolutionalIterationListener(
            st, probe_input=x, frequency=1, session_id="conv",
            max_channels=3, max_size=4))
        net.fit_batch(x, y)
        got[key] = (st, st.get_latest_update(
            "conv", "ConvolutionalListener", "worker_0").data)
    t, j = got["t"][1], got["j"][1]
    assert (t["layer"], t["shape"], t["iteration"]) == \
        (j["layer"], j["shape"], j["iteration"]) == ("layer_0", [6, 6, 4], 1)
    np.testing.assert_allclose(np.asarray(t["maps"]), np.asarray(j["maps"]),
                               rtol=0, atol=GRID)
    srv = t_ui.UIServer(port=0, registry=MetricsRegistry()).attach(
        got["t"][0])
    try:
        assert get_json(srv.port, "/api/activations?sid=conv")[1] == t
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------

ENDPOINTS = ("/api/sessions", "/api/overview?sid=run",
             "/api/static?sid=run", "/api/histograms?sid=run",
             "/api/flow?sid=run", "/api/activations?sid=run",
             "/api/tsne?sid=run", "/api/overview?sid=absent",
             "/api/flow?sid=absent", "/nope")


@pytest.fixture(scope="module")
def stats_file(ckpts, tmp_path_factory):
    """A FileStatsStorage written by the port: a StatsListener run with
    histograms, a conv activation record and an uploaded embedding."""
    path = str(tmp_path_factory.mktemp("file") / "stats.jsonl")
    _, tnet = _pair(ckpts["mlp"])
    with t_storage.FileStatsStorage(path) as st:
        tnet.set_listeners(t_ui.StatsListener(
            st, frequency=1, session_id="run", collect_histograms=True,
            histogram_frequency=1, device_stats=False))
        x, y = _batch(1)
        for _ in range(3):
            tnet.fit_batch(x, y)
        st.put_update(t_storage.Persistable(
            "run", "ConvolutionalListener", "worker_0", 5.0,
            {"iteration": 3, "layer": "layer_0", "shape": [2, 2, 1],
             "maps": [[[0.0, 1.0], [0.5, 0.25]]]}))
        st.put_update(t_storage.Persistable(
            "run", "TsneModule", "upload", 6.0,
            {"coords": [[0, 1], [2, 3]], "labels": ["a", "b"]}))
    return path


def _serve_all(pkg_ui, pkg_st, path):
    st = pkg_st.FileStatsStorage(path)
    srv = pkg_ui.UIServer(port=0).attach(st)
    try:
        out = {}
        for ep in ENDPOINTS:
            try:
                out[ep] = get_json(srv.port, ep)
            except urllib.error.HTTPError as e:
                out[ep] = (e.code, json.loads(e.read()))
        return out
    finally:
        srv.stop()
        st.close()


def test_endpoints_equal_over_the_same_records(stats_file):
    got = _serve_all(t_ui, t_storage, stats_file)
    want = _serve_all(j_ui, j_storage, stats_file)
    assert got == want
    assert got["/api/sessions"] == (200, ["run"])
    assert got["/api/overview?sid=run"][1]["iterations"] == [1, 2, 3]
    hist = got["/api/histograms?sid=run"][1]
    assert len(hist["latest"]["parameters"]) == 6
    assert got["/nope"][0] == 404


class TestServer:
    @pytest.fixture
    def server(self):
        st = t_storage.InMemoryStatsStorage()
        srv = t_ui.UIServer(port=0, device="cpu").attach(st)
        yield srv, st
        srv.stop()

    def test_page_metrics_and_debug(self, server):
        srv, _ = server
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/",
                                    timeout=10) as r:
            assert b"training overview" in r.read()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "# TYPE device_memory_bytes gauge" in text
        for ep in ("/debug/health", "/debug/flightrecorder",
                   "/debug/timeline"):
            code, body = get_json(srv.port, ep)
            assert code == 200 and isinstance(body, dict), ep
        assert post(srv.port, "/profile?seconds=x", b"")[0] == 400

    def test_traceparent_joins_the_callers_trace(self, server):
        srv, _ = server
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/sessions",
            headers={"traceparent": tp})
        with urllib.request.urlopen(req, timeout=10) as r:
            echoed = r.headers["traceparent"]
        assert echoed.startswith("00-" + "ab" * 16 + "-")
        assert echoed != tp                     # the ui.request span's id

    def test_tsne_coords_and_vectors(self, server):
        srv, st = server
        code, body = post(srv.port, "/api/tsne", json.dumps(
            {"sid": "t", "coords": [[0, 1], [2, 3]],
             "labels": ["a", "b"]}).encode())
        assert (code, body) == (200, {"ok": True, "n": 2})
        got = get_json(srv.port, "/api/tsne?sid=t")[1]
        assert got["coords"] == [[0, 1], [2, 3]]
        # raw vectors are embedded server-side on the server's device (the
        # reference's test_tsne_module_embeds_vectors case)
        vecs = np.random.RandomState(0).randn(60, 8).tolist()
        code, body = post(srv.port, "/api/tsne", json.dumps(
            {"sid": "v", "vectors": vecs, "iterations": 20,
             "perplexity": 10}).encode())
        assert (code, body) == (200, {"ok": True, "n": 60})
        coords = np.asarray(get_json(srv.port, "/api/tsne?sid=v")[1]["coords"])
        assert coords.shape == (60, 2) and np.all(np.isfinite(coords))
        assert sorted(st.list_session_ids()) == ["t", "v"]

    def test_malformed_posts_rejected_not_fatal(self, server):
        srv, _ = server
        assert post(srv.port, "/api/remote", b"not json")[0] == 400
        assert post(srv.port, "/api/nope", b"{}")[0] == 404
        assert get_json(srv.port, "/api/sessions") == (200, [])


@pytest.mark.parametrize("router_pkg,server_pkg", [
    ((t_storage, t_ui), (j_storage, j_ui)),
    ((j_storage, j_ui), (t_storage, t_ui))],
    ids=["torch_router_to_jax_server", "jax_router_to_torch_server"])
def test_remote_router_across_packages(ckpts, router_pkg, server_pkg):
    """One package's RemoteUIStatsStorageRouter posts a StatsListener
    run's records to the other's server: they land unchanged."""
    r_st, r_ui = router_pkg
    s_st, s_ui = server_pkg
    recv = s_st.InMemoryStatsStorage()
    srv = s_ui.UIServer(port=0).attach(recv)
    try:
        local = r_st.InMemoryStatsStorage()
        router = r_st.RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{srv.port}")

        class Tee(r_st.StatsStorageRouter):
            def put_static_info(self, rec):
                local.put_static_info(rec)
                router.put_static_info(rec)

            def put_update(self, rec):
                local.put_update(rec)
                router.put_update(rec)

        jnet, tnet = _pair(ckpts["mlp"])
        net = tnet if r_ui is t_ui else jnet
        net.set_listeners(r_ui.StatsListener(
            Tee(), frequency=1, session_id="remote", collect_norms=True,
            histogram_frequency=1, device_stats=False))
        x, y = _batch(2)
        for _ in range(3):
            net.fit_batch(x, y)
        router.close()
        assert router._posted == 4 and router._dropped == 0
        assert records_of(recv) == records_of(local)
        assert get_json(srv.port, "/api/overview?sid=remote")[1][
            "iterations"] == [1, 2, 3]
    finally:
        srv.stop()


def test_remote_router_breaker_drops_when_the_ui_is_down():
    from deeplearning4j_tpu_torch.util.resilience import (CircuitBreaker,
                                                          ManualClock,
                                                          RetryPolicy)
    clock = ManualClock()
    sent = []

    def transport(url, body, timeout):
        sent.append(body)
        raise IOError("down")

    router = t_storage.RemoteUIStatsStorageRouter(
        "http://127.0.0.1:1", clock=clock, transport=transport,
        retry_policy=RetryPolicy(max_attempts=2, initial_backoff=0.0,
                                 max_backoff=0.0, clock=clock),
        breaker=CircuitBreaker(failure_threshold=3, reset_timeout_s=60.0,
                               clock=clock))
    for i in range(4):
        router.put_update(t_storage.Persistable("s", "T", "w", float(i),
                                                {"i": i}))
    with pytest.warns(UserWarning, match="dropped 4 records"):
        router.close()
    assert router._posted == 0 and router._dropped == 4
    assert len(sent) == 3                        # then the breaker opened
    assert router.breaker.state == "open"
    with pytest.raises(ValueError, match="closed"):
        router.put_update(t_storage.Persistable("s", "T", "w", 9.0, {}))


def test_param_and_gradient_listener_reports_the_update(ckpts):
    """The listener's host copies are copies: on the CPU, where ``.cpu()``
    aliases the live parameters, its update magnitudes match the
    reference's within ``STEP_TOL`` instead of reading 0."""
    from deeplearning4j_tpu.optimize.listeners import \
        ParamAndGradientIterationListener as JListener
    from deeplearning4j_tpu_torch.optimize.listeners import \
        ParamAndGradientIterationListener as TListener
    jnet, tnet = _pair(ckpts["mlp"])
    x, y = _batch()
    logs = {}
    for cls, net, key in ((TListener, tnet, "t"), (JListener, jnet, "j")):
        logs[key] = []
        net.set_listeners(cls(print_iterations=2,
                              log_fn=logs[key].append))
        for _ in range(2):
            net.fit_batch(x, y)

    def ratios(text):
        return [float(line.rsplit("ratio=", 1)[1])
                for line in text.splitlines() if "ratio=" in line]

    got, want = ratios(logs["t"][-1]), ratios(logs["j"][-1])
    assert len(got) == len(want) == 6 and min(got) > 0
    for g, w in zip(got, want):
        assert _close(g, w, STEP_TOL + 5e-3)    # printed to 3 digits
