"""The port's graph vertices, preprocessors and ComputationGraph runtime
against the JAX package's, on the CPU: the cases of ``tests/test_graph.py``
(vertices, multi-input and multi-output graphs, minibatch tracking,
truncated BPTT, gradient checks), ``fit``/``feed_forward``, and the
BinomialSampling and Composable preprocessors.

Configurations are built through both packages' DSLs with the same calls
and compared as parsed JSON. Runtime parity starts from the reference's
weights (a reference net is initialised and saved, the port loads the
checkpoint); inputs come from numpy seeds; dropout is off. Tolerances,
relative to the largest magnitude compared: f32 outputs, losses and
step-0 gradients 1e-5; a few sgd or adam steps 1e-4; masks and example
counts exactly; the f64 gradient checks at the reference tests' 1e-5.
A Bernoulli draw cannot match jax's threefry: sampling is compared where
the probabilities pin the draw (0 or 1), and otherwise by its own rules
(fresh per step, reproducible per seed, straight-through gradient).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph as JG
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu.nn.conf.recurrent as JR
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.util.serialization import save_model as j_save

import deeplearning4j_tpu_torch.nn.conf.graph as TG
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
import deeplearning4j_tpu_torch.nn.conf.recurrent as TR
from deeplearning4j_tpu_torch.gradientcheck import check_graph_gradients
from deeplearning4j_tpu_torch.nn.conf import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import NotYetPorted
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TCGC
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.util.serialization import load_model

F32 = 1e-5
STEPS = 1e-4


class _Pkg:
    def __init__(self, nnc, it, layers, rec, graph, pre):
        self.NNC, self.InputType, self.L, self.R, self.G, self.P = (
            nnc, it, layers, rec, graph, pre)


JAX = _Pkg(JNNC, JInputType, JL, JR, JG, JP)
TORCH = _Pkg(TNNC, TInputType, TL, TR, TG, TP)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _base(p, updater="adam", lr=1e-2):
    return p.NNC.builder().seed(42).updater(updater).learning_rate(lr)


# --------------------------------------------------------------------------
# graphs built the same way through both DSLs
# --------------------------------------------------------------------------


def _merge_subset(p):
    return (_base(p).graph_builder().add_inputs("x1", "x2")
            .add_layer("d1", p.L.DenseLayer(n_out=4, activation="tanh"), "x1")
            .add_layer("d2", p.L.DenseLayer(n_out=4, activation="tanh"), "x2")
            .add_vertex("merged", p.G.MergeVertex(), "d1", "d2")
            .add_vertex("sub", p.G.SubsetVertex(from_idx=1, to_idx=6),
                        "merged")
            .add_vertex("norm", p.G.L2NormalizeVertex(), "sub")
            .add_vertex("scaled", p.G.ScaleVertex(scale=2.5), "norm")
            .add_vertex("shifted", p.G.ShiftVertex(shift=-0.5), "scaled")
            .add_layer("out", p.L.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "shifted")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(3),
                             p.InputType.feed_forward(5)).build())


def _siamese(p):
    return (_base(p).graph_builder().add_inputs("a", "b")
            .add_vertex("stacked", p.G.StackVertex(), "a", "b")
            .add_layer("tower", p.L.DenseLayer(n_out=6, activation="tanh"),
                       "stacked")
            .add_vertex("ua", p.G.UnstackVertex(from_idx=0, stack_size=2),
                        "tower")
            .add_vertex("ub", p.G.UnstackVertex(from_idx=1, stack_size=2),
                        "tower")
            .add_vertex("dist", p.G.L2Vertex(), "ua", "ub")
            .add_layer("out", p.L.OutputLayer(n_out=1, activation="sigmoid",
                                              loss="xent"), "dist")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(4),
                             p.InputType.feed_forward(4)).build())


def _seq2seq(p):
    """LSTM encoder → LastTimeStep → DuplicateToTimeSeries over the
    decoder input's length → merge → LSTM decoder → RnnOutput."""
    return (_base(p).graph_builder().add_inputs("enc_in", "dec_in")
            .add_layer("enc", p.R.GravesLSTM(n_out=6, activation="tanh"),
                       "enc_in")
            .add_vertex("last", p.G.LastTimeStepVertex(), "enc")
            .add_vertex("dup", p.G.DuplicateToTimeSeriesVertex(
                reference_input="dec_in"), "last", "dec_in")
            .add_vertex("cat", p.G.MergeVertex(), "dup", "dec_in")
            .add_layer("dec", p.R.GravesLSTM(n_out=5, activation="tanh"),
                       "cat")
            .add_layer("out", p.L.RnnOutputLayer(n_out=4, activation="softmax",
                                                 loss="mcxent"), "dec")
            .set_outputs("out")
            .set_input_types(p.InputType.recurrent(3),
                             p.InputType.recurrent(4)).build())


def _stack_rebuild(p):
    """The reference's minibatch-tracking graph: FeedForwardToRnn after a
    StackVertex must rebuild with the stacked example count."""
    return (_base(p).graph_builder().add_inputs("x1", "x2")
            .add_vertex("stack", p.G.StackVertex(), "x1", "x2")
            .add_layer("d", p.L.DenseLayer(n_out=6, activation="tanh"),
                       "stack")
            .add_vertex("to_rnn", p.G.PreprocessorVertex(
                p.P.FeedForwardToRnnPreProcessor()), "d")
            .add_layer("last", p.R.LastTimeStepLayer(), "to_rnn")
            .add_layer("out", p.L.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "last")
            .set_outputs("out")
            .set_input_types(p.InputType.recurrent(4),
                             p.InputType.recurrent(4)).build())


def _multi_output(p):
    return (_base(p).graph_builder().add_inputs("in")
            .add_layer("trunk", p.L.DenseLayer(n_out=8, activation="relu"),
                       "in")
            .add_layer("cls", p.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "trunk")
            .add_layer("reg", p.L.OutputLayer(n_out=3, activation="identity",
                                              loss="mse"), "trunk")
            .set_outputs("cls", "reg")
            .set_input_types(p.InputType.feed_forward(5)).build())


def _composable(p):
    pre = p.P.ComposableInputPreProcessor(children=(
        p.P.ZeroMeanPreProcessor(), p.P.UnitVarianceProcessor()))
    return (_base(p).graph_builder().add_inputs("in")
            .add_layer("d", p.L.DenseLayer(n_out=6, activation="sigmoid"),
                       "in")
            .add_vertex("std", p.G.PreprocessorVertex(pre), "d")
            .add_layer("out", p.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "std")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(4)).build())


GRAPHS = {"merge_subset": _merge_subset, "siamese": _siamese,
          "seq2seq": _seq2seq, "stack_rebuild": _stack_rebuild,
          "multi_output": _multi_output, "composable": _composable}


def _data(name, seed=0, b=6, t=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    onehot = lambda c, *s: np.eye(c, dtype=np.float32)[     # noqa: E731
        rng.integers(0, c, s)]
    if name == "merge_subset":
        return [f(b, 3), f(b, 5)], [onehot(3, b)]
    if name == "siamese":
        return [f(b, 4), f(b, 4)], [rng.uniform(size=(b, 1)).astype(
            np.float32)]
    if name == "seq2seq":
        return [f(b, t + 2, 3), f(b, t, 4)], [onehot(4, b, t)]
    if name == "stack_rebuild":
        return [f(b, t, 4), f(b, t, 4)], [onehot(3, 2 * b)]
    if name == "multi_output":
        return [f(b, 5)], [onehot(2, b), f(b, 3)]
    return [f(b, 4)], [onehot(2, b)]


def _pair(name, tmp_path):
    jnet = JComputationGraph(GRAPHS[name](JAX)).init()
    path = str(tmp_path / f"{name}.zip")
    j_save(jnet, path)
    return jnet, load_model(path, device="cpu")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_json_and_yaml_equal_reference(name):
    got = GRAPHS[name](TORCH)
    want = GRAPHS[name](JAX)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    back = TCGC.from_json(want.to_json())
    assert json.loads(back.to_json()) == json.loads(want.to_json())
    assert json.loads(TCGC.from_yaml(got.to_yaml()).to_json()) == \
        json.loads(got.to_json())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_outputs_and_activations_equal_reference(name, tmp_path):
    jnet, tnet = _pair(name, tmp_path)
    xs, _ = _data(name)
    jacts = jnet.feed_forward([jnp.asarray(x) for x in xs])
    tacts = tnet.feed_forward(xs)
    assert set(tacts) == set(jacts)
    for k in jacts:
        assert tuple(tacts[k].shape) == tuple(jacts[k].shape), k
        assert _rel(_np(tacts[k]), jacts[k]) <= F32, k
    jout = jnet.output(xs)
    tout = tnet.output(xs)
    for a, b in zip(tout if isinstance(tout, list) else [tout],
                    jout if isinstance(jout, list) else [jout]):
        assert _rel(_np(a), b) <= F32


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_step0_grads_and_steps_equal_reference(name, tmp_path):
    import jax
    jnet, tnet = _pair(name, tmp_path)
    xs, ys = _data(name, seed=1)
    jl, jg = jax.value_and_grad(lambda p: jnet._loss_fn(
        p, jnet._states_map(), [jnp.asarray(x) for x in xs],
        [jnp.asarray(y) for y in ys], None, None)[0])(jnet.params)
    tl, tg = tnet._loss_and_grads([torch.from_numpy(x) for x in xs],
                                  [torch.from_numpy(y) for y in ys], None)
    assert _rel(float(tl), float(jl)) <= F32
    for v, gs in tg.items():
        for k, g in gs.items():
            assert _rel(g.numpy(), jg[v][k]) <= F32, (v, k)
    jls = [float(jnet.fit_batch(xs, ys)) for _ in range(3)]
    tls = [float(tnet.fit_batch(xs, ys)) for _ in range(3)]
    assert _rel(tls, jls) <= STEPS


# --------------------------------------------------------------------------
# each vertex alone: output, mask and example count
# --------------------------------------------------------------------------

VERTICES = [
    ("merge", lambda G: G.MergeVertex(), [(3, 4, 2), (3, 4, 5)], True),
    ("subset", lambda G: G.SubsetVertex(from_idx=1, to_idx=3), [(3, 4, 6)],
     True),
    ("stack", lambda G: G.StackVertex(), [(3, 4, 2), (3, 4, 2)], True),
    ("unstack", lambda G: G.UnstackVertex(from_idx=1, stack_size=3),
     [(6, 4, 2)], True),
    ("scale", lambda G: G.ScaleVertex(scale=-1.5), [(3, 4, 2)], True),
    ("shift", lambda G: G.ShiftVertex(shift=0.25), [(3, 4, 2)], True),
    ("l2", lambda G: G.L2Vertex(), [(3, 4, 2), (3, 4, 2)], False),
    ("l2normalize", lambda G: G.L2NormalizeVertex(), [(3, 4, 2)], True),
    ("preprocessor", lambda G: G.PreprocessorVertex(
        (JP if G is JG else TP).RnnToFeedForwardPreProcessor()),
     [(3, 4, 2)], True),
    ("last_time_step", lambda G: G.LastTimeStepVertex(), [(3, 4, 2)], True),
    ("duplicate_to_time_series",
     lambda G: G.DuplicateToTimeSeriesVertex(reference_input="r"),
     [(3, 2), (3, 4, 5)], True),
    ("elementwise", lambda G: G.ElementWiseVertex(op="max"),
     [(3, 4, 2), (3, 4, 2)], True),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,make,shapes,mask_ok", VERTICES,
                         ids=[v[0] for v in VERTICES])
def test_vertex_equals_reference(name, make, shapes, mask_ok, masked):
    rng = np.random.default_rng(len(name))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    masks = [None] * len(xs)
    if masked and mask_ok:
        masks = [(rng.random(s[:2]) > 0.3).astype(np.float32)
                 if len(s) == 3 else None for s in shapes]
        for m in masks:
            if m is not None:
                m[:, 0] = 1.0
    jv, tv = make(JG), make(TG)
    assert TG.vertex_to_dict(tv) == JG.vertex_to_dict(jv)
    assert TG.vertex_from_dict(JG.vertex_to_dict(jv)) == tv
    jm = [None if m is None else jnp.asarray(m) for m in masks]
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    jy, _ = jv.apply({}, [jnp.asarray(x) for x in xs], masks=jm,
                     minibatch=shapes[0][0])
    ty, _ = tv.apply({}, [torch.from_numpy(x) for x in xs], masks=tm,
                     minibatch=shapes[0][0])
    assert tuple(ty.shape) == tuple(jy.shape)
    assert _rel(_np(ty), jy) <= 1e-6
    jom = jv.output_mask(jm, minibatch=shapes[0][0])
    tom = tv.output_mask(tm, minibatch=shapes[0][0])
    assert (jom is None) == (tom is None)
    if jom is not None:
        assert np.array_equal(_np(tom), np.asarray(jom))
    mbs = [s[0] for s in shapes]
    assert tv.output_minibatch(mbs) == jv.output_minibatch(mbs)
    its = [JInputType.recurrent(s[-1], s[1]) if len(s) == 3
           else JInputType.feed_forward(s[-1]) for s in shapes]
    tits = [TInputType(**t.__dict__) for t in its]
    assert tv.output_type(tits).to_dict() == jv.output_type(its).to_dict()


def test_stack_mixed_masks_raise():
    m = torch.ones(2, 3)
    with pytest.raises(ValueError, match="all or no"):
        TG.StackVertex().output_mask([m, None])


def test_unknown_vertex_type_names_itself():
    d = json.loads(_merge_subset(JAX).to_json())
    d["vertices"]["merged"]["type"] = "attention_vertex"
    with pytest.raises(NotYetPorted, match="'attention_vertex'"):
        TCGC.from_dict(d)


# --------------------------------------------------------------------------
# minibatch tracking (the reference's TestBatchAxisMinibatchTracking)
# --------------------------------------------------------------------------


def test_stack_then_time_rebuild_uses_stacked_batch(tmp_path):
    jnet, net = _pair("stack_rebuild", tmp_path)
    rng = np.random.default_rng(2)
    b, t = 3, 5
    x1 = rng.normal(size=(b, t, 4)).astype(np.float32)
    x2 = rng.normal(size=(b, t, 4)).astype(np.float32)
    acts = net.feed_forward([x1, x2])
    assert acts["to_rnn"].shape == (2 * b, t, 6)       # not (b, 2t, 6)
    assert acts["out"].shape == (2 * b, 3)
    acts2 = net.feed_forward([x1, rng.normal(size=(b, t, 4))
                              .astype(np.float32)])
    assert torch.allclose(acts["out"][:b], acts2["out"][:b], atol=1e-6)
    assert net._minibatch_map(b) == jnet._minibatch_map(b)


# --------------------------------------------------------------------------
# gradient checks (the reference's TestGraphGradients, f64)
# --------------------------------------------------------------------------


def _gc_residual(p):
    return (_base(p, "sgd", 0.1).graph_builder().add_inputs("in")
            .add_layer("d1", p.L.DenseLayer(n_out=5, activation="tanh"), "in")
            .add_vertex("res", p.G.ElementWiseVertex(op="add"), "d1", "in")
            .add_vertex("scaled", p.G.ScaleVertex(scale=0.5), "res")
            .add_layer("out", p.L.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "scaled")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(5)).build())


def _gc_merge(p):
    return (_base(p, "sgd", 0.1).graph_builder().add_inputs("a", "b")
            .add_layer("da", p.L.DenseLayer(n_out=4, activation="tanh"), "a")
            .add_layer("db", p.L.DenseLayer(n_out=4, activation="sigmoid"),
                       "b")
            .add_vertex("m", p.G.MergeVertex(), "da", "db")
            .add_vertex("norm", p.G.L2NormalizeVertex(), "m")
            .add_layer("out", p.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "norm")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(3),
                             p.InputType.feed_forward(2)).build())


@pytest.mark.parametrize("name", ["residual", "merge", "multi_output",
                                  "siamese", "seq2seq"])
def test_gradient_check(name):
    rng = np.random.default_rng(12345)
    if name == "residual":
        conf, xs = _gc_residual(TORCH), [rng.normal(size=(4, 5))]
        ys = [np.eye(3)[rng.integers(0, 3, 4)]]
    elif name == "merge":
        conf = _gc_merge(TORCH)
        xs = [rng.normal(size=(4, 3)), rng.normal(size=(4, 2))]
        ys = [np.eye(2)[rng.integers(0, 2, 4)]]
    else:
        conf = GRAPHS[name](TORCH)
        xs, ys = _data(name, b=3, t=3)
        xs = [x.astype(np.float64) for x in xs]
        ys = [y.astype(np.float64) for y in ys]
    r = check_graph_gradients(conf, xs, ys, max_rel_error=1e-5, device="cpu")
    assert r.passed, r.summary()


# --------------------------------------------------------------------------
# truncated BPTT (the reference's TestGraphTbptt)
# --------------------------------------------------------------------------


def _tbptt_conf(p, lr=5e-2, updater="adam"):
    return (_base(p, updater, lr).graph_builder().add_inputs("in")
            .add_layer("lstm", p.R.GravesLSTM(n_in=5, n_out=8,
                                              activation="tanh"), "in")
            .add_layer("out", p.L.RnnOutputLayer(n_in=8, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "lstm")
            .set_outputs("out")
            .backprop_type("truncated_bptt").t_bptt_forward_length(4)
            .t_bptt_backward_length(4).build())


def _tbptt_data(b=4, t=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t))])


def test_tbptt_config_equals_reference():
    got = json.loads(_tbptt_conf(TORCH).to_json())
    assert got == json.loads(_tbptt_conf(JAX).to_json())
    assert (got["backprop_type"], got["tbptt_fwd_length"]) == \
        ("truncated_bptt", 4)


def test_tbptt_chunks_and_trains():
    x, y = _tbptt_data()
    net = ComputationGraph(_tbptt_conf(TORCH), device="cpu").init()
    scores = CollectScoresIterationListener(1)
    net.set_listeners(scores)
    losses = [float(net.fit_batch([x], [y])) for _ in range(25)]
    # 10 steps / length 4: three updates and three listener firings a batch
    assert net._update_count == net.iteration_count == 25 * 3
    assert len(scores.scores) == 25 * 3
    assert losses[-1] < losses[0]


def test_tbptt_equals_reference(tmp_path):
    """Three chunks a batch (4 + 4 + 2 steps), three batches: the port's
    per-chunk losses and final parameters against the reference's."""
    jnet = JComputationGraph(_tbptt_conf(JAX)).init()
    path = str(tmp_path / "tb.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    jl, tl = [], []
    for seed in range(3):
        x, y = _tbptt_data(seed=seed)
        jl.append(float(jnet.fit_batch([x], [y])))
        tl.append(float(tnet.fit_batch([x], [y])))
    assert _rel(tl, jl) <= STEPS
    assert tnet._update_count == jnet._update_count == 9
    for v, ps in tnet.params.items():
        for k, p in ps.items():
            assert _rel(p.detach().numpy(), jnet.params[v][k]) <= 1e-3, (v, k)


def test_tbptt_carries_state_across_chunks():
    """With the learning rate at 0, fit_batch returns the second chunk's
    loss computed from the carried h/c: equal to scoring steps [4:8] from
    the state after steps [0:4]; a zeroed carry gives another loss."""
    conf = _tbptt_conf(TORCH)
    conf.training.learning_rate = 0.0
    x, y = _tbptt_data(b=2, t=8, seed=3)
    net = ComputationGraph(conf, device="cpu").init()
    l_chunk2 = float(net.fit_batch([x], [y]))
    assert net._update_count == 2
    ref = ComputationGraph(conf, device="cpu")
    ref.set_params(net.clone_params())
    with torch.no_grad():
        new_states = {}
        ref._loss_fn([torch.from_numpy(x[:, :4])],
                     [torch.from_numpy(y[:, :4])],
                     states=ref._states_map(ref._zero_rnn_carry(2)),
                     new_states=new_states)
        carry = ref._extract_rnn_carry(new_states)
        l_ref = float(ref._loss_fn([torch.from_numpy(x[:, 4:])],
                                   [torch.from_numpy(y[:, 4:])],
                                   states=ref._states_map(carry)))
        l_zero = float(ref._loss_fn([torch.from_numpy(x[:, 4:])],
                                    [torch.from_numpy(y[:, 4:])],
                                    states=ref._states_map(
                                        ref._zero_rnn_carry(2))))
    assert l_chunk2 == pytest.approx(l_ref, rel=1e-5)
    assert abs(l_zero - l_chunk2) > 1e-4


def test_scan_paths_reject_tbptt():
    x, y = _tbptt_data()
    net = ComputationGraph(_tbptt_conf(TORCH), device="cpu").init()
    with pytest.raises(ValueError, match="truncated BPTT"):
        net.fit_repeated([x], [y], 4)
    with pytest.raises(ValueError, match="truncated BPTT"):
        net.fit_scan([x[None]], [y[None]])
    # a sequence no longer than the forward length is one plain update
    net.fit_repeated([x[:, :4]], [y[:, :4]], 2)
    assert net._update_count == 2


# --------------------------------------------------------------------------
# fit, feed_forward, streaming, clone_params
# --------------------------------------------------------------------------


class _DS:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def test_fit_over_iterables_and_datasets_equals_reference(tmp_path):
    jnet, tnet = _pair("multi_output", tmp_path)
    batches = [_data("multi_output", seed=s) for s in range(3)]
    data = [(xs, ys) for xs, ys in batches]
    jnet.fit(data, epochs=2)
    tnet.fit(data, epochs=2)
    assert tnet.epoch_count == jnet.epoch_count == 2
    assert tnet.iteration_count == jnet.iteration_count == 6
    for v, ps in tnet.params.items():
        for k, p in ps.items():
            assert _rel(p.detach().numpy(), jnet.params[v][k]) <= STEPS, \
                (v, k)
    one = ComputationGraph(GRAPHS["merge_subset"](TORCH), device="cpu").init()
    xs, ys = _data("merge_subset")
    one.fit(xs, ys, epochs=3)
    one.fit(_DS(xs, ys))
    one.fit([_DS(xs, ys), _DS(xs, ys)])
    assert one.iteration_count == 6 and one.epoch_count == 5


def test_lstm_graph_streaming_equals_full_forward_and_reference(tmp_path):
    jconf = (JNNC.builder().seed(4).learning_rate(0.1).graph_builder()
             .add_inputs("in")
             .add_layer("lstm", JR.GravesLSTM(n_in=6, n_out=8,
                                              activation="tanh"), "in")
             .add_layer("out", JL.RnnOutputLayer(n_in=8, n_out=4,
                                                 activation="softmax",
                                                 loss="mcxent"), "lstm")
             .set_outputs("out").build())
    jnet = JComputationGraph(jconf).init()
    path = str(tmp_path / "lstm.zip")
    j_save(jnet, path)
    net = load_model(path, device="cpu")
    x = np.random.default_rng(6).normal(size=(2, 5, 6)).astype(np.float32)
    full = net.output([x]).numpy()
    stepped = np.stack([net.rnn_time_step(x[:, t, :]).numpy()
                        for t in range(5)], axis=1)
    assert np.allclose(full, stepped, atol=1e-5)
    jstep = np.stack([np.asarray(jnet.rnn_time_step(x[:, t, :]))
                      for t in range(5)], axis=1)
    assert _rel(stepped, jstep) <= F32
    net.rnn_clear_previous_state()
    a = net.rnn_time_step(x[:, 0]).numpy()
    assert np.allclose(a, stepped[:, 0], atol=1e-6)


def test_clone_params_is_a_detached_copy(tmp_path):
    _, net = _pair("merge_subset", tmp_path)
    before = net.clone_params()
    xs, ys = _data("merge_subset")
    net.fit_batch(xs, ys)
    assert not torch.equal(before["d1"]["W"], net.params["d1"]["W"])
    assert not before["d1"]["W"].requires_grad


def test_output_vertex_with_consumers_trains():
    conf = (_base(TORCH, "sgd", 0.1).graph_builder().add_inputs("in")
            .add_layer("d1", TL.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out1", TL.OutputLayer(n_out=4, activation="softmax",
                                              loss="mcxent"), "d1")
            .add_layer("out2", TL.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "out1")
            .set_outputs("out1", "out2")
            .set_input_types(TInputType.feed_forward(5)).build())
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 5)).astype(np.float32)
    y1 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    s0 = net.score_for([x], [y1, y2])
    for _ in range(20):
        net.fit_batch([x], [y1, y2])
    assert net.score() < s0


# --------------------------------------------------------------------------
# the sampling preprocessors
# --------------------------------------------------------------------------


def _binomial_graph(p, saturate=False):
    pre = p.P.BinomialSamplingPreProcessor(seed=9)
    return (_base(p, "sgd", 0.1).graph_builder().add_inputs("in")
            .add_layer("d", p.L.DenseLayer(n_out=6, activation="sigmoid"),
                       "in")
            .add_vertex("sample", p.G.PreprocessorVertex(pre), "d")
            .add_layer("h", p.L.DenseLayer(n_out=5, activation="tanh"),
                       "sample",
                       preprocessor=p.P.ComposableInputPreProcessor(children=(
                           p.P.BinomialSamplingPreProcessor(seed=1),
                           p.P.ZeroMeanPreProcessor())))
            .add_layer("out", p.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "h")
            .set_outputs("out")
            .set_input_types(p.InputType.feed_forward(4)).build())


def test_binomial_and_composable_json_equal_reference():
    got = json.loads(_binomial_graph(TORCH).to_json())
    assert got == json.loads(_binomial_graph(JAX).to_json())
    back = TCGC.from_dict(got)
    pre = back.vertices["h"].preprocessor
    assert isinstance(pre, TP.ComposableInputPreProcessor) and pre.wants_rng
    assert isinstance(pre.children[0], TP.BinomialSamplingPreProcessor)


def test_binomial_at_pinned_probabilities_equals_reference(tmp_path):
    """Probabilities of exactly 0 and 1 pin every draw: the graph's
    loss, its step-0 gradients (straight-through) and three sgd steps
    equal the reference's."""
    import jax
    jnet = JComputationGraph(_binomial_graph(JAX)).init()
    w = np.asarray(jnet.params["d"]["W"])
    jnet.params["d"]["W"] = jnp.asarray(np.sign(w) * 300.0, jnp.float32)
    path = str(tmp_path / "bin.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    jl, jg = jax.value_and_grad(lambda p: jnet._loss_fn(
        p, jnet._states_map(), [jnp.asarray(x)], [jnp.asarray(y)], None,
        jax.random.key(0))[0])(jnet.params)
    gen = tnet._generator("probe")
    assert gen is not None
    tl, tg = tnet._loss_and_grads([torch.from_numpy(x)], [torch.from_numpy(y)],
                                  None, generator=gen)
    assert _rel(float(tl), float(jl)) <= F32
    for v, gs in tg.items():
        for k, g in gs.items():
            assert _rel(g.numpy(), jg[v][k]) <= F32, (v, k)


def test_binomial_draws_fresh_per_step_and_reproduces_per_seed():
    pre = TP.BinomialSamplingPreProcessor(seed=5)
    p = torch.full((64, 32), 0.5)
    assert torch.equal(pre(p), pre(p))                  # seeded direct call
    assert torch.equal(pre(p), TP.BinomialSamplingPreProcessor(seed=5)(p))
    assert not torch.equal(pre(p), TP.BinomialSamplingPreProcessor(6)(p))
    net = ComputationGraph(_binomial_graph(TORCH), device="cpu").init()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 4)).astype(np.float32))
    a = net._forward([x], train=True, generator=net._generator("update_0"))
    b = net._forward([x], train=True, generator=net._generator("update_1"))
    a2 = net._forward([x], train=True, generator=net._generator("update_0"))
    assert set(torch.unique(a["sample"]).tolist()) <= {0.0, 1.0}
    assert not torch.equal(a["sample"], b["sample"])
    assert torch.equal(a["sample"], a2["sample"])
    # eval mode passes no generator: the seeded draw, the same every call
    assert torch.equal(net.output(x), net.output(x))


def test_binomial_gradient_is_straight_through():
    pre = TP.BinomialSamplingPreProcessor(seed=2)
    x = torch.rand(16, 8, requires_grad=True)
    w = torch.randn(16, 8)
    (g,) = torch.autograd.grad(torch.sum(pre(x) * w), [x])
    assert torch.equal(g, w)


def test_composable_children_draw_from_offset_generators():
    gen = torch.Generator().manual_seed(3)
    c = TP.ComposableInputPreProcessor(children=(
        TP.BinomialSamplingPreProcessor(), TP.BinomialSamplingPreProcessor()))
    p = torch.full((32, 32), 0.5)
    first = TP.child_generator(torch.Generator().manual_seed(3), 0)
    second = TP.child_generator(torch.Generator().manual_seed(3), 1)
    want0 = TP.BinomialSamplingPreProcessor()(p, generator=first)
    out = c(p, generator=gen)
    want = TP.BinomialSamplingPreProcessor()(want0, generator=second)
    assert torch.equal(out, want)
    # the parent stream moves on: a second call samples afresh
    assert not torch.equal(c(p, generator=gen), out)
