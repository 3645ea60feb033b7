"""The port's list DSL and ``MultiLayerNetwork`` against the JAX package's,
on the CPU: the cases of ``tests/test_conf.py`` and
``tests/test_multilayer.py``.

Configurations are built through both packages' DSLs with the same calls
and compared as parsed JSON. Runtime parity starts from the reference's
weights: a reference net is initialised and saved, and the port loads the
checkpoint (the two packages' generators differ). Batches are made from a
seed with numpy.

Tolerances, relative to the largest magnitude compared: f32 forward,
loss and step-0 gradients 1e-5 (the same sums in another order);
parameters after a few adam or rmsprop steps 1e-4 (the updaters divide by
sqrt(v) + eps, which grows a rounding difference in a small gradient
element); f64 1e-10.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.eval as jeval
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu.nn.conf.recurrent as JR
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.attention import SelfAttentionLayer as JAtt
from deeplearning4j_tpu.nn.conf.multi_layer import \
    MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.serialization import save_model as j_save

import deeplearning4j_tpu_torch.eval as teval
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
import deeplearning4j_tpu_torch.nn.conf.recurrent as TR
from deeplearning4j_tpu_torch.nn.conf import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import NotYetPorted
from deeplearning4j_tpu_torch.nn.conf.attention import \
    SelfAttentionLayer as TAtt
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration as TMLC
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.util.serialization import load_model

F32 = 1e-5
STEPS = 1e-4


class _Pkg:
    def __init__(self, nnc, inputs, layers, rec, att, pre):
        self.NNC, self.InputType, self.L, self.R, self.Att, self.P = (
            nnc, inputs, layers, rec, att, pre)


JAX = _Pkg(JNNC, JInputType, JL, JR, JAtt, JP)
TORCH = _Pkg(TNNC, TInputType, TL, TR, TAtt, TP)


def _lenet_bn(p, updater="adam"):
    return (p.NNC.builder().seed(123).updater(updater).learning_rate(1e-3)
            .weight_init("XAVIER").activation("relu").list()
            .layer(p.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(p.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(p.L.BatchNormalization())
            .layer(p.L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                        border_mode="same", stride=(2, 2)))
            .layer(p.L.DenseLayer(n_out=16))
            .layer(p.L.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(p.InputType.convolutional_flat(12, 12, 1))
            .build())


def _mlp(p, updater="adam", **kw):
    b = p.NNC.builder().seed(42).updater(updater).learning_rate(1e-2)
    for k, v in kw.items():
        getattr(b, k)(*v) if isinstance(v, tuple) else getattr(b, k)(v)
    return (b.list()
            .layer(p.L.DenseLayer(n_out=16, activation="relu"))
            .layer(p.L.BatchNormalization())
            .layer(p.L.DenseLayer(n_out=8, activation="tanh"))
            .layer(p.L.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(p.InputType.feed_forward(10))
            .build())


def _lstm(p, backprop="standard", tbptt=20, updater="rmsprop"):
    return (p.NNC.builder().seed(3).updater(updater).learning_rate(5e-3)
            .list()
            .layer(p.R.GravesLSTM(n_out=7, activation="tanh"))
            .layer(p.R.GravesLSTM(n_out=5, activation="tanh"))
            .layer(p.L.RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(p.InputType.recurrent(6))
            .backprop_type(backprop)
            .t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
            .build())


def _bilstm_pool(p):
    return (p.NNC.builder().seed(5).updater("sgd").learning_rate(0.1).list()
            .layer(p.R.GravesBidirectionalLSTM(n_out=5, activation="tanh"))
            .layer(p.L.GlobalPoolingLayer(pooling_type="max"))
            .layer(p.L.DenseLayer(n_out=4, activation="elu"))
            .layer(p.L.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(p.InputType.recurrent(4)).build())


def _rnn_to_dense(p):
    return (p.NNC.builder().list()
            .layer(p.R.GravesLSTM(n_out=32, activation="tanh"))
            .layer(p.L.DenseLayer(n_out=16, activation="relu"))
            .layer(p.L.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(p.InputType.recurrent(8)).build())


def _explicit_preprocessors(p):
    return (p.NNC.builder().seed(9).l2(1e-3).regularization(True).list()
            .layer(p.L.DenseLayer(n_out=12, activation="relu"))
            .input_preprocessor(0, p.P.ZeroMeanAndUnitVariancePreProcessor())
            .layer(p.L.ActivationLayer(activation="tanh"))
            .layer(p.L.LossLayer(loss="mse", activation="identity"))
            .set_input_type(p.InputType.feed_forward(5)).build())


def _attention_stack(p):
    return (p.NNC.builder().seed(99).updater("adam").learning_rate(5e-3)
            .list()
            .layer(p.R.GravesLSTM(n_out=8, activation="tanh"))
            .layer(p.L.LayerNormalization())
            .layer(p.Att(n_heads=2, causal=True))
            .layer(p.L.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(p.InputType.recurrent(6)).build())


CONFS = {"lenet_bn": _lenet_bn, "mlp": _mlp, "lstm": _lstm,
         "tbptt": lambda p: _lstm(p, "truncated_bptt", 4),
         "bilstm_pool": _bilstm_pool, "rnn_to_dense": _rnn_to_dense,
         "explicit_preprocessors": _explicit_preprocessors,
         "attention": _attention_stack}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def _pair(tmp_path, build, name="net"):
    """(reference net, the port's net loaded from its checkpoint)."""
    jnet = JMLN(build(JAX)).init()
    path = str(tmp_path / f"{name}.zip")
    j_save(jnet, path)
    return jnet, load_model(path, device="cpu")


def _tree_close(tnet_tree, jtree, tol, what):
    assert set(tnet_tree) == set(jtree)
    for k, ps in tnet_tree.items():
        assert set(ps) == set(jtree[k]), (k, set(ps), set(jtree[k]))
        for n, t in ps.items():
            _close(t.detach().numpy(), np.asarray(jtree[k][n]), tol,
                   f"{what} {k}/{n}")


# --------------------------------------------------------------------------
# configuration DSL
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFS))
def test_conf_json_equals_reference(name):
    jconf, tconf = CONFS[name](JAX), CONFS[name](TORCH)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    # each package reads the other's JSON back to the same configuration
    assert (json.loads(TMLC.from_json(jconf.to_json()).to_json())
            == json.loads(jconf.to_json()))
    assert (json.loads(JMLC.from_json(tconf.to_json()).to_json())
            == json.loads(tconf.to_json()))


@pytest.mark.parametrize("name", ["lenet_bn", "tbptt", "explicit_preprocessors"])
def test_yaml_round_trips_across_packages(name):
    jconf, tconf = CONFS[name](JAX), CONFS[name](TORCH)
    assert TMLC.from_yaml(tconf.to_yaml()).to_json() == tconf.to_json()
    assert (json.loads(TMLC.from_yaml(jconf.to_yaml()).to_json())
            == json.loads(jconf.to_json()))
    assert (json.loads(JMLC.from_yaml(tconf.to_yaml()).to_json())
            == json.loads(tconf.to_json()))


def test_shape_inference_and_preprocessor_insertion():
    conf = _lenet_bn(TORCH)
    assert conf.layers[0].n_in == 1
    assert conf.layers[2].n_out == 4
    assert conf.layers[3].n_in == 4
    # 12 -> conv3 10 -> pool 5 -> same/2 3: 3*3*6
    assert conf.layers[4].n_in == 3 * 3 * 6
    assert isinstance(conf.input_preprocessors[0],
                      TP.FeedForwardToCnnPreProcessor)
    assert isinstance(conf.input_preprocessors[4],
                      TP.CnnToFeedForwardPreProcessor)
    assert conf.layers[0].weight_init == "XAVIER"
    assert conf.layers[5].activation == "softmax"
    rnn = _rnn_to_dense(TORCH)
    assert rnn.layers[1].n_in == 32
    assert isinstance(rnn.input_preprocessors[1],
                      TP.RnnToFeedForwardPreProcessor)
    tb = _lstm(TORCH, "truncated_bptt", 4)
    assert (tb.backprop_type, tb.tbptt_fwd_length, tb.tbptt_back_length) \
        == ("truncated_bptt", 4, 4)


@pytest.mark.parametrize("name", ["lenet_bn", "rnn_to_dense", "attention"])
def test_layer_input_types_match_reference(name):
    got = [t.to_dict() for t in CONFS[name](TORCH).layer_input_types()]
    want = [t.to_dict() for t in CONFS[name](JAX).layer_input_types()]
    assert got == want


def test_unported_preprocessor_and_layer_raise_naming_them():
    d = json.loads(_mlp(JAX).to_json())
    d["input_preprocessors"] = {"0": {"type": "binomial_sampling", "seed": 0}}
    assert isinstance(TMLC.from_dict(d).input_preprocessors[0],
                      TP.BinomialSamplingPreProcessor)
    d["input_preprocessors"] = {"0": {"type": "bernoulli_noise", "seed": 0}}
    with pytest.raises(NotYetPorted, match="bernoulli_noise"):
        TMLC.from_dict(d)
    d = json.loads(_mlp(JAX).to_json())
    d["layers"][0]["type"] = "auto_encoder"
    with pytest.raises(NotYetPorted, match="auto_encoder"):
        TMLC.from_dict(d)


PREPROCESSORS = [
    ("cnn_to_feedforward", dict(height=3, width=2, channels=4), (5, 3, 2, 4)),
    ("feedforward_to_cnn", dict(height=3, width=2, channels=4), (5, 24)),
    ("rnn_to_feedforward", {}, (5, 3, 4)),
    ("feedforward_to_rnn", {}, (15, 4)),
    ("cnn_to_rnn", dict(height=2, width=2, channels=3), (15, 2, 2, 3)),
    ("rnn_to_cnn", dict(height=2, width=2, channels=3), (5, 3, 12)),
    ("reshape", dict(to_shape=(0, 4, 6), dynamic=True), (5, 24)),
    ("zero_mean", {}, (7, 4)),
    ("unit_variance", dict(eps=1e-5), (7, 4)),
    ("zero_mean_unit_variance", dict(eps=1e-5), (7, 4)),
]


@pytest.mark.parametrize("typ,fields,shape", PREPROCESSORS,
                         ids=[p[0] for p in PREPROCESSORS])
def test_preprocessor_matches_reference(typ, fields, shape):
    """Forward, mask and gradient (the normalisers' batch statistics are
    constants in the backward), and the JSON both ways."""
    jp = JP.preprocessor_from_dict({"type": typ, **fields})
    tp = TP.preprocessor_from_dict({"type": typ, **fields})
    assert tp.to_dict() == json.loads(json.dumps(jp.to_dict()))
    assert JP.preprocessor_from_dict(tp.to_dict()).to_dict() == jp.to_dict()
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float64)
    mb = 5
    jout, pull = jax.vjp(lambda a: jp(a, minibatch_size=mb), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = tp(xt, minibatch_size=mb)
    _close(tout.detach().numpy(), np.asarray(jout), 1e-12, f"{typ} forward")
    ct = rng.normal(size=jout.shape)
    _close(torch.autograd.grad(tout, xt, torch.from_numpy(ct))[0].numpy(),
           np.asarray(pull(jnp.asarray(ct))[0]), 1e-12, f"{typ} gradient")
    if len(shape) <= 3 and typ not in ("zero_mean", "unit_variance",
                                       "zero_mean_unit_variance"):
        m = (rng.random(shape[:2] if len(shape) == 3 else shape[:1]) > 0.3)
        jm = jp.transform_mask(jnp.asarray(m, jnp.float32), minibatch_size=mb)
        tm = tp.transform_mask(torch.from_numpy(m).float(), minibatch_size=mb)
        _close(tm.numpy(), np.asarray(jm), 0.0, f"{typ} mask")
    it = TInputType.feed_forward(24) if len(shape) == 2 else \
        TInputType.recurrent(shape[-1]) if len(shape) == 3 else \
        TInputType.convolutional(*shape[1:])
    jit_ = JInputType.from_dict(it.to_dict())
    assert tp.output_type(it).to_dict() == jp.output_type(jit_).to_dict()


# --------------------------------------------------------------------------
# runtime parity from reference checkpoints
# --------------------------------------------------------------------------


def _batch(name, seed=0, b=6):
    rng = np.random.default_rng(seed)
    if name == "lenet_bn":
        return (rng.normal(size=(b, 144)).astype(np.float32),
                np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)], None)
    if name == "mlp":
        return (rng.normal(size=(b, 10)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)], None)
    if name == "bilstm_pool":
        return (rng.normal(size=(b, 5, 4)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)], None)
    if name == "explicit_preprocessors":
        return (rng.normal(size=(b, 5)).astype(np.float32),
                rng.normal(size=(b, 12)).astype(np.float32), None)
    t = 12 if name == "tbptt" else 7
    x = rng.normal(size=(b, t, 6)).astype(np.float32)
    y = np.eye(4 if name != "attention" else 3,
               dtype=np.float32)[rng.integers(0, 4 if name != "attention"
                                              else 3, (b, t))]
    mask = None
    if name == "lstm":
        mask = np.ones((b, t), np.float32)
        mask[1, 4:] = 0
        mask[3, 2:] = 0
    return x, y, mask


RUNTIME = ["lenet_bn", "mlp", "lstm", "bilstm_pool",
           "explicit_preprocessors", "attention"]


@pytest.mark.parametrize("name", RUNTIME)
def test_output_score_and_step0_gradients_match_reference(tmp_path, name):
    jnet, tnet = _pair(tmp_path, CONFS[name])
    x, y, mask = _batch(name)
    _close(tnet.output(x).numpy(), np.asarray(jnet.output(jnp.asarray(x))),
           F32, "output")
    jm = None if mask is None else jnp.asarray(mask)
    # the reference's loss and gradients, compiled once (its eager
    # compute_gradient_and_score takes seconds per case on the CPU)
    states = jnet._states_list()
    js, jg = jax.jit(jax.value_and_grad(lambda p: jnet._loss_fn(
        p, states, jnp.asarray(x), jnp.asarray(y), jm, None)[0]))(
            jnet.params)
    _close(tnet.score_for(x, y, mask), float(js), F32, "score")
    tg, ts = tnet.compute_gradient_and_score(x, y, mask)
    _close(ts, float(js), F32, "loss")
    _tree_close(tg, jg, F32, "gradient")
    acts_t = tnet.feed_forward(x)
    acts_j = jnet.feed_forward(jnp.asarray(x))
    assert len(acts_t) == len(acts_j) == len(tnet.layers) + 1
    for i, (a, b) in enumerate(zip(acts_t, acts_j)):
        _close(a.numpy(), np.asarray(b), F32, f"activation {i}")


@pytest.mark.parametrize("name", ["lenet_bn", "mlp", "lstm", "attention"])
def test_three_steps_match_reference_params_and_bn_state(tmp_path, name):
    jnet, tnet = _pair(tmp_path, CONFS[name])
    x, y, mask = _batch(name, seed=1)
    jm = None if mask is None else jnp.asarray(mask)
    jl = [float(jnet.fit_batch(x, y, jm)) for _ in range(3)]
    tl = [float(tnet.fit_batch(x, y, mask)) for _ in range(3)]
    _close(tl, jl, STEPS, "losses")
    _tree_close(tnet.params, jnet.params, STEPS, "params")
    bn = [k for k, st in jnet.state.items() if st]
    assert bool(bn) == (name in ("lenet_bn", "mlp"))
    for k in bn:
        for n in ("mean", "var"):
            _close(tnet.state[k][n].numpy(), np.asarray(jnet.state[k][n]),
                   STEPS, f"state {k}/{n}")
        assert not np.allclose(tnet.state[k]["mean"].numpy(), 0.0)
    assert tnet.iteration_count == tnet._update_count == 3
    # output() uses the running statistics and leaves them as they are
    before = {k: {n: t.clone() for n, t in st.items()}
              for k, st in tnet.state.items()}
    _close(tnet.output(x).numpy(), np.asarray(jnet.output(jnp.asarray(x))),
           STEPS, "output after training")
    for k, st in before.items():
        for n, t in st.items():
            assert torch.equal(tnet.state[k][n], t)


def test_tbptt_three_chunks_match_reference(tmp_path):
    """A [b, 12] sequence with forward length 4 takes three updates, the
    carry passed between chunks with its gradient cut; parameters after
    the one fit_batch against the reference's."""
    jnet, tnet = _pair(tmp_path, CONFS["tbptt"])
    x, y, _ = _batch("tbptt", seed=2)
    jl = float(jnet.fit_batch(x, y))
    scores = CollectScoresIterationListener()
    tnet.set_listeners(scores)
    tl = float(tnet.fit_batch(x, y))
    assert tnet._update_count == 3 and tnet.iteration_count == 3
    assert [it for it, _ in scores.scores] == [1, 2, 3]
    _close(tl, jl, STEPS, "last chunk loss")
    _tree_close(tnet.params, jnet.params, STEPS, "params after TBPTT")
    with pytest.raises(ValueError, match="truncated BPTT"):
        tnet.fit_repeated(x, y, 2)


def test_rnn_time_step_matches_full_forward_and_reference(tmp_path):
    jnet, tnet = _pair(tmp_path, CONFS["lstm"])
    x = _batch("lstm", seed=3)[0][:2]
    full = tnet.output(x).numpy()
    stepped = np.stack([tnet.rnn_time_step(x[:, t]).numpy()
                        for t in range(x.shape[1])], axis=1)
    _close(stepped, full, 1e-6, "stepped vs full")
    jstep = np.stack([np.asarray(jnet.rnn_time_step(jnp.asarray(x[:, t])))
                      for t in range(x.shape[1])], axis=1)
    _close(stepped, jstep, F32, "stepped vs reference")
    a = tnet.rnn_time_step(x[:, :3]).numpy()       # a chunk carries on
    tnet.rnn_clear_previous_state()
    b = tnet.rnn_time_step(x[:, :3]).numpy()
    _close(b, full[:, :3], 1e-6, "after clear")
    assert not np.allclose(a, b)


def test_attention_stack_streams_like_the_full_forward(tmp_path):
    """GravesLSTM → LayerNorm → causal SelfAttention (K/V cache) →
    RnnOutput: rnn_time_step one step at a time equals the full forward."""
    conf = _attention_stack(TORCH)
    conf.layers[2].max_cache_t = 16
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, _, _ = _batch("attention", seed=4, b=2)
    full = net.output(x).numpy()
    stepped = np.stack([net.rnn_time_step(x[:, t]).numpy()
                        for t in range(x.shape[1])], axis=1)
    _close(stepped, full, 1e-5, "streamed attention stack")


def test_fit_repeated_and_fit_scan_equal_fit_batch_steps(tmp_path):
    x, y, _ = _batch("mlp", seed=5)
    a = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    b = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    c = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    la = torch.stack([a.fit_batch(x, y) for _ in range(3)])
    lb = b.fit_repeated(x, y, 3)
    lc = c.fit_scan(np.stack([x] * 3), np.stack([y] * 3))
    assert torch.equal(la, lb) and torch.equal(la, lc)
    for net in (b, c):
        for k, ps in a.params.items():
            for n, p in ps.items():
                assert torch.equal(p, net.params[k][n])
        assert torch.equal(net.state["layer_1"]["mean"],
                           a.state["layer_1"]["mean"])
    assert a.iteration_count == b.iteration_count == c.iteration_count == 3
    assert float(a.score()) == float(la[-1])


def test_fit_over_batches_epochs_and_listeners():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ rng.normal(size=(10, 3)), 1)]
    net = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    scores = CollectScoresIterationListener()
    net.set_listeners(scores)
    s0 = net.score_for(x, y)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    net.fit(batches, epochs=3)
    assert net.iteration_count == 12 and net.epoch_count == 3
    assert len(scores.scores) == 12
    net.fit(x, y, epochs=20)
    assert net.score_for(x, y) < 0.5 * s0
    assert net.num_params() == (10 * 16 + 16) + 2 * 16 + (16 * 8 + 8) \
        + (8 * 3 + 3)


def test_regularization_lr_overrides_and_clipping():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    plain = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    reg = MultiLayerNetwork(_mlp(TORCH, regularization=True, l2=0.5),
                            device="cpu").init()
    assert reg.score_for(x, y) > plain.score_for(x, y)
    conf = _mlp(TORCH, updater="sgd",
                gradient_normalization=("clip_l2_per_layer", 1.0))
    conf.layers[0].learning_rate = 0.0
    net = MultiLayerNetwork(conf, device="cpu").init()
    w0 = net.params["layer_0"]["W"].detach().clone()
    out0 = net.params["layer_3"]["W"].detach().clone()
    net.fit_batch(x, y)
    assert torch.equal(w0, net.params["layer_0"]["W"])
    assert not torch.equal(out0, net.params["layer_3"]["W"])


def test_dropout_trains_from_the_generator_and_eval_is_deterministic():
    conf = _mlp(TORCH)
    conf.layers[2].dropout = 0.5
    x, y, _ = _batch("mlp", seed=8)
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    la = [float(a.fit_batch(x, y)) for _ in range(2)]
    lb = [float(b.fit_batch(x, y)) for _ in range(2)]
    assert la == lb and all(np.isfinite(la))     # one seed, one mask stream
    assert torch.equal(a.output(x), a.output(x))
    assert not torch.equal(a.output(x, train=True), a.output(x))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(_mlp(TORCH))
    path = str(tmp_path / "m.zip")
    j_save(JMLN(_mlp(JAX)).init(), path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)
    # pretrain is ported: a net without AutoEncoder or RBM layers keeps
    # its parameters
    net = MultiLayerNetwork(_mlp(TORCH), device="cpu").init()
    before = net.clone_params()
    net.pretrain(np.zeros((2, 10), np.float32))
    for key, ps in net.params.items():
        for name, p in ps.items():
            assert torch.equal(p, before[key][name]), (key, name)


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------


def test_evaluation_matches_reference():
    rng = np.random.default_rng(9)
    labels = np.eye(4)[rng.integers(0, 3, 40)]          # class 3 never true
    preds = rng.dirichlet(np.ones(4), 40)
    mask = (rng.random(40) > 0.2).astype(np.float32)
    ts_labels = np.eye(4)[rng.integers(0, 4, (5, 6))]
    ts_preds = rng.dirichlet(np.ones(4), (5, 6))
    ts_mask = (rng.random((5, 6)) > 0.3).astype(np.float32)
    evs = []
    for mod in (jeval, teval):
        ev = mod.Evaluation(labels=["a", "b", "c", "d"])
        ev.eval(labels, preds)
        ev.eval(labels, preds, mask=mask)
        ev.eval(ts_labels, ts_preds, mask=ts_mask)
        evs.append(ev)
    j, t = evs
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(t.confusion.matrix, j.confusion.matrix)
    for metric in ("accuracy", "precision", "recall", "f1"):
        assert getattr(t, metric)() == getattr(j, metric)()
    for c in range(4):
        assert t.f1(c) == j.f1(c) and t.false_positives(c) == \
            j.false_positives(c)
    other = teval.Evaluation()
    other.eval(labels, preds)
    t.merge(other)
    assert t.num_examples() == j.num_examples() + 40


def test_net_evaluate_matches_reference(tmp_path):
    jnet, tnet = _pair(tmp_path, CONFS["mlp"])
    rng = np.random.default_rng(10)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    batches = [(x[:16], y[:16]), (x[16:], y[16:])]
    got = tnet.evaluate(batches)
    want = jnet.evaluate(batches)
    assert got.stats() == want.stats()
    assert got.num_examples() == 32


def test_inference_server_serves_a_multilayer_network():
    import urllib.request
    from deeplearning4j_tpu_torch.serving import InferenceServer
    net = MultiLayerNetwork(_lenet_bn(TORCH), device="cpu").init()
    x = np.random.default_rng(11).normal(size=(3, 144)).astype(np.float32)
    server = InferenceServer(net, port=0, device="cpu")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict",
            data=json.dumps({"inputs": x.tolist()}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["outputs"], np.float32)
    finally:
        server.stop(drain=True, timeout=30)
    _close(got, net.output(x).numpy(), 1e-6, "/predict")
