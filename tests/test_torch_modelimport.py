"""The port's Keras import (``modelimport/keras.py``) against the JAX
package's, on the CPU, over every case of ``tests/test_modelimport.py``
with the same fixtures (hand-built h5 files in the Keras layout), plus
BatchNormalization, Embedding, channels_first convolutions and Keras-1
LSTMs. Each file is imported by both packages: the configuration JSON
equal, parameters and BN state bitwise equal, the forward within
``OUT_TOL``. The config-plus-arrays path (``_import_arrays``, what the
card runs without h5py) gives the file path's parameters bit for bit.
"""

import json
import re
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu.modelimport import KerasModelImport as JImport  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import KerasModelImport  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.keras import _import_arrays  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402

OUT_TOL = 1e-5      # f32 forwards of the same weights in two frameworks


def _write(path, config, weights, keras1=False):
    """An h5 file in the Keras layout: ``model_config`` JSON and one group
    per layer under ``model_weights`` (Keras 2: ``name/name/key:0``;
    Keras 1: flat ``name_key`` datasets)."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config).encode()
        mw = f.create_group("model_weights")
        for name, arrays in weights.items():
            g = mw.create_group(name)
            for key, a in arrays.items():
                g.create_dataset(f"{name}_{key}" if keras1
                                 else f"{name}/{key}:0", data=a)


def _dense(name, units, act, **extra):
    return {"class_name": "Dense", "config": dict(
        name=name, units=units, activation=act, **extra)}


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------------
# the cases: (config, weights, keras1, input shape)
# ----------------------------------------------------------------------

def _mlp(rng):            # test_modelimport._keras2_sequential_mlp
    W1, b1, W2, b2 = (_f32(rng, 5, 8), _f32(rng, 8), _f32(rng, 8, 3),
                      _f32(rng, 3))
    config = {"class_name": "Sequential", "config": {"name": "seq", "layers": [
        _dense("dense_1", 8, "relu", batch_input_shape=[None, 5]),
        _dense("dense_2", 3, "softmax")]}}
    return config, {"dense_1": {"kernel": W1, "bias": b1},
                    "dense_2": {"kernel": W2, "bias": b2}}, False, (4, 5)


def _conv(rng):           # TestSequentialImport.test_conv_model
    K, Wd = _f32(rng, 3, 3, 1, 4), _f32(rng, 4 * 3 * 3, 2)
    config = {"class_name": "Sequential", "config": [
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 4, "kernel_size": [3, 3],
            "strides": [1, 1], "padding": "valid", "activation": "relu",
            "data_format": "channels_last",
            "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "pool", "pool_size": [2, 2], "strides": [2, 2],
            "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        _dense("out", 2, "softmax")]}
    return config, {"conv": {"kernel": K, "bias": np.zeros(4, np.float32)},
                    "out": {"kernel": Wd, "bias": np.zeros(2, np.float32)}}, \
        False, (2, 8, 8, 1)


def _conv_channels_first(rng):
    """OIHW kernels transposed to HWIO; average pooling; BatchNorm with
    its moving statistics into the layer state."""
    K = _f32(rng, 4, 2, 3, 3)                       # OIHW
    config = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "conv", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
            "subsample": [1, 1], "border_mode": "same",
            "activation": "tanh", "dim_ordering": "th",
            "batch_input_shape": [None, 2, 6, 6]}},
        {"class_name": "BatchNormalization", "config": {
            "name": "bn", "epsilon": 1e-3, "momentum": 0.99}},
        {"class_name": "AveragePooling2D", "config": {
            "name": "pool", "pool_size": [2, 2]}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        _dense("out", 3, "softmax")]}
    weights = {"conv": {"kernel": K, "bias": _f32(rng, 4)},
               "bn": {"gamma": 1 + 0.1 * _f32(rng, 4),
                      "beta": _f32(rng, 4),
                      "moving_mean": _f32(rng, 4),
                      "moving_variance": 1 + np.abs(_f32(rng, 4))},
               "out": {"kernel": _f32(rng, 3 * 3 * 4, 3),
                       "bias": _f32(rng, 3)}}
    return config, weights, False, (2, 6, 6, 2)


def _lstm(rng):           # TestSequentialImport.test_lstm_keras2_gate_reorder
    H, F = 6, 4
    config = {"class_name": "Sequential", "config": [
        {"class_name": "LSTM", "config": {
            "name": "lstm", "units": H, "activation": "tanh",
            "recurrent_activation": "sigmoid",
            "batch_input_shape": [None, 5, F]}},
        _dense("out", 2, "softmax")]}
    return config, {"lstm": {"kernel": _f32(rng, F, 4 * H),
                             "recurrent_kernel": _f32(rng, H, 4 * H),
                             "bias": _f32(rng, 4 * H)},
                    "out": {"kernel": _f32(rng, H, 2),
                            "bias": np.zeros(2, np.float32)}}, False, (3, 5, F)


def _lstm_stack(rng):
    """Two hard_sigmoid LSTMs returning sequences, TimeDistributed(Dense)."""
    H, F, V = 8, 5, 5
    layers = [{"class_name": "LSTM", "config": {
        "name": f"lstm_{i}", "units": H, "return_sequences": True,
        "recurrent_activation": "hard_sigmoid",
        **({"batch_input_shape": [None, 7, F]} if i == 1 else {})}}
        for i in (1, 2)]
    layers.append({"class_name": "TimeDistributed", "config": {
        "name": "td", "layer": {"class_name": "Dense", "config": {
            "name": "d", "units": V, "activation": "softmax"}}}})
    weights = {f"lstm_{i}": {"kernel": _f32(rng, F if i == 1 else H, 4 * H),
                             "recurrent_kernel": _f32(rng, H, 4 * H),
                             "bias": _f32(rng, 4 * H)} for i in (1, 2)}
    weights["td"] = {"kernel": _f32(rng, H, V), "bias": _f32(rng, V)}
    return {"class_name": "Sequential", "config": {"layers": layers}}, \
        weights, False, (2, 7, F)


def _lstm_keras1(rng):
    """Keras-1 LSTM: per-gate W_/U_/b_ arrays, flat names."""
    H, F = 4, 3
    config = {"class_name": "Sequential", "config": [
        {"class_name": "LSTM", "config": {
            "name": "l", "output_dim": H, "inner_activation": "hard_sigmoid",
            "batch_input_shape": [None, 6, F]}},
        {"class_name": "Dense", "config": {
            "name": "o", "output_dim": 2, "activation": "softmax"}}]}
    w = {}
    for g in "ifco":
        w[f"W_{g}"], w[f"U_{g}"], w[f"b_{g}"] = (
            _f32(rng, F, H), _f32(rng, H, H), _f32(rng, H))
    return config, {"l": w, "o": {"W": _f32(rng, H, 2), "b": _f32(rng, 2)}}, \
        True, (2, 6, F)


def _embedding(rng):
    config = {"class_name": "Sequential", "config": [
        {"class_name": "Embedding", "config": {
            "name": "emb", "input_dim": 10, "output_dim": 4,
            "batch_input_shape": [None, 1]}},
        {"class_name": "Dropout", "config": {"name": "dr", "rate": 0.25}},
        _dense("out", 3, "linear"),
        {"class_name": "Activation", "config": {"name": "act",
                                                "activation": "softmax"}}]}
    return config, {"emb": {"embeddings": _f32(rng, 10, 4)},
                    "out": {"kernel": _f32(rng, 4, 3),
                            "bias": _f32(rng, 3)}}, False, None


def _time_distributed(rng):    # TestTimeDistributedDense._fixture
    config = {"class_name": "Sequential", "config": {"name": "seq", "layers": [
        {"class_name": "TimeDistributed", "config": {
            "name": "td_1", "batch_input_shape": [None, 6, 5],
            "layer": {"class_name": "Dense", "config": {
                "name": "dense_1", "units": 4, "activation": "relu"}}}},
        {"class_name": "TimeDistributed", "config": {
            "name": "td_2", "layer": {"class_name": "Dense", "config": {
                "name": "dense_2", "units": 3, "activation": "softmax"}}}}]}}
    return config, {"td_1": {"kernel": _f32(rng, 5, 4), "bias": _f32(rng, 4)},
                    "td_2": {"kernel": _f32(rng, 4, 3),
                             "bias": _f32(rng, 3)}}, False, (2, 6, 5)


def _time_distributed_keras1(rng):   # test_keras1_class_and_training
    config = {"class_name": "Sequential", "config": {"name": "seq", "layers": [
        {"class_name": "TimeDistributedDense", "config": {
            "name": "tdd_1", "output_dim": 3, "activation": "softmax",
            "batch_input_shape": [None, 4, 5]}}]}}
    return config, {"tdd_1": {"W": _f32(rng, 5, 3), "b": _f32(rng, 3)}}, \
        True, (3, 4, 5)


def _functional(rng):     # test_modelimport._keras2_functional
    Wa, ba, Wb, bb, Wo, bo = (_f32(rng, 5, 8), _f32(rng, 8), _f32(rng, 5, 8),
                              _f32(rng, 8), _f32(rng, 13, 3), _f32(rng, 3))

    def node(name):
        return [[[name, 0, 0, {}]]]
    config = {"class_name": "Model", "config": {
        "name": "func",
        "layers": [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"name": "input_1", "batch_input_shape": [None, 5]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "dense_a",
             "config": {"name": "dense_a", "units": 8, "activation": "relu"},
             "inbound_nodes": node("input_1")},
            {"class_name": "Dense", "name": "dense_b",
             "config": {"name": "dense_b", "units": 8, "activation": "relu"},
             "inbound_nodes": node("input_1")},
            {"class_name": "Add", "name": "add_1", "config": {"name": "add_1"},
             "inbound_nodes": [[["dense_a", 0, 0, {}],
                                ["dense_b", 0, 0, {}]]]},
            {"class_name": "Concatenate", "name": "cat_1",
             "config": {"name": "cat_1"},
             "inbound_nodes": [[["add_1", 0, 0, {}],
                                ["input_1", 0, 0, {}]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 3, "activation": "softmax"},
             "inbound_nodes": node("cat_1")}],
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    return config, {"dense_a": {"kernel": Wa, "bias": ba},
                    "dense_b": {"kernel": Wb, "bias": bb},
                    "out": {"kernel": Wo, "bias": bo}}, False, (4, 5)


def _functional_merge_ops(rng):
    """Keras-1 Merge modes and Keras-2 merge layers; Flatten aliased."""
    def layer(cls, name, inbound, **cfg):
        return {"class_name": cls, "name": name,
                "config": {"name": name, **cfg},
                "inbound_nodes": [[[i, 0, 0, {}] for i in inbound]]}
    config = {"class_name": "Functional", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "x",
             "config": {"name": "x", "batch_input_shape": [None, 6]},
             "inbound_nodes": []},
            layer("Dense", "a", ["x"], units=4, activation="tanh"),
            layer("Dense", "b", ["x"], units=4, activation="sigmoid"),
            layer("Merge", "m", ["a", "b"], mode="mul"),
            layer("Subtract", "s", ["m", "a"]),
            layer("Maximum", "mx", ["s", "b"]),
            layer("Average", "av", ["mx", "a"]),
            layer("Flatten", "f", ["av"]),
            layer("Dense", "out", ["f"], units=2, activation="softmax")],
        "input_layers": [["x", 0, 0]], "output_layers": [["out", 0, 0]]}}
    return config, {"a": {"kernel": _f32(rng, 6, 4), "bias": _f32(rng, 4)},
                    "b": {"kernel": _f32(rng, 6, 4), "bias": _f32(rng, 4)},
                    "out": {"kernel": _f32(rng, 4, 2),
                            "bias": _f32(rng, 2)}}, False, (3, 6)


CASES = {"mlp": _mlp, "conv": _conv,
         "conv_channels_first_bn": _conv_channels_first, "lstm": _lstm,
         "lstm_stack_hard_sigmoid": _lstm_stack, "lstm_keras1": _lstm_keras1,
         "embedding": _embedding, "time_distributed": _time_distributed,
         "time_distributed_keras1": _time_distributed_keras1,
         "functional": _functional,
         "functional_merge_ops": _functional_merge_ops}


def _inputs(rng, shape):
    if shape is None:               # embedding indices
        return rng.integers(0, 10, (5, 1)).astype(np.float32)
    return _f32(rng, *shape)


def _host(t):
    return t.detach().float().cpu().numpy()


def _assert_same_net(jnet, tnet):
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert set(tnet.params) == set(jnet.params)
    for key, lp in jnet.params.items():
        assert set(tnet.params[key]) == set(lp), key
        for name, a in lp.items():
            np.testing.assert_array_equal(_host(tnet.params[key][name]),
                                          np.asarray(a), err_msg=key + name)
    for key, st in jnet.state.items():
        for name, a in st.items():
            np.testing.assert_array_equal(_host(tnet.state[key][name]),
                                          np.asarray(a), err_msg=key + name)


@pytest.fixture(params=sorted(CASES))
def case(request, tmp_path):
    rng = np.random.default_rng(sorted(CASES).index(request.param))
    config, weights, keras1, shape = CASES[request.param](rng)
    path = str(tmp_path / f"{request.param}.h5")
    _write(path, config, weights, keras1)
    return request.param, path, config, weights, keras1, _inputs(rng, shape)


def test_import_matches_the_reference(case):
    name, path, config, _, _, x = case
    jnet = JImport.import_model(path)
    tnet = KerasModelImport.import_model(path, device="cpu")
    sequential = config["class_name"] == "Sequential"
    assert type(tnet) is (MultiLayerNetwork if sequential
                          else ComputationGraph)
    _assert_same_net(jnet, tnet)
    got, want = _host(tnet.output(x)), np.asarray(jnet.output(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_import_entry_points_match_the_reference(case):
    """The class-specific entry points, and their refusal of the other
    kind, as the reference's."""
    _, path, config, _, _, _ = case
    if config["class_name"] == "Sequential":
        own, other = "import_sequential_model", "import_functional_model"
    else:
        own, other = "import_functional_model", "import_sequential_model"
    _assert_same_net(getattr(JImport, own)(path),
                     getattr(KerasModelImport, own)(path, device="cpu"))
    with pytest.raises(ValueError) as theirs:
        getattr(JImport, other)(path)
    with pytest.raises(ValueError,
                       match=re.escape(str(theirs.value).split(";")[0])):
        getattr(KerasModelImport, other)(path, device="cpu")


def test_config_and_arrays_import_equals_the_file(case):
    name, path, config, weights, keras1, x = case
    arrays = {layer: {(f"{layer}_{k}" if keras1 else k): a
                      for k, a in w.items()} for layer, w in weights.items()}
    from_file = KerasModelImport.import_model(path, device="cpu")
    from_dict = _import_arrays(json.dumps(config), arrays, device="cpu")
    assert type(from_dict) is type(from_file)
    assert from_dict.conf.to_json() == from_file.conf.to_json()
    for key, lp in from_file.params.items():
        for pname, t in lp.items():
            assert torch.equal(from_dict.params[key][pname], t), key + pname
    assert torch.equal(from_dict.output(x), from_file.output(x))


@pytest.mark.parametrize("name", ["mlp", "functional", "lstm",
                                  "time_distributed_keras1"])
def test_imported_net_trains_like_the_reference(name, tmp_path):
    """Five sgd steps from the imported weights: the losses within
    OUT_TOL of the reference's, finite and not diverging."""
    rng = np.random.default_rng(40 + sorted(CASES).index(name))
    config, weights, keras1, shape = CASES[name](rng)
    path = str(tmp_path / "m.h5")
    _write(path, config, weights, keras1)
    jnet = JImport.import_model(path)
    tnet = KerasModelImport.import_model(path, device="cpu")
    x = _inputs(rng, shape)
    n_out = np.asarray(jnet.output(x)).shape[-1]
    lead = x.shape[:2] if name == "time_distributed_keras1" else x.shape[:1]
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, lead)]
    if isinstance(tnet, ComputationGraph):
        x, y = [x], [y]
    jl = [float(jnet.fit_batch(x, y)) for _ in range(5)]
    tl = [float(tnet.fit_batch(x, y)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=OUT_TOL)
    assert np.isfinite(tl).all() and tl[-1] < 2 * tl[0]


def test_gate_reorder_and_peepholes():
    """[i|f|c|o] → [a|i|f|o] with a = Keras's c; the peepholes P stay at
    their zero init (Keras LSTMs have none)."""
    config, weights, _, _ = _lstm(np.random.default_rng(9))
    net = _import_arrays(config, weights, device="cpu")
    W, k = _host(net.params["layer_0"]["W"]), weights["lstm"]["kernel"]
    H = k.shape[1] // 4
    np.testing.assert_array_equal(W[:, :H], k[:, 2 * H:3 * H])
    np.testing.assert_array_equal(W[:, H:2 * H], k[:, :H])
    np.testing.assert_array_equal(W[:, 2 * H:3 * H], k[:, H:2 * H])
    np.testing.assert_array_equal(W[:, 3 * H:], k[:, 3 * H:])
    assert not net.params["layer_0"]["P"].any()


def test_weights_are_written_in_place():
    """The imported values land in the initialised net's own tensors: the
    parameter objects the optimizer state was built for are kept."""
    K = KerasModelImport
    config, weights, _, _ = _mlp(np.random.default_rng(3))
    conf = K._build_sequential_conf(config["config"]["layers"], "mcxent")
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = {k: dict(v) for k, v in net.params.items()}
    K._load_sequential_weights(lambda n: weights.get(n, {}), net,
                               config["config"]["layers"])
    for key, lp in before.items():
        for pname, t in lp.items():
            assert net.params[key][pname] is t
    np.testing.assert_array_equal(_host(net.params["layer_0"]["W"]),
                                  weights["dense_1"]["kernel"])


def test_shape_mismatch_raises():
    config, weights, _, _ = _mlp(np.random.default_rng(4))
    weights["dense_2"]["kernel"] = weights["dense_2"]["kernel"][:, :2]
    with pytest.raises(ValueError, match="dense_2/W: shape"):
        _import_arrays(config, weights, device="cpu")


def test_config_only_import_matches():
    config = {"class_name": "Sequential", "config": [
        _dense("d", 4, "tanh", batch_input_shape=[None, 7]),
        {"class_name": "Dropout", "config": {"name": "dr", "rate": 0.5}},
        _dense("o", 2, "softmax")]}
    got = KerasModelImport.import_model_configuration(json.dumps(config))
    want = JImport.import_model_configuration(json.dumps(config))
    assert got.to_json() == want.to_json()
    assert got.layers[0].n_in == 7 and got.layers[1].dropout == 0.5
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    assert isinstance(got.layers[-1], OutputLayer)


@pytest.mark.parametrize("layer", [
    {"class_name": "Lambda", "config": {"name": "l"}},
    {"class_name": "TimeDistributed", "config": {
        "name": "t", "layer": {"class_name": "Conv2D", "config": {}}}}])
def test_unsupported_layer_raises(layer):
    config = json.dumps({"class_name": "Sequential", "config": [layer]})
    with pytest.raises(ValueError, match="unsupported|only TimeDistributed"):
        JImport.import_model_configuration(config)
    with pytest.raises(ValueError, match="unsupported|only TimeDistributed"):
        KerasModelImport.import_model_configuration(config)


@pytest.mark.parametrize("entry", ["import_model", "import_sequential_model",
                                   "import_functional_model"])
def test_missing_h5py_names_it(entry, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        getattr(KerasModelImport, entry)(str(tmp_path / "m.h5"),
                                         device="cpu")
    # the config-plus-arrays path needs no h5py
    config, weights, _, _ = _mlp(np.random.default_rng(5))
    assert _import_arrays(config, weights, device="cpu").params is not None


def test_weights_only_file_is_refused(tmp_path):
    path = str(tmp_path / "w.h5")
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    with pytest.raises(ValueError, match="no model_config"):
        KerasModelImport.import_model(path, device="cpu")
