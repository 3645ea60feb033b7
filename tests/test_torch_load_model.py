"""``util.serialization.load_model``'s dispatch on the recorded model class,
against the JAX package's (``deeplearning4j_tpu/util/serialization.py``):
``"ComputationGraph"`` loads a graph, and any other name (a subclass's,
recorded by ``write_model``) or none loads a ``MultiLayerNetwork``. Every
zip is written by the reference and loaded by both packages on the CPU:
parameters bitwise equal, outputs within ``OUT_TOL``.
"""

import hashlib
import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.util.serialization import ModelSerializer
from deeplearning4j_tpu.util.serialization import load_model as j_load_model
from deeplearning4j_tpu_torch.nn.conf import NotYetPorted
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import load_model

OUT_TOL = 1e-6      # one f32 forward of two small dense layers


class MyNetwork(JMultiLayerNetwork):
    """A user's subclass: ``write_model`` records its name."""


def _mln_conf():
    return (NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(1e-2).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())


def _rewrite_state(path, edit):
    """Rewrite ``training_state.json`` in a zip through ``edit`` and
    re-hash it in ``checksums.json``."""
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    state = json.loads(entries["training_state.json"])
    edit(state)
    entries["training_state.json"] = json.dumps(state).encode()
    manifest = json.loads(entries["checksums.json"])
    manifest["training_state.json"] = hashlib.sha256(
        entries["training_state.json"]).hexdigest()
    entries["checksums.json"] = json.dumps(manifest).encode()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in entries.items():
            zf.writestr(name, data)


def _write(case, path):
    if case == "subclass":
        ModelSerializer.write_model(MyNetwork(_mln_conf()).init(), path)
    elif case == "foreign_name":
        ModelSerializer.write_model(JMultiLayerNetwork(_mln_conf()).init(),
                                    path, model_class="TrainingSnapshot")
    else:
        ModelSerializer.write_model(JMultiLayerNetwork(_mln_conf()).init(),
                                    path)
        _rewrite_state(path, lambda s: s.pop("model_class"))


@pytest.mark.parametrize("case", ["subclass", "foreign_name", "missing"])
def test_other_or_missing_class_loads_a_multilayer_network(case, tmp_path):
    path = str(tmp_path / f"{case}.zip")
    _write(case, path)
    with zipfile.ZipFile(path) as zf:
        recorded = json.loads(zf.read("training_state.json")).get(
            "model_class")
    assert recorded == {"subclass": "MyNetwork",
                        "foreign_name": "TrainingSnapshot",
                        "missing": None}[case]
    jnet = j_load_model(path)
    tnet = load_model(path, device="cpu")
    assert isinstance(jnet, JMultiLayerNetwork)
    assert type(tnet) is MultiLayerNetwork
    for key, lp in jnet.params.items():
        for name, a in lp.items():
            np.testing.assert_array_equal(
                tnet.params[key][name].detach().numpy(), np.asarray(a))
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).detach().numpy(),
                               np.asarray(jnet.output(x)), atol=OUT_TOL)


def test_graph_class_loads_a_graph(tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(3).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(5)).build())
    path = str(tmp_path / "graph.zip")
    ModelSerializer.write_model(JComputationGraph(conf).init(), path)
    assert isinstance(j_load_model(path), JComputationGraph)
    assert type(load_model(path, device="cpu")) is ComputationGraph


def test_unregistered_layer_type_still_raises(tmp_path):
    """The repair loads any class name, not any layer: a type no registry
    holds still raises NotYetPorted naming it."""
    path = str(tmp_path / "odd.zip")
    ModelSerializer.write_model(JMultiLayerNetwork(_mln_conf()).init(), path)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    conf = json.loads(entries["configuration.json"])
    conf["layers"][0]["type"] = "no_such_layer"
    entries["configuration.json"] = json.dumps(conf).encode()
    entries.pop("checksums.json")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in entries.items():
            zf.writestr(name, data)
    with pytest.raises(NotYetPorted, match="no_such_layer"):
        load_model(path, device="cpu")


def test_loaded_network_trains_like_the_reference(tmp_path):
    """A subclass-named zip resumes training in the port: one adam step's
    loss within OUT_TOL of the reference's."""
    path = str(tmp_path / "sub.zip")
    _write("subclass", path)
    jnet, tnet = j_load_model(path), load_model(path, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    assert abs(float(jnet.fit_batch(x, y))
               - float(tnet.fit_batch(torch.from_numpy(x),
                                      torch.from_numpy(y)))) <= OUT_TOL
