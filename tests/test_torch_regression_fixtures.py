"""The format-regression fixtures in the port, and MultiLayerNetwork
checkpoints across the packages, on the CPU.

``tests/resources/regression_v1.zip`` (conv → pool → dense → output,
adam state) and ``regression_v2.zip`` (GravesLSTM → LayerNormalization →
causal SelfAttention → RnnOutput, adam state) were written by the JAX
package; the port must load them and reproduce
``regression_v*_expected.npz`` at the reference test's tolerances
(``tests/test_serialization.py``: output rtol 1e-5 and atol 1e-6, score
rel 1e-5), and resume training from the stored optimizer state.

Round trips: a reference MultiLayerNetwork (conv, BatchNormalization,
adam) trains two steps and is saved; the port loads it, trains two steps
and saves; the reference loads the port's zip. Its parameters, BN running
statistics and adam moments are held to the reference's own four steps
within 1e-4 relative (adam divides by sqrt(v) + eps), the counters
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import (BatchNormalization,
                                               ConvolutionLayer, DenseLayer,
                                               OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.serialization import load_model as j_load
from deeplearning4j_tpu.util.serialization import save_model as j_save

from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import (load_model,
                                                         params_from_numpy,
                                                         save_model)

HERE = os.path.join(os.path.dirname(__file__), "resources")
STEPS = 1e-4


@pytest.fixture(params=["v1", "v2"])
def fixture(request):
    exp = np.load(os.path.join(HERE, f"regression_{request.param}_expected.npz"))
    net = load_model(os.path.join(HERE, f"regression_{request.param}.zip"),
                     device="cpu")
    return net, exp


def test_fixture_loads_and_predicts(fixture):
    net, exp = fixture
    assert isinstance(net, MultiLayerNetwork)
    np.testing.assert_allclose(net.output(exp["x"]).numpy(), exp["out"],
                               rtol=1e-5, atol=1e-6)
    assert net.score_for(exp["x"], exp["y"]) == pytest.approx(
        float(exp["score"]), rel=1e-5)


def test_fixture_resumes_training(fixture):
    net, exp = fixture
    assert net._update_count == 3 and net.updater_state is not None
    s0 = float(exp["score"])
    losses = [float(net.fit_batch(exp["x"], exp["y"])) for _ in range(3)]
    assert np.all(np.isfinite(losses))
    assert net.score_for(exp["x"], exp["y"]) < s0
    assert net._update_count == 6


def test_fixture_params_from_numpy_gives_the_same_function(fixture):
    net, exp = fixture
    arrays = {f"params/{k}/{n}": p.detach().numpy()
              for k, ps in net.params.items() for n, p in ps.items()}
    other = params_from_numpy(net.conf, arrays, device="cpu")
    assert isinstance(other, MultiLayerNetwork)
    assert torch.equal(other.output(exp["x"]), net.output(exp["x"]))


def _conv_bn_conf():
    return (JNNC.builder().seed(21).updater("adam").learning_rate(0.01).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(BatchNormalization())
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 2)).build())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if torch.is_tensor(tree)
                               else tree, np.float64)}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def test_reference_port_reference_round_trip_with_updater_state(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    jnet = JMLN(_conv_bn_conf()).init()
    for _ in range(2):
        jnet.fit_batch(x, y)
    first = str(tmp_path / "ref.zip")
    j_save(jnet, first)

    tnet = load_model(first, device="cpu")
    assert tnet._update_count == 2
    _close(tnet.state["layer_1"]["mean"].numpy(),
           np.asarray(jnet.state["layer_1"]["mean"]), 0.0, "loaded BN mean")
    for _ in range(2):
        tnet.fit_batch(x, y)
        jnet.fit_batch(x, y)
    second = str(tmp_path / "port.zip")
    save_model(tnet, second)

    back = j_load(second)
    assert type(back).__name__ == "MultiLayerNetwork"
    assert back._update_count == jnet._update_count == 4
    assert back.iteration_count == jnet.iteration_count
    for what, got, want in (
            ("params", back.params, jnet.params),
            ("state", back.state, jnet.state),
            ("updater", back.updater_state, jnet.updater_state)):
        g, w = _flat(jax.device_get(got)), _flat(jax.device_get(want))
        assert set(g) == set(w), what
        for k in w:
            _close(g[k], w[k], STEPS, f"{what}{k}")
    # the reference resumes from the port's checkpoint
    np.testing.assert_allclose(
        float(back.fit_batch(x, y)), float(jnet.fit_batch(x, y)), rtol=STEPS)


def test_port_checkpoint_is_bitwise_after_reload(tmp_path):
    """A port save → port load keeps parameters, BN state and the
    updater state bitwise, and the next step's loss equal."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration
    conf = MultiLayerConfiguration.from_json(_conv_bn_conf().to_json())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit_repeated(x, y, 2)
    path = str(tmp_path / "m.zip")
    save_model(net, path)
    back = load_model(path, device="cpu")
    for what in ("params", "state", "updater_state"):
        a, b = _flat(getattr(net, what)), _flat(getattr(back, what))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=what + k)
    assert float(back.fit_batch(x, y)) == float(net.fit_batch(x, y))
