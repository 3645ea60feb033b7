"""The reference's gradient-check cases (``tests/test_gradientcheck.py``)
on the port's layers: ``gradientcheck.check_gradients`` moves each
checked parameter entry by ±1e-6 in float64 and compares the central
difference with torch autograd through the port's forward functions,
relative error at most 1e-5 (entries whose absolute difference is below
1e-9 are not judged). Dense/activation/loss combinations, l1/l2,
convolution and pooling, BatchNormalization's hand-written backward,
LRN, GravesLSTM (masked), the bidirectional LSTM, global pooling,
embeddings and LayerNormalization; a graph (ResNet blocks with BN and
residual sums); and a planted wrong backward that the check must catch.
Inputs from a seed with numpy (the ``rng`` fixture).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.gradientcheck import (_check_loss_fn,
                                                    check_gradients,
                                                    check_graph_gradients)
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    EmbeddingLayer, GlobalPoolingLayer, LocalResponseNormalization,
    OutputLayer, RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    GravesBidirectionalLSTM, GravesLSTM)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A check is thousands of tiny f64 evaluations: intra-op threads gain
    nothing there and, beside the suite's other workers, only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MAX_REL = 1e-5


def _builder(l1=0.0, l2=0.0):
    b = (NeuralNetConfiguration.builder().seed(12345)
         .updater("sgd").learning_rate(0.1))
    if l1 or l2:
        b = b.regularization(True).l1(l1).l2(l2)
    return b


def _class_labels(rng, n, c):
    return np.eye(c)[rng.integers(0, c, n)]


class TestDenseGradients:
    @pytest.mark.parametrize("act,loss,out_act", [
        ("tanh", "mcxent", "softmax"),
        ("relu", "mse", "identity"),
        ("sigmoid", "xent", "sigmoid"),
        ("elu", "l1", "tanh"),
        ("softplus", "mcxent", "softmax"),
    ])
    def test_dense_activation_loss_combos(self, rng, act, loss, out_act):
        x = rng.normal(size=(8, 5))
        c = 3
        y = (_class_labels(rng, 8, c) if loss in ("mcxent", "xent")
             else rng.normal(size=(8, c)))
        conf = (_builder().list()
                .layer(DenseLayer(n_out=6, activation=act))
                .layer(OutputLayer(n_out=c, activation=out_act, loss=loss))
                .set_input_type(InputType.feed_forward(5)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()

    def test_dense_with_l1_l2(self, rng):
        x = rng.normal(size=(6, 4))
        y = _class_labels(rng, 6, 3)
        conf = (_builder(l1=0.01, l2=0.02).list()
                .layer(DenseLayer(n_out=5, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()

    def test_activation_layer(self, rng):
        x = rng.normal(size=(6, 4))
        y = _class_labels(rng, 6, 2)
        conf = (_builder().list()
                .layer(DenseLayer(n_out=5, activation="identity"))
                .layer(ActivationLayer(activation="leakyrelu"))
                .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()


class TestConvGradients:
    @pytest.mark.parametrize("stride,pad", [((1, 1), "valid"), ((2, 2), "same")])
    def test_conv_pool_dense(self, rng, stride, pad):
        # NHWC input 6x6x2
        x = rng.normal(size=(4, 6, 6, 2))
        y = _class_labels(rng, 4, 3)
        conf = (_builder().list()
                .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                        stride=stride, padding=pad,
                                        activation="tanh"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(6, 6, 2)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=20)
        assert r.passed, r.summary()

    def test_avg_pooling(self, rng):
        x = rng.normal(size=(3, 4, 4, 2))
        y = _class_labels(rng, 3, 2)
        conf = (_builder().list()
                .layer(ConvolutionLayer(n_out=2, kernel_size=(2, 2),
                                        activation="sigmoid"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="avg"))
                .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(4, 4, 2)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()

    def test_batchnorm_train_mode(self, rng):
        x = rng.normal(size=(8, 4, 4, 2))
        y = _class_labels(rng, 8, 2)
        conf = (_builder().list()
                .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                        activation="identity"))
                .layer(BatchNormalization())
                .layer(ActivationLayer(activation="relu"))
                .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(4, 4, 2)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=20)
        assert r.passed, r.summary()

    def test_lrn(self, rng):
        x = rng.normal(size=(3, 4, 4, 4))
        y = _class_labels(rng, 3, 2)
        conf = (_builder().list()
                .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        padding="same", activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(4, 4, 4)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=20)
        assert r.passed, r.summary()


class TestRecurrentGradients:
    def test_lstm_rnn_output(self, rng):
        x = rng.normal(size=(4, 5, 3))  # [b, t, f]
        y = np.eye(2)[rng.integers(0, 2, (4, 5))]
        conf = (_builder().list()
                .layer(GravesLSTM(n_out=4, activation="tanh"))
                .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(3)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=25)
        assert r.passed, r.summary()

    def test_lstm_masked(self, rng):
        x = rng.normal(size=(4, 6, 3))
        y = np.eye(2)[rng.integers(0, 2, (4, 6))]
        mask = np.ones((4, 6))
        mask[1, 4:] = 0
        mask[3, 2:] = 0
        conf = (_builder().list()
                .layer(GravesLSTM(n_out=3, activation="tanh"))
                .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(3)).build())
        r = check_gradients(conf, x, y, device="cpu", mask=mask, max_rel_error=MAX_REL,
                            max_per_param=25)
        assert r.passed, r.summary()

    def test_bidirectional_lstm(self, rng):
        x = rng.normal(size=(3, 4, 3))
        y = np.eye(2)[rng.integers(0, 2, (3, 4))]
        conf = (_builder().list()
                .layer(GravesBidirectionalLSTM(n_out=3, activation="tanh"))
                .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(3)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=20)
        assert r.passed, r.summary()

    def test_lstm_to_dense_last_step(self, rng):
        """RNN → global pooling → dense classification."""
        x = rng.normal(size=(4, 5, 3))
        y = _class_labels(rng, 4, 2)
        conf = (_builder().list()
                .layer(GravesLSTM(n_out=4, activation="tanh"))
                .layer(GlobalPoolingLayer(pooling_type="max"))
                .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(3)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL,
                            max_per_param=25)
        assert r.passed, r.summary()


class TestEmbeddingGradients:
    def test_embedding(self, rng):
        # embedding input: integer indices as [b, 1]
        x = rng.integers(0, 5, size=(6, 1)).astype(np.float64)
        y = _class_labels(rng, 6, 3)
        conf = (_builder().list()
                .layer(EmbeddingLayer(n_out=4, activation="identity",
                                      has_bias=False))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(5)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()


class TestLayerNormGradients:
    def test_layer_norm(self, rng):
        from deeplearning4j_tpu_torch.nn.conf.layers import LayerNormalization
        x = rng.normal(size=(6, 5))
        y = _class_labels(rng, 6, 3)
        conf = (_builder().list()
                .layer(DenseLayer(n_out=8, activation="tanh"))
                .layer(LayerNormalization())
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(5)).build())
        r = check_gradients(conf, x, y, device="cpu", max_rel_error=MAX_REL)
        assert r.passed, r.summary()


class TestGraphGradients:
    def test_resnet_blocks_with_bn(self, rng):
        from deeplearning4j_tpu_torch.models import resnet
        conf = resnet((1, 1), height=8, width=8, channels=2, n_classes=3,
                      width_base=2, dtype="float32")
        x = rng.normal(size=(4, 8, 8, 2))
        y = _class_labels(rng, 4, 3)
        r = check_graph_gradients(conf, x, y, max_rel_error=MAX_REL,
                                  max_per_param=3, device="cpu")
        assert r.passed, r.summary()


class TestHarnessCatchesErrors:
    def test_detects_wrong_gradient(self):
        """A deliberately broken backward must FAIL the check."""

        class BadSquare(torch.autograd.Function):
            @staticmethod
            def forward(ctx, w):
                ctx.save_for_backward(w)
                return torch.sum(w ** 2)

            @staticmethod
            def backward(ctx, g):
                w, = ctx.saved_tensors
                return g * 2.5 * w            # wrong: should be 2*w

        params = {"p": {"w": torch.tensor([1.0, 2.0, 3.0],
                                          dtype=torch.float64,
                                          requires_grad=True)}}
        r = _check_loss_fn(lambda p: BadSquare.apply(p["p"]["w"]), params,
                           1e-6, 1e-5, 1e-9, None, 0)
        assert not r.passed and r.n_checked == 3
        ok = _check_loss_fn(lambda p: torch.sum(p["p"]["w"] ** 2), params,
                            1e-6, 1e-5, 1e-9, None, 0)
        assert ok.passed, ok.summary()
