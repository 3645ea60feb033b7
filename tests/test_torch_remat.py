"""Gradient checkpointing in the port's two runtimes, on the CPU: the
cases of ``tests/test_remat.py`` — recomputation changes the memory
schedule, never the function — plus the port's own trouble spots: the
dropout generator (a segment's recompute must draw its first forward's
masks), BN state persisted from the first forward, the masked-input
warning and the health-stats bypass; and the reference's checkpointed
losses from the same weights.

Tolerances: remat against no remat on one package, losses within 1e-6
relative and gradients within 1e-5 of each leaf's largest magnitude (the
recompute runs the same kernels in the same order); against the
reference, f32 losses within 1e-5 and a few steps within 1e-4.
"""

import copy
import json

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import deeplearning4j_tpu.nn.conf.layers as JL
from deeplearning4j_tpu.models import resnet as j_resnet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.serialization import save_model as j_save

import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.graph_runtime as graph_runtime
import deeplearning4j_tpu_torch.nn.multilayer as multilayer
from deeplearning4j_tpu_torch.models import resnet, transformer_lm
from deeplearning4j_tpu_torch.nn.conf import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.recurrent import GravesLSTM
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import health as t_health
from deeplearning4j_tpu_torch.util.serialization import load_model


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture
def segments(monkeypatch):
    """Counts the checkpointed segments each runtime runs."""
    calls = []
    for mod in (multilayer, graph_runtime):
        orig = mod.checkpoint_segment

        def spy(*a, _orig=orig, **kw):
            calls.append(1)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, "checkpoint_segment", spy)
    return calls


def _conv_conf(nnc, L, it, remat, dropout=None):
    b = nnc.builder().seed(5).updater("adam").learning_rate(0.01)
    if remat:
        b = b.gradient_checkpointing()
    return (b.list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation="relu"))
            .layer(L.BatchNormalization())
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation="tanh", dropout=dropout))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(it.convolutional(8, 8, 2)).build())


def _conv_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 8, 8, 2)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])


def _mln_pair(remat, dropout=None):
    """(plain, checkpointed) MultiLayerNetworks with the same weights."""
    a = MultiLayerNetwork(_conv_conf(TNNC, TL, TInputType, False, dropout),
                          device="cpu").init()
    b = MultiLayerNetwork(_conv_conf(TNNC, TL, TInputType, remat, dropout),
                          device="cpu")
    b.set_params(a.clone_params())
    b.init_updater()
    return a, b


def _grads_close(ga, gb, tol=1e-5):
    for v in ga:
        for k in ga[v]:
            assert _rel(gb[v][k].numpy(), ga[v][k].numpy()) <= tol, (v, k)


def test_mln_losses_identical_with_and_without(segments):
    x, y = _conv_batch()
    plain, remat = _mln_pair(True)
    for step in range(4):
        lp = float(plain.fit_batch(x, y))
        n = len(segments)
        lr = float(remat.fit_batch(x, y))
        # 4 hidden layers → ceil(sqrt(4)) = 2 checkpointed segments a step
        assert len(segments) - n == 2, "the MLN step is not checkpointed"
        assert lp == pytest.approx(lr, rel=1e-6), step
    for a, b in zip(plain.state.values(), remat.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("runtime", ["mln", "graph"])
def test_dropout_masks_survive_the_recompute(runtime):
    """With dropout on, the checkpointed step's loss and gradients equal
    the full walk's from the same step generator; without the generator
    restore, the recompute draws other masks and the gradients part."""
    if runtime == "mln":
        x, y = _conv_batch(1)
        plain, remat = _mln_pair(True, dropout=0.5)
        args = (torch.from_numpy(x), torch.from_numpy(y), None)
    else:
        plain, remat = _graph_pair(dropout=0.5)
        ids = np.random.default_rng(2).integers(0, 13, (2, 9)).astype(
            np.int32)
        args = ([torch.from_numpy(ids[:, :-1])],
                [torch.from_numpy(ids[:, 1:])], None)

    def grads(net):
        out = net._loss_and_grads(*args,
                                  generator=net._generator("update_0"))
        return out[0], out[1]

    lp, gp = grads(plain)
    lr, gr = grads(remat)
    assert float(lp) == pytest.approx(float(lr), rel=1e-6)
    _grads_close(gp, gr)
    # a planted fault: the segments forget the generator's state, so the
    # recompute draws on from where the forward left the stream
    mod = multilayer if runtime == "mln" else graph_runtime
    orig = mod.checkpoint_segment
    mod.checkpoint_segment = lambda fn, gen, *a: checkpoint(
        fn, *a, use_reentrant=False)
    try:
        _, gf = grads(remat)
    finally:
        mod.checkpoint_segment = orig
    worst = max(_rel(gf[v][k].numpy(), gp[v][k].numpy())
                for v in gp for k in gp[v] if gp[v][k].abs().max() > 0)
    assert worst > 1e-3


def test_mln_masked_rnn_remat(segments):
    def conf(remat):
        b = TNNC.builder().seed(8).updater("sgd").learning_rate(0.05)
        if remat:
            b = b.gradient_checkpointing()
        return (b.list().layer(GravesLSTM(n_out=12, activation="tanh"))
                .layer(TL.RnnOutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"))
                .set_input_type(TInputType.recurrent(5)).build())

    rng = np.random.default_rng(12345)
    x = rng.normal(size=(4, 7, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))]
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    plain = MultiLayerNetwork(conf(False), device="cpu").init()
    remat = MultiLayerNetwork(conf(True), device="cpu")
    remat.set_params(plain.clone_params())
    remat.init_updater()
    for _ in range(3):
        lp = float(plain.fit_batch(x, y, mask))
        lr = float(remat.fit_batch(x, y, mask))
        assert lp == pytest.approx(lr, rel=1e-6)
    assert segments


def _graph_pair(dropout=None):
    conf = transformer_lm(13, n_layers=2, d_model=16, n_heads=2, d_ff=32,
                          input_ids=True, seed=3)
    if dropout:
        conf.vertices["blk0_ff1"].layer.dropout = dropout
        conf.vertices["blk1_attn"].layer.dropout = dropout
    plain = ComputationGraph(conf, device="cpu").init()
    c2 = copy.deepcopy(conf)
    c2.training.gradient_checkpointing = True
    remat = ComputationGraph(c2, device="cpu")
    remat.set_params(plain.clone_params())
    remat.init_updater()
    return plain, remat


def test_graph_runtime_remat(segments):
    def gconf(remat):
        b = TNNC.builder().seed(2).updater("sgd").learning_rate(0.1)
        if remat:
            b = b.gradient_checkpointing()
        return (b.graph_builder().add_inputs("in")
                .add_layer("d1", TL.DenseLayer(n_in=6, n_out=12,
                                               activation="tanh"), "in")
                .add_layer("out", TL.OutputLayer(n_in=12, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "d1")
                .set_outputs("out").build())

    rng = np.random.default_rng(12345)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    plain = ComputationGraph(gconf(False), device="cpu").init()
    remat = ComputationGraph(gconf(True), device="cpu")
    remat.set_params(plain.clone_params())
    remat.init_updater()
    plain.fit_batch([x], [y])
    assert not segments
    remat.fit_batch([x], [y])
    assert segments
    for _ in range(3):
        lp = float(plain.fit_batch([x], [y]))
        lr = float(remat.fit_batch([x], [y]))
        assert lp == pytest.approx(lr, rel=1e-6)


def test_graph_segment_plan_publishes_boundaries():
    """About √V segments; every activation a later segment or a loss head
    reads is published; the unconsumed output layer is left to its
    score."""
    _, net = _graph_pair()
    segs, skip = net._segment_plan()
    order = net.topo_order
    assert skip == {"out"}
    assert len(segs) == int(np.ceil(np.sqrt(len(order))))
    published = {"in"} | {o for _, _, outs in segs for o in outs}
    for seg, ext_in, _ in segs:
        assert set(ext_in) <= published
    assert "final_ln" in published


def test_graph_transformer_grads_equal_with_remat(segments):
    plain, remat = _graph_pair()
    ids = np.random.default_rng(4).integers(0, 13, (3, 9)).astype(np.int32)
    args = ([torch.from_numpy(ids[:, :-1])], [torch.from_numpy(ids[:, 1:])],
            None)
    lp, gp = plain._loss_and_grads(*args)
    assert not segments
    lr, gr = remat._loss_and_grads(*args)
    assert len(segments) == len(remat._segment_plan()[0])
    assert float(lp) == pytest.approx(float(lr), rel=1e-6)
    _grads_close(gp, gr)


def test_graph_remat_resnet_block_parity():
    """Segment planning on a real DAG (residual blocks, BN state): losses
    and the persisted running statistics — the first forward's, not the
    recompute's — identical."""
    rng = np.random.default_rng(12345)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    nets = {}
    for remat in (False, True):
        conf = resnet(blocks=(1, 1), height=16, width=16, n_classes=5,
                      dtype="float32")
        conf.training.gradient_checkpointing = remat
        nets[remat] = ComputationGraph(conf, device="cpu")
    nets[False].init()
    nets[True].set_params(nets[False].clone_params())
    nets[True].init_updater()
    for _ in range(3):
        lp = float(nets[False].fit_batch([x], [y]))
        lr = float(nets[True].fit_batch([x], [y]))
        assert lp == pytest.approx(lr, rel=1e-5)
    moved = 0
    for name, st in nets[False].state.items():
        for k, a in st.items():
            b = nets[True].state[name][k]
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), (name, k)
            moved += int(k == "mean" and a.abs().max() > 0)
    assert moved > 0


def test_masked_graph_inputs_warn_and_run_the_full_walk(segments):
    plain, remat = _graph_pair()
    ids = np.random.default_rng(5).integers(0, 13, (2, 9)).astype(np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[0, 5:] = 0.0
    with pytest.warns(UserWarning, match="gradient_checkpointing is ignored"):
        lr = remat.fit_batch([ids[:, :-1]], [ids[:, 1:]], [mask])
    assert not segments
    lp = plain.fit_batch([ids[:, :-1]], [ids[:, 1:]], [mask])
    assert float(lp) == float(lr)


def test_health_stats_step_bypasses_remat(segments):
    plain, remat = _graph_pair()
    ids = np.random.default_rng(6).integers(0, 13, (2, 9)).astype(np.int32)
    plain.enable_health_stats()
    remat.enable_health_stats()
    lp = plain.fit_batch([ids[:, :-1]], [ids[:, 1:]])
    lr = remat.fit_batch([ids[:, :-1]], [ids[:, 1:]])
    assert not segments
    assert float(lp) == float(lr)
    assert t_health.latest_stats(remat).value()["blk0_attn"]["grad_norm"] > 0


def test_config_json_roundtrip_equals_reference():
    conf = _conv_conf(TNNC, TL, TInputType, True)
    assert conf.training.gradient_checkpointing is True
    restored = MultiLayerConfiguration.from_json(conf.to_json())
    assert restored.training.gradient_checkpointing is True
    assert restored.to_json() == conf.to_json()
    assert json.loads(conf.to_json()) == json.loads(
        _conv_conf(JNNC, JL, JInputType, True).to_json())


def test_remat_losses_equal_reference(tmp_path):
    """The reference's checkpointed MLN and ResNet graph, saved and loaded
    into the port: the checkpointed steps' losses agree."""
    x, y = _conv_batch(3)
    jnet = JMLN(_conv_conf(JNNC, JL, JInputType, True)).init()
    path = str(tmp_path / "mln.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    assert tnet.training.gradient_checkpointing
    jl = [float(jnet.fit_batch(x, y)) for _ in range(3)]
    tl = [float(tnet.fit_batch(x, y)) for _ in range(3)]
    assert _rel(tl, jl) <= 1e-4
    conf = j_resnet(blocks=(1, 1), height=16, width=16, n_classes=5,
                    dtype="float32")
    conf.training.gradient_checkpointing = True
    jg = JComputationGraph(conf).init()
    path = str(tmp_path / "res.zip")
    j_save(jg, path)
    tg = load_model(path, device="cpu")
    rng = np.random.default_rng(7)
    xr = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    yr = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    assert _rel(float(tg.fit_batch([xr], [yr])),
                float(jg.fit_batch([xr], [yr]))) <= 1e-5
