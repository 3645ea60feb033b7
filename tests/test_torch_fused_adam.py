"""The multi-tensor adam kernel (``ops/fused_adam.py``,
``ops/csrc/fused_adam.cu``) and the updater's in-place step that routes
adam's leaves to it (``optimize/updaters.py::update_in_place``).

On the CPU: the routing rule (adam only; contiguous f32 CUDA leaves only,
``fused_adam.takes``);
the kernel's plain version bitwise equal to ``Updater.update`` +
``apply_updates`` over 20 steps on trees of odd leaf lengths with per-leaf
learning rates, its delta output equal to the plain deltas; the kernel's
blocks covering every element of every leaf exactly once, within the
kernel parameter space; ``updater_leaves_total{model, path}`` through
``fit``, ``fit_scan`` and truncated BPTT. The CPU stands in for the card
where a test sets ``fused_adam.DEVICE_TYPE`` to ``"cpu"``: the rule then
routes CPU leaves to the fused step, which runs the plain version.

Card-only (``-m cuda``; skipped without a card; this file imports no JAX,
so it runs there with ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_adam.py``): the kernel against the plain per-leaf
path bitwise on p, m and v over 20 steps at OPT-125m's 137 leaf shapes,
two runs bitwise equal, a replaced ``updater_state`` (as after a
checkpoint restore) picked up on the next step, and a health-stats step
equal to a plain one.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn.conf.recurrent as TR
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.training import TrainingConfig
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_adam as fa
from deeplearning4j_tpu_torch.optimize import updaters as U

STEPS = 20
# odd lengths, a leaf over two chunks, an empty vertex, LR multipliers
SHAPES = {"a": {"W": (3, 7), "b": (5,)}, "e": {},
          "c": {"W": (2 * fa.CHUNK + 13,), "gamma": (1,)}}
MULTS = {"a": {"W": 1.0, "b": 0.5}, "e": {}, "c": {"W": 2.0, "gamma": 0.25}}


def _tree(shapes, gen, device="cpu"):
    return {v: {k: torch.randn(s, generator=gen).to(device)
                for k, s in d.items()} for v, d in shapes.items()}


def _clone(tree):
    return {v: {k: x.clone() for k, x in d.items()} for v, d in tree.items()}


def _bitwise(a, b):
    return all(torch.equal(a[v][k], b[v][k]) for v in a for k in a[v])


# --------------------------------------------------------------------------
# the routing rule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["adam", "adamax", "nadam", "nesterovs",
                                  "sgd"])
def test_only_adam_routes_to_the_kernel(monkeypatch, rule):
    """Of the rules, adam alone has a fused step: its leaves on the
    kernel's device go fused, every other rule's plain."""
    monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    upd = U.make_updater(TrainingConfig(updater=rule, learning_rate=1e-2,
                                        momentum=0.9))
    assert (upd.step is not None) == (rule == "adam")
    params = _tree(SHAPES, torch.Generator().manual_seed(0))
    grads = _tree(SHAPES, torch.Generator().manual_seed(1))
    counter = U.leaves_counter()
    before = {k: counter.value(model=rule, path=k) for k in ("fused",
                                                             "plain")}
    U.update_in_place(upd, params, grads, upd.init(params), 0, model=rule)
    fused = counter.value(model=rule, path="fused") - before["fused"]
    plain = counter.value(model=rule, path="plain") - before["plain"]
    assert (fused, plain) == ((4, 0) if rule == "adam" else (0, 4))


def test_only_contiguous_f32_leaves_on_the_kernels_device_route(monkeypatch):
    f32 = [torch.zeros(4, 6) for _ in range(4)]
    assert not fa.takes(*f32)                       # CPU leaves: plain
    monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    assert fa.takes(*f32)
    for i in range(4):
        bf16 = list(f32)
        bf16[i] = torch.zeros(4, 6, dtype=torch.bfloat16)
        assert not fa.takes(*bf16)
        strided = list(f32)
        strided[i] = torch.zeros(6, 4).t()
        assert not fa.takes(*strided)
        other = list(f32)
        other[i] = torch.zeros(25)
        assert not fa.takes(*other)
    assert fa.records(*([x] for x in f32))[0][4] == 24
    assert fa.records(*([x] for x in bf16)) == [None]


def test_the_wrapper_raises_on_what_it_does_not_take():
    leaf = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ValueError, match="contiguous f32 CUDA"):
        fa.adam_cuda(*([x] for x in leaf), [1e-3],
                     fa.Scalars.at(0.9, 0.999, 1e-8, 0))


# --------------------------------------------------------------------------
# the arithmetic
# --------------------------------------------------------------------------


def _plain_version_run(steps, shapes, mults, want_deltas):
    """``steps`` adam steps on one seeded tree, through ``Updater.update``
    + ``apply_updates`` and through the kernel's plain version; returns
    both sides' (params, state, deltas of every step)."""
    t = TrainingConfig(updater="adam", learning_rate=3e-3)
    upd = U.make_updater(t, mults)
    gen = torch.Generator().manual_seed(7)
    p1 = _tree(shapes, gen)
    p2 = _clone(p1)
    s1, s2 = upd.init(p1), upd.init(p2)
    paths = U._flatten(p1)[0]
    d1s, d2s = [], []
    for it in range(steps):
        grads = _tree(shapes, gen)
        d1, s1 = upd.update(grads, s1, it)
        U.apply_updates(p1, d1)
        lr = U._F32(U.learning_rate_at(t, it))
        lrs = [float(lr * U._F32(U._at(mults, q))) for q in paths]
        ds = ([torch.empty_like(U._at(p2, q)) for q in paths]
              if want_deltas else None)
        fa.adam_plain(*([U._at(tree, q) for q in paths]
                        for tree in (p2, grads, s2["m"], s2["v"])), lrs,
                      fa.Scalars.at(t.adam_beta1, t.adam_beta2, t.epsilon,
                                    it), ds)
        d1s.append(d1)
        d2s.append(ds and U._from_paths(paths, ds, p2))
    return (p1, s1, d1s), (p2, s2, d2s)


@pytest.mark.parametrize("want_deltas", [False, True])
def test_plain_version_equals_the_plain_path_bitwise(want_deltas):
    (p1, s1, d1s), (p2, s2, d2s) = _plain_version_run(STEPS, SHAPES, MULTS,
                                                      want_deltas)
    assert _bitwise(p1, p2)
    assert _bitwise(s1["m"], s2["m"]) and _bitwise(s1["v"], s2["v"])
    if want_deltas:
        assert all(_bitwise(a, b) for a, b in zip(d1s, d2s))


@pytest.mark.parametrize("want_deltas", [False, True])
def test_fused_step_equals_update_and_apply_bitwise(monkeypatch, want_deltas):
    """``update_in_place`` with every leaf routed to the fused step (the
    plain version standing in for the kernel) against the plain path: the
    same parameters, state and (when asked) deltas, and the counter's
    leaves all fused."""
    monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    t = TrainingConfig(updater="adam", learning_rate=3e-3)
    upd = U.make_updater(t, MULTS)
    gen = torch.Generator().manual_seed(3)
    p1 = _tree(SHAPES, gen)
    p2 = _clone(p1)
    s1, s2 = upd.init(p1), upd.init(p2)
    counter = U.leaves_counter()
    fused0 = counter.value(model="test", path="fused")
    for it in range(5):
        grads = _tree(SHAPES, gen)
        d1, s1 = upd.update(grads, s1, it)
        U.apply_updates(p1, d1)
        d2, s2 = U.update_in_place(upd, p2, grads, s2, it,
                                   want_deltas=want_deltas, model="test")
        assert (d2 is not None) == want_deltas
        if want_deltas:
            assert _bitwise(d1, d2)
    assert _bitwise(p1, p2)
    assert _bitwise(s1["m"], s2["m"]) and _bitwise(s1["v"], s2["v"])
    assert set(s2["m"]) == set(p2) and s2["m"]["e"] == {}
    assert counter.value(model="test", path="fused") - fused0 == 5 * 4


def test_mixed_tree_routes_leaf_by_leaf(monkeypatch):
    """A tree with one bf16 leaf: the other leaves go fused, that one
    plain, and the result is still the plain path's."""
    monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    t = TrainingConfig(updater="adam", learning_rate=1e-2)
    upd = U.make_updater(t, MULTS)
    gen = torch.Generator().manual_seed(5)
    p1 = _tree(SHAPES, gen)
    p1["a"]["b"] = p1["a"]["b"].bfloat16()
    p2 = _clone(p1)
    s1, s2 = upd.init(p1), upd.init(p2)
    counter = U.leaves_counter()
    before = {k: counter.value(model="mixed", path=k)
              for k in ("fused", "plain")}
    for it in range(3):
        grads = _tree(SHAPES, gen)
        grads["a"]["b"] = grads["a"]["b"].bfloat16()
        d1, s1 = upd.update(grads, s1, it)
        U.apply_updates(p1, d1)
        _, s2 = U.update_in_place(upd, p2, grads, s2, it, model="mixed")
    assert _bitwise(p1, p2)
    assert _bitwise(s1["m"], s2["m"]) and _bitwise(s1["v"], s2["v"])
    assert counter.value(model="mixed", path="fused") - before["fused"] == 9
    assert counter.value(model="mixed", path="plain") - before["plain"] == 3


def test_the_bias_corrections_are_the_f32_reciprocals():
    s = fa.Scalars.at(0.9, 0.999, 1e-8, 4)
    bc1 = np.float32(1) - np.float32(0.9) ** np.float32(5)
    assert s.ibc1 == float(np.float32(1) / bc1)
    assert s.omb1 == float(np.float32(1 - 0.9))
    assert s.eps == float(np.float32(1e-8))


# --------------------------------------------------------------------------
# the kernel's blocks and its parameter table
# --------------------------------------------------------------------------


LENGTHS = [
    [1, 768, fa.CHUNK, fa.CHUNK + 1, 3 * fa.CHUNK - 1, 0, 7],
    [0, 0, 5],
    [fa.CHUNK] * (fa.MAX_LEAVES + 3),
    [(i * 7919) % (3 * fa.CHUNK) for i in range(2 * fa.MAX_LEAVES + 1)],
]


@pytest.mark.parametrize("lengths", LENGTHS,
                         ids=["odd", "empties", "over_one_launch", "many"])
def test_blocks_cover_every_element_once(lengths):
    seen = [np.zeros(n, dtype=np.int64) for n in lengths]
    for launch in fa.plan(lengths):
        assert 1 <= len(launch) <= fa.MAX_LEAVES
        assert launch[0][1] == 0
        for b in range(fa.launch_blocks(launch, lengths)):
            i, lo, hi = fa.block_span(launch, lengths, b)
            assert 0 <= lo < hi <= lengths[i] and lo % 4 == 0
            seen[i][lo:hi] += 1
    for s in seen:
        assert (s == 1).all()


def test_the_table_matches_the_kernel_source():
    """The wrapper's constants are the source's, a leaf record is the
    kernel's 56-byte ``Leaf``, and a full table fits CUDA 12.1's kernel
    parameter space."""
    src = (Path(fa.__file__).parent / "csrc" / "fused_adam.cu").read_text()
    defines = dict(re.findall(r"#define FUSED_ADAM_(\w+) (\d+)", src))
    assert int(defines["CHUNK"]) == fa.CHUNK
    assert int(defines["MAX_LEAVES"]) == fa.MAX_LEAVES
    assert fa.LEAF.itemsize == 56
    assert fa.SCALARS_BYTES + fa.LEAF.itemsize * fa.MAX_LEAVES \
        <= fa.PARAM_BYTES
    # OPT-125m's 137 leaves: above the classic 4 KB of kernel parameters
    assert fa.SCALARS_BYTES + fa.LEAF.itemsize * 137 > 4096


# --------------------------------------------------------------------------
# the counter through the runtimes
# --------------------------------------------------------------------------


def _mln(updater="adam"):
    conf = (NeuralNetConfiguration.builder().seed(1).updater(updater)
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph(updater="adam"):
    conf = (NeuralNetConfiguration.builder().seed(3).updater(updater)
            .learning_rate(0.01).graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf, device="cpu").init()


def _tbptt(updater="adam"):
    conf = (NeuralNetConfiguration.builder().seed(3).updater(updater)
            .learning_rate(5e-3).list()
            .layer(TR.GravesLSTM(n_out=5, activation="tanh"))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(6))
            .backprop_type("truncated_bptt")
            .t_bptt_forward_length(4).t_bptt_backward_length(4)
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _fit(net):
    x, y = _data()
    net.fit(ArrayDataSetIterator(x, y, 16))     # 4 updates


def _fit_scan(net):
    x, y = _data(48)
    net.fit_scan(x.reshape(3, 16, 4), y.reshape(3, 16, 3))     # 3 updates


def _fit_tbptt(net):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 12, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (8, 12))]
    net.fit_batch(x, y)                         # 3 chunks of 4: 3 updates


CASES = {"fit_mln": (_mln, _fit, 4, "MultiLayerNetwork"),
         "fit_graph": (_graph, _fit, 4, "ComputationGraph"),
         "fit_scan_mln": (_mln, _fit_scan, 3, "MultiLayerNetwork"),
         "fit_scan_graph": (_graph, _fit_scan, 3, "ComputationGraph"),
         "tbptt": (_tbptt, _fit_tbptt, 3, "MultiLayerNetwork")}


def _leaves_moved(make, drive, updater, monkeypatch, on_device):
    if on_device:
        monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    net = make(updater)
    model = type(net).__name__
    counter = U.leaves_counter()
    before = {k: counter.value(model=model, path=k)
              for k in ("fused", "plain")}
    drive(net)
    n = sum(1 for _ in U._leaves(net.params))
    return n, {k: counter.value(model=model, path=k) - before[k]
               for k in before}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("updater,on_device", [("adam", True),
                                               ("adam", False),
                                               ("nesterovs", True)])
def test_leaves_counted_by_path(monkeypatch, case, updater, on_device):
    """Per update, every leaf once: fused for adam on the kernel's device,
    plain for adam on another device and for every other rule."""
    make, drive, updates, _ = CASES[case]
    n, moved = _leaves_moved(make, drive, updater, monkeypatch, on_device)
    fused = updater == "adam" and on_device
    assert moved == {"fused": updates * n if fused else 0,
                     "plain": 0 if fused else updates * n}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_fit_equals_plain_fit_bitwise(monkeypatch, case):
    """The same fit through the fused step (the plain version standing in
    for the kernel) and through the plain path: parameters and adam state
    bitwise equal."""
    make, drive, _, _ = CASES[case]
    plain = make()
    drive(plain)
    monkeypatch.setattr(fa, "DEVICE_TYPE", "cpu")
    fused = make()
    drive(fused)
    assert _bitwise(plain.params, fused.params)
    for slot in ("m", "v"):
        assert _bitwise(plain.updater_state[slot],
                        fused.updater_state[slot])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def opt125m_shapes():
    """OPT-125m's 137 parameter leaves as the port builds them
    (``transformer_lm`` at its published widths)."""
    from deeplearning4j_tpu_torch.dtypes import policy_from_name
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    conf = transformer_lm(50272, n_layers=12, d_model=768, n_heads=12,
                          d_ff=3072, updater="adam", learning_rate=3e-4,
                          dtype="mixed_bf16", input_ids=True)
    policy = policy_from_name(conf.training.dtype)
    return {n: dict(conf.vertices[n].param_shapes(policy))
            for n in conf.topological_order()}


def _card_run(shapes, device, kernel: bool, steps=STEPS, seed=11):
    """``steps`` adam steps from seeded parameters and gradients drawn on
    the card, through the fused step (``kernel``) or the plain per-leaf
    path; returns (params, state, kernel launches)."""
    t = TrainingConfig(updater="adam", learning_rate=3e-4)
    upd = U.make_updater(t, None)
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(scale):
        return {v: {k: scale * torch.randn(s, generator=gen, device=device)
                    for k, s in d.items()} for v, d in shapes.items()}

    params = draw(0.02)
    state = upd.init(params)
    launches = fa.FUSED_ADAM.launches
    for it in range(steps):
        grads = draw(1e-3)
        if kernel:
            _, state = U.update_in_place(upd, params, grads, state, it,
                                         model="card")
        else:
            d, state = upd.update(grads, state, it)
            U.apply_updates(params, d)
    torch.cuda.synchronize()
    return params, state, fa.FUSED_ADAM.launches - launches


@pytest.mark.cuda
def test_card_kernel_equals_the_plain_path_at_opt125m():
    device = _card()
    shapes = opt125m_shapes()
    n = sum(len(d) for d in shapes.values())
    assert n == 137
    assert sum(math.prod(s) for d in shapes.values()
               for s in d.values()) == 162_296_416
    kp, ks, launches = _card_run(shapes, device, kernel=True)
    assert launches == STEPS
    pp, ps, none = _card_run(shapes, device, kernel=False)
    assert none == 0
    assert _bitwise(kp, pp)
    assert _bitwise(ks["m"], ps["m"]) and _bitwise(ks["v"], ps["v"])
    again = _card_run(shapes, device, kernel=True)
    assert _bitwise(kp, again[0])
    assert _bitwise(ks["m"], again[1]["m"]) and _bitwise(ks["v"],
                                                         again[1]["v"])


@pytest.mark.cuda
def test_card_odd_lengths_and_unaligned_leaves():
    """Leaves whose length is no multiple of 4 and leaves that start off a
    16-byte boundary (the scalar path), with deltas written: bitwise the
    plain path's."""
    device = _card()
    t = TrainingConfig(updater="adam", learning_rate=1e-2)
    upd = U.make_updater(t, MULTS)
    p1 = _tree(SHAPES, torch.Generator().manual_seed(1), device)
    # a contiguous view 4 bytes past its allocation's 16-byte boundary
    p1["c"]["W"] = torch.randn(2 * fa.CHUNK + 14, device=device)[1:]
    p2 = _clone(p1)
    s1, s2 = upd.init(p1), upd.init(p2)
    for it in range(5):
        grads = _tree(SHAPES, torch.Generator().manual_seed(100 + it),
                      device)
        d1, s1 = upd.update(grads, s1, it)
        U.apply_updates(p1, d1)
        d2, s2 = U.update_in_place(upd, p2, grads, s2, it,
                                   want_deltas=True, model="card")
        assert _bitwise(d1, d2)
    assert _bitwise(p1, p2)
    assert _bitwise(s1["m"], s2["m"]) and _bitwise(s1["v"], s2["v"])


@pytest.mark.cuda
def test_card_division_by_a_scalar_is_the_reciprocal_product():
    """ATen divides a card tensor by a Python scalar as a product with its
    f32 reciprocal, so the plain path's explicit reciprocal (and the
    kernel's) computes on the card what ``m / bc1`` did."""
    device = _card()
    m = torch.randn(1 << 20, device=device)
    for it in (0, 3, 999):
        s = fa.Scalars.at(0.9, 0.999, 1e-8, it)
        tstep = np.float32(it) + np.float32(1)
        bc1 = float(np.float32(1) - np.power(np.float32(0.9), tstep))
        assert torch.equal(m / bc1, m * s.ibc1)


def _net(device, seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_in=12, n_out=30, activation="tanh"))
            .layer(DenseLayer(n_in=30, n_out=17, activation="relu"))
            .layer(OutputLayer(n_in=17, n_out=5, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _batch(i):
    rng = np.random.default_rng(i)
    x = rng.normal(size=(32, 12)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, 32)]


@pytest.mark.cuda
def test_card_replaced_state_is_picked_up():
    """A net whose ``updater_state`` (and parameters) are replaced by
    clones of an earlier step's, as a checkpoint restore does, trains on
    from those: bitwise what the uninterrupted net did from the same
    point."""
    device = _card()
    a = _net(device)
    for i in range(3):
        a.fit_batch(*_batch(i))
    params = {v: {k: x.detach().clone() for k, x in d.items()}
              for v, d in a.params.items()}
    state = {s: {v: {k: x.clone() for k, x in d.items()}
                 for v, d in tree.items()}
             for s, tree in a.updater_state.items()}
    for i in range(3, 6):
        a.fit_batch(*_batch(i))
    b = _net(device, seed=6)
    b.fit_batch(*_batch(0))                 # its own state, then replaced
    b.set_params(params)
    b.updater_state = state
    b._update_count = 3
    for i in range(3, 6):
        b.fit_batch(*_batch(i))
    assert _bitwise(a.params, b.params)
    for slot in ("m", "v"):
        assert _bitwise(a.updater_state[slot], b.updater_state[slot])


@pytest.mark.cuda
def test_card_stats_step_equals_plain_step():
    """With health stats on, the kernel also writes the deltas the stats
    read; parameters and state stay bitwise the stats-off run's."""
    device = _card()
    off, on = _net(device), _net(device)
    on.enable_health_stats()
    launches = fa.FUSED_ADAM.launches
    for i in range(4):
        off.fit_batch(*_batch(i))
        on.fit_batch(*_batch(i))
    assert fa.FUSED_ADAM.launches - launches == 8
    assert _bitwise(off.params, on.params)
    for slot in ("m", "v"):
        assert _bitwise(off.updater_state[slot], on.updater_state[slot])
    from deeplearning4j_tpu_torch.util import health
    assert health.latest_stats(on) is not None
