"""The port's full-batch solvers (``optimize/solvers.py``) on the CPU: the
cases of ``tests/test_solvers.py``, and the port's trajectories against
the reference's in f64 from the same checkpoint (final score and
parameters within 1e-9 relative: the same line-search decisions, the
sums in another order) and on an ill-conditioned quadratic (iterates
within 1e-9).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.solvers import (BackTrackLineSearch,
                                                       Solver)

F64 = 1e-9
ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]


def _net(algo):
    conf = (NeuralNetConfiguration.builder().seed(3)
            .optimization_algo(algo).updater("sgd").learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_out=10, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(rng, n=48, dtype=np.float32):
    x = rng.normal(size=(n, 5)).astype(dtype)
    w = rng.normal(size=(5, 3))
    y = np.eye(3, dtype=dtype)[np.argmax(x @ w, axis=1)]
    return x, y


class TestSolvers:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_full_batch_solvers_reduce_loss(self, rng, algo):
        x, y = _data(rng)
        net = _net(algo)
        s0 = net.score_for(x, y)
        score = Solver(net).optimize(x, y, iterations=30)
        assert score < s0 * 0.5, f"{algo}: {s0} -> {score}"
        assert net.score_for(x, y) == pytest.approx(score, rel=1e-4)

    def test_lbfgs_beats_plain_gd_on_illconditioned(self):
        scales = torch.tensor(np.geomspace(1.0, 1e3, 20), dtype=torch.float32)

        def f(v):
            return 0.5 * torch.sum(scales * v * v)

        def g(v):
            return scales * v
        x0 = torch.ones(20)
        solver = Solver.__new__(Solver)
        solver.memory = 10
        solver.line_search = BackTrackLineSearch(max_iterations=10)
        _, f_lbfgs = solver._lbfgs(x0, f, g, 40, 1e-12)
        _, f_gd = solver._line_gd(x0, f, g, 40, 1e-12)
        assert f_lbfgs < f_gd * 0.1

    def test_sgd_algo_delegates_to_fit(self, rng):
        x, y = _data(rng)
        net = _net("sgd")
        score = Solver(net).optimize(x, y, iterations=20)
        assert net.iteration_count == 20
        assert np.isfinite(float(score))

    def test_backtrack_line_search_finds_decrease(self):
        x = torch.tensor([2.0, -3.0])
        g = 2 * x
        f = lambda v: torch.sum(v * v)
        step, val = BackTrackLineSearch().search(f, x, float(f(x)), g, -g)
        assert val < float(f(x))
        assert step > 0


@pytest.mark.parametrize("algo", ALGOS)
def test_trajectory_matches_reference_in_f64(tmp_path, rng, algo):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JD,
                                                   OutputLayer as JO)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
    from deeplearning4j_tpu.optimize.solvers import Solver as JSolver
    from deeplearning4j_tpu.util.serialization import save_model as j_save
    from deeplearning4j_tpu_torch.util.serialization import load_model
    conf = (JNNC.builder().seed(3).optimization_algo(algo).updater("sgd")
            .learning_rate(0.1).dtype("float64").list()
            .layer(JD(n_out=10, activation="tanh"))
            .layer(JO(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(5)).build())
    jnet = JM(conf).init()
    j_save(jnet, str(tmp_path / "s.zip"))
    tnet = load_model(str(tmp_path / "s.zip"), device="cpu")
    x, y = _data(rng, dtype=np.float64)
    for iters in (3, 12):
        js = JSolver(jnet).optimize(x, y, iterations=iters)
        ts = Solver(tnet).optimize(x, y, iterations=iters)
        assert ts == pytest.approx(js, rel=F64)
        for v, ps in jnet.params.items():
            for k, a in ps.items():
                want = np.asarray(a)
                got = tnet.params[v][k].detach().numpy()
                assert got.dtype == np.float64
                assert np.abs(got - want).max() <= F64 * np.abs(want).max()


def test_lbfgs_and_cg_iterates_match_reference_on_a_quadratic():
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.optimize.solvers import (BackTrackLineSearch as
                                                     JLS, Solver as JSolver)
    s = np.geomspace(1.0, 1e2, 12)

    def run(lib, solver_cls, ls_cls, method):
        solver = solver_cls.__new__(solver_cls)
        solver.memory = 5
        solver.line_search = ls_cls(max_iterations=10)
        if lib == "jax":
            sc = jnp.asarray(s)
            f = lambda v: 0.5 * jnp.sum(sc * v * v)
            x, fx = getattr(solver, method)(jnp.ones(12, jnp.float64), f,
                                            jax.grad(f), 25, 1e-14)
        else:
            sc = torch.tensor(s)
            f = lambda v: 0.5 * torch.sum(sc * v * v)
            x, fx = getattr(solver, method)(torch.ones(12, dtype=torch.float64),
                                            f, lambda v: sc * v, 25, 1e-14)
        return np.asarray(x), fx

    for method in ("_lbfgs", "_cg", "_line_gd"):
        jx, jf = run("jax", JSolver, JLS, method)
        tx, tf = run("torch", Solver, BackTrackLineSearch, method)
        np.testing.assert_allclose(tx, jx, rtol=F64, atol=F64)
        assert tf == pytest.approx(jf, rel=F64, abs=1e-20)
