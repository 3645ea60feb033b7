"""Data-parallel training of the port against the JAX package's.

Each scenario starts the JAX package's net and the port's from the same
weights (the reference's checkpoint zip) and trains both on the same
numpy-seeded GLOBAL batches: the JAX package's ``ParallelWrapper`` (or
training master) on a 4-device mesh of the forced CPU devices, the port's
over a gloo process group of 4 ranks, each rank a child process of this
file (``python tests/test_torch_parallel.py --child RANK WORLD DIR``,
started once by a module fixture; the ranks import no JAX).

Scenarios:
- ``mln_sync_l2``: MLP, adam, l2 — sync mode; the penalty counted once;
- ``mln_local_k2``: local SGD, averaging every 2 steps, 5 steps (a
  partial window flushed by ``finish``);
- ``bn_sync``: BatchNormalization under sync mode — global batch moments
  and running statistics;
- ``graph_masked_sync``: a transformer LM with [b, t] masks that leave
  the ranks very different active-token counts — the loss denominator
  is the global one;
- ``master_sync`` / ``master_paramavg``: the training masters' trainers
  over ``fit`` on arrays.

Tolerance: ``STEP_TOL`` 1e-4 after the steps, relative to each leaf's
largest magnitude (the step parity of ``tests/test_torch_training.py``);
losses likewise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

STEP_TOL = 1e-4
WORLD = 4
SCENARIOS = ["mln_sync_l2", "mln_local_k2", "bn_sync", "graph_masked_sync",
             "master_sync", "master_paramavg"]
V, T, GB = 11, 8, 8


def _mlp_data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(8, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def _lm_data(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (GB, T + 1))
    eye = np.eye(V, dtype=np.float32)
    mask = np.ones((GB, T), np.float32)
    # rank 0's rows keep 1-2 tokens, rank 3's all of theirs
    mask[0, 1:] = 0.0
    mask[1, 2:] = 0.0
    mask[2, 5:] = 0.0
    mask[4, 6:] = 0.0
    return eye[ids[:, :-1]], eye[ids[:, 1:]], mask


# ----------------------------------------------------------------------
# the reference side
# ----------------------------------------------------------------------

def _jconfs():
    from deeplearning4j_tpu.models import transformer_lm
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import (BatchNormalization,
                                                   DenseLayer, OutputLayer)

    def mlp(updater, lr, l2=0.0, bn=False):
        b = (NeuralNetConfiguration.builder().seed(42).updater(updater)
             .learning_rate(lr))
        if l2:
            b = b.regularization(True).l2(l2)
        lb = b.list().layer(DenseLayer(n_out=16, activation="tanh"))
        if bn:
            lb = lb.layer(BatchNormalization())
        return (lb.layer(OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
                .set_input_type(InputType.feed_forward(8)).build())

    return {
        "mln_sync_l2": ("mln", mlp("adam", 1e-2, l2=1e-2)),
        "mln_local_k2": ("mln", mlp("sgd", 0.1)),
        "bn_sync": ("mln", mlp("sgd", 0.05, bn=True)),
        "graph_masked_sync": ("graph", transformer_lm(
            V, n_layers=2, d_model=16, n_heads=2, d_ff=32, updater="adam",
            learning_rate=1e-2, seed=5)),
        "master_sync": ("mln", mlp("adam", 1e-2)),
        "master_paramavg": ("mln", mlp("sgd", 0.1)),
    }


def _jrun(name, jnet, mesh):
    """Train the reference; returns the per-step losses."""
    from deeplearning4j_tpu.parallel import (
        ParallelWrapper, ParameterAveragingTrainingMaster,
        SyncTrainingMaster)
    x, y = _mlp_data()
    losses = []
    if name in ("mln_sync_l2", "bn_sync"):
        pw = ParallelWrapper(jnet, mesh=mesh)
        for _ in range(3):
            losses.append(float(pw.fit_batch(x, y)))
    elif name == "mln_local_k2":
        pw = ParallelWrapper(jnet, mesh=mesh, averaging_frequency=2)
        for _ in range(5):
            losses.append(float(pw.fit_batch(x, y)))
        pw.finish()
    elif name == "graph_masked_sync":
        gx, gy, gm = _lm_data()
        pw = ParallelWrapper(jnet, mesh=mesh)
        for _ in range(3):
            losses.append(float(pw.fit_batch([gx], [gy], [gm])))
    elif name == "master_sync":
        SyncTrainingMaster().build(jnet, mesh).fit(x, y, epochs=3)
        losses.append(float(jnet.score()))
    elif name == "master_paramavg":
        tr = ParameterAveragingTrainingMaster(averaging_frequency=2).build(
            jnet, mesh)
        tr.fit(x, y, epochs=3)
        losses.append(float(jnet.score()))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reference results in this process, the port's from the gloo ranks:
    {scenario: (reference (losses, params, state), port npz entries)}."""
    import jax
    from deeplearning4j_tpu.nn.graph_runtime import ComputationGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.parallel import data_parallel_mesh
    from deeplearning4j_tpu.util.serialization import save_model
    out_dir = tmp_path_factory.mktemp("parallel")
    mesh = data_parallel_mesh(WORLD)
    ref = {}
    for name, (kind, conf) in _jconfs().items():
        cls = MultiLayerNetwork if kind == "mln" else ComputationGraph
        jnet = cls(conf).init()
        save_model(jnet, str(out_dir / f"{name}.zip"))
        losses = _jrun(name, jnet, mesh)
        flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in p):
                             np.asarray(v) for p, v in
                             jax.tree_util.tree_flatten_with_path(tree)[0]}
        ref[name] = (losses, flat(jnet.params), flat(jnet.state))
    port = _spawn(WORLD, str(out_dir))
    return ref, port


def _spawn(world, out_dir, timeout=300):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         str(world), out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    return dict(np.load(os.path.join(out_dir, "rank0.npz")))


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_matches_reference(name, runs):
    ref, port = runs
    losses, params, state = ref[name]
    got_losses = port[f"{name}/losses"]
    assert len(got_losses) == len(losses)
    assert _rel_err(got_losses, losses) <= STEP_TOL
    for key, want in params.items():
        assert _rel_err(port[f"{name}/params/{key}"], want) <= STEP_TOL, key
    for key, want in state.items():
        assert _rel_err(port[f"{name}/state/{key}"], want) <= STEP_TOL, key


@pytest.mark.parametrize("name", SCENARIOS)
def test_every_rank_ends_with_the_same_parameters(name, runs):
    _, port = runs
    assert bool(port[f"{name}/ranks_agree"])


def test_nonfinite_steps_are_skipped_until_the_budget_runs_out(runs):
    _, port = runs
    assert bool(port["guard_unchanged"])
    assert "skipped for non-finite" in str(port["guard_error"])


def test_batch_not_divisible_by_the_mesh_raises(runs):
    _, port = runs
    assert "not divisible" in str(port["indivisible_error"])


# ----------------------------------------------------------------------
# the port's side: one gloo rank
# ----------------------------------------------------------------------

def _flat(tree):
    return {f"{v}/{k}": t.detach().float().cpu().numpy()
            for v, lp in tree.items() for k, t in lp.items()}


def _prun(name, net, mesh):
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, ParameterAveragingTrainingMaster,
        SyncTrainingMaster)
    x, y = _mlp_data()
    losses = []
    if name in ("mln_sync_l2", "bn_sync"):
        pw = ParallelWrapper(net, mesh=mesh)
        for _ in range(3):
            losses.append(float(pw.fit_batch(x, y)))
    elif name == "mln_local_k2":
        pw = ParallelWrapper(net, mesh=mesh, averaging_frequency=2)
        for _ in range(5):
            losses.append(float(pw.fit_batch(x, y)))
        pw.finish()
    elif name == "graph_masked_sync":
        gx, gy, gm = _lm_data()
        pw = ParallelWrapper(net, mesh=mesh)
        for _ in range(3):
            losses.append(float(pw.fit_batch([gx], [gy], [gm])))
    elif name == "master_sync":
        SyncTrainingMaster().build(net, mesh).fit(x, y, epochs=3)
        losses.append(float(net.score()))
    elif name == "master_paramavg":
        tr = ParameterAveragingTrainingMaster(averaging_frequency=2).build(
            net, mesh)
        tr.fit(x, y, epochs=3)
        losses.append(float(net.score()))
    return losses


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   create_mesh, initialize)
    from deeplearning4j_tpu_torch.util.serialization import load_model
    torch.set_num_threads(1)
    initialize(f"file://{out_dir}/rdv", num_processes=world,
               process_id=rank, device="cpu")
    mesh = create_mesh({"data": world}, device_type="cpu")
    results = {}
    for name in SCENARIOS:
        net = load_model(os.path.join(out_dir, f"{name}.zip"), device="cpu")
        results[f"{name}/losses"] = np.asarray(_prun(name, net, mesh))
        flat = _flat(net.params)
        for key, a in flat.items():
            results[f"{name}/params/{key}"] = a
        for key, a in _flat(net.state).items():
            results[f"{name}/state/{key}"] = a
        gathered = [None] * world
        dist.all_gather_object(gathered, flat)
        results[f"{name}/ranks_agree"] = np.asarray(all(
            all(np.array_equal(g[k], flat[k]) for k in flat)
            for g in gathered))
    # the non-finite budget: a poisoned batch is skipped on every rank
    # (parameters unchanged), the second one past the budget raises
    from deeplearning4j_tpu_torch.util.resilience import ResilienceError
    net = load_model(os.path.join(out_dir, "mln_sync_l2.zip"), device="cpu")
    before = _flat(net.params)
    x, y = _mlp_data()
    x[3, 2] = np.nan
    pw = ParallelWrapper(net, mesh=mesh, skip_nonfinite_budget=1)
    pw.fit_batch(x, y)
    results["guard_unchanged"] = np.asarray(all(
        np.array_equal(a, before[k]) for k, a in _flat(net.params).items()))
    try:
        pw.fit_batch(x, y)
        results["guard_error"] = np.asarray("no error")
    except ResilienceError as e:
        results["guard_error"] = np.asarray(str(e))
    net = load_model(os.path.join(out_dir, "mln_sync_l2.zip"), device="cpu")
    x, y = _mlp_data(n=6)
    try:
        ParallelWrapper(net, mesh=mesh).fit_batch(x, y)
        results["indivisible_error"] = np.asarray("no error")
    except ValueError as e:
        results["indivisible_error"] = np.asarray(str(e))
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
