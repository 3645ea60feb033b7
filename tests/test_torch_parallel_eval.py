"""Mesh-sharded evaluation of the port (``ShardedEvaluator``,
``evaluate_sharded``) and the early-stopping score calculators' ``mesh=``
option, against the JAX package's on a 4-device mesh.

The held-out data are 3 batches of 10, 7 and 4 rows — none divisible by
4, so every batch is padded to the mesh and the pads are masked out.
The port's side runs over a gloo group of 4 ranks, child processes of
this file (``python tests/test_torch_parallel_eval.py --child RANK WORLD
DIR``); each rank must end with the same global result. Confusion counts
must be equal; outputs and scores within 1e-6 (f32 forward of the same
weights, relative).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 4
TOL = 1e-6
SIZES = (10, 7, 4)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(8, 3))
    out = []
    for n in SIZES:
        x = rng.normal(size=(n, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ w + rng.normal(
            scale=2.0, size=(n, 3)), axis=1)]
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.earlystopping.scorecalc import (
        DataSetLossCalculator, EvaluationScoreCalculator)
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.parallel import data_parallel_mesh
    from deeplearning4j_tpu.parallel.evaluation import (ShardedEvaluator,
                                                        evaluate_sharded)
    from deeplearning4j_tpu.util.serialization import save_model
    out_dir = tmp_path_factory.mktemp("parallel_eval")
    conf = (NeuralNetConfiguration.builder().seed(11).updater("sgd")
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    jnet = MultiLayerNetwork(conf).init()
    save_model(jnet, str(out_dir / "net.zip"))
    mesh = data_parallel_mesh(WORLD)
    batches = _batches()
    dsets = [JDataSet(x, y) for x, y in batches]
    ev = ShardedEvaluator(jnet, mesh)
    ref = {
        "output": np.asarray(ev.output(batches[0][0])),
        "confusion": ev.evaluate(dsets).confusion.matrix,
        "helper_confusion": evaluate_sharded(jnet, dsets,
                                             mesh=mesh).confusion.matrix,
        "score": ev.score(dsets),
        "loss_calc": DataSetLossCalculator(dsets, mesh=mesh)
        .calculate_score(jnet),
        "eval_calc": EvaluationScoreCalculator(dsets, mesh=mesh)
        .calculate_score(jnet),
    }
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         str(WORLD), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    port = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_output_matches_reference(runs, rank):
    ref, port = runs
    assert port[rank]["output"].shape == ref["output"].shape
    assert _rel(port[rank]["output"], ref["output"]) <= TOL


@pytest.mark.parametrize("key", ["confusion", "helper_confusion"])
def test_confusion_counts_equal_on_every_rank(runs, key):
    ref, port = runs
    for res in port:
        np.testing.assert_array_equal(res[key], ref[key])
    assert int(ref[key].sum()) == sum(SIZES)


@pytest.mark.parametrize("key", ["score", "loss_calc", "eval_calc"])
def test_scores_match_reference(runs, key):
    ref, port = runs
    for res in port:
        assert _rel(res[key], ref[key]) <= TOL


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
        DataSetLossCalculator, EvaluationScoreCalculator)
    from deeplearning4j_tpu_torch.parallel import (data_parallel_mesh,
                                                   initialize)
    from deeplearning4j_tpu_torch.parallel.evaluation import (
        ShardedEvaluator, evaluate_sharded)
    from deeplearning4j_tpu_torch.util.serialization import load_model
    torch.set_num_threads(1)
    initialize(f"file://{out_dir}/rdv", num_processes=world,
               process_id=rank, device="cpu")
    net = load_model(os.path.join(out_dir, "net.zip"), device="cpu")
    mesh = data_parallel_mesh(device_type="cpu")
    batches = _batches()
    dsets = [DataSet(x, y) for x, y in batches]
    ev = ShardedEvaluator(net, mesh)
    res = {
        "output": ev.output(batches[0][0]),
        "confusion": ev.evaluate(dsets).confusion.matrix,
        "helper_confusion": evaluate_sharded(net, dsets,
                                             mesh=mesh).confusion.matrix,
        "score": ev.score(dsets),
        "loss_calc": DataSetLossCalculator(dsets, mesh=mesh)
        .calculate_score(net),
        "eval_calc": EvaluationScoreCalculator(dsets, mesh=mesh)
        .calculate_score(net),
    }
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
