"""The port's data-parallel embedding step (``nlp.learning.
make_sharded_ns_step``) and ``Word2Vec`` on a mesh, over gloo.

The port's ranks are child processes of this file (``python
tests/test_torch_nlp_parallel.py --child RANK WORLD DIR``, started once per
world size, 2 and 4; they import no JAX). Every rank is handed the same
GLOBAL batch and keeps its block. The parent holds rank 0's results:

- two sharded steps (skip-gram and CBOW, a batch with heavy row
  collisions) against the port's single-process ``ns_step`` and the JAX
  package's sharded step on a CPU mesh of the same size, within
  ``STEP_ATOL`` (tables) and ``STEP_RTOL`` (losses);
- a seeded ``Word2Vec`` fit with ``mesh=`` (tail batches cut to a multiple
  of the mesh, the tail smaller than it skipped) against the JAX package's
  on its mesh, within ``FIT_ATOL``;
- every rank ends with the same tables, bitwise; a batch that does not
  divide by the mesh raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

STEP_ATOL = 1e-6
STEP_RTOL = 1e-6
FIT_ATOL = 1e-5
WORLDS = (2, 4)
V, D, B, K, W = 300, 16, 1024, 5, 4
LRS = (0.025, 0.0125)
CORPUS = ["the quick brown fox jumps over the lazy dog",
          "the quick red fox leaps over the sleepy cat"] * 40
W2V = dict(layer_size=16, window=2, negative=3, epochs=2, batch_size=66,
           seed=7)


def inputs(seed=0):
    """Tables away from their zero start and a batch whose 1024 rows hit
    20 centers and 60 target/negative/context rows."""
    rng = np.random.default_rng(seed)
    return {"syn0": (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
            "syn1neg": (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
            "center": rng.integers(0, 20, B).astype(np.int32),
            "target": rng.integers(0, 60, B).astype(np.int32),
            "negs": rng.integers(0, 60, (B, K)).astype(np.int32),
            "ctx": rng.integers(0, 60, (B, W)).astype(np.int32),
            "ctx_mask": (rng.random((B, W)) < 0.7).astype(np.float32)}


BATCH = ("center", "target", "negs", "ctx", "ctx_mask")


def _spawn(world, out_dir, timeout=300):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         str(world), out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    return procs


def _collect(procs, out_dir, timeout=300):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (rank 0's npz entries, the reference's results)}; both worlds'
    ranks run at once while the parent computes the reference's."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.nlp import Word2Vec, learning
    from deeplearning4j_tpu.parallel import data_parallel_mesh
    dirs = {w: str(tmp_path_factory.mktemp(f"nlp{w}")) for w in WORLDS}
    for d in dirs.values():
        np.savez(os.path.join(d, "inputs.npz"), **inputs())
    procs = {w: _spawn(w, dirs[w]) for w in WORLDS}
    x = inputs()
    ref = {}
    for w in WORLDS:
        mesh = data_parallel_mesh(w)
        out = {}
        for cbow in (False, True):
            step = learning.make_sharded_ns_step(mesh, cbow=cbow)
            p = {k: jnp.asarray(x[k]) for k in ("syn0", "syn1neg")}
            losses = []
            for lr in LRS:
                p, loss = step(p, *(jnp.asarray(x[n]) for n in BATCH),
                               jnp.float32(lr))
                losses.append(float(loss))
            out[cbow] = ({k: np.asarray(v) for k, v in p.items()}, losses)
        w2v = Word2Vec(CORPUS, mesh=mesh, **W2V)
        w2v.fit(CORPUS)
        ref[w] = (out, w2v)
    return {w: (_collect(procs[w], dirs[w]), ref[w]) for w in WORLDS}


def single_process(cbow):
    """The port's single-process ns_step from the same tables and batch."""
    from deeplearning4j_tpu_torch.nlp import learning
    x = inputs()
    p = learning.params_from_numpy(
        {k: x[k] for k in ("syn0", "syn1neg")}, "cpu")
    losses = []
    for lr in LRS:
        p, loss = learning.ns_step(
            p, *learning.to_device([x[n] for n in BATCH], "cpu"), lr,
            cbow=cbow)
        losses.append(float(loss))
    return {k: v.numpy() for k, v in p.items()}, losses


@pytest.mark.parametrize("cbow", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_the_single_process_step(runs, world, cbow):
    port, (ref, _) = runs[world]
    tag = "cbow" if cbow else "sg"
    single, single_losses = single_process(cbow)
    ref_params, ref_losses = ref[cbow]
    for want in (single, ref_params):
        for k in ("syn0", "syn1neg"):
            err = np.abs(port[f"{tag}/{k}"] - want[k]).max()
            assert err <= STEP_ATOL, (k, err)
    for want in (single_losses, ref_losses):
        want = np.asarray(want, np.float64)
        assert np.all(np.abs(port[f"{tag}/losses"] - want)
                      <= STEP_RTOL * np.abs(want))
    moved = np.abs(port[f"{tag}/syn0"] - inputs()["syn0"]).max()
    assert moved > 100 * STEP_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_word2vec_on_a_mesh_matches_the_references(runs, world):
    port, (_, j_w2v) = runs[world]
    assert list(port["w2v/words"]) == j_w2v.vocab.words()
    assert np.abs(port["w2v/syn0"] - np.asarray(j_w2v._syn0())).max() \
        <= FIT_ATOL
    assert abs(float(port["w2v/sim"]) - j_w2v.similarity("quick", "lazy")) \
        <= FIT_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_tables(runs, world):
    port, _ = runs[world]
    assert bool(port["ranks_agree"])
    assert "not divisible" in str(port["indivisible_error"])


# ----------------------------------------------------------------------
# the port's side: one gloo rank
# ----------------------------------------------------------------------


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nlp import Word2Vec, learning
    from deeplearning4j_tpu_torch.parallel import create_mesh, initialize
    torch.set_num_threads(1)
    initialize(f"file://{out_dir}/rdv", num_processes=world,
               process_id=rank, device="cpu")
    mesh = create_mesh({"data": world}, device_type="cpu")
    x = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    batch = learning.to_device([x[n] for n in BATCH], "cpu")
    results, mine = {}, {}
    for cbow, tag in ((False, "sg"), (True, "cbow")):
        step = learning.make_sharded_ns_step(mesh, cbow=cbow)
        p = learning.params_from_numpy(
            {k: x[k] for k in ("syn0", "syn1neg")}, "cpu")
        losses = []
        for lr in LRS:
            p, loss = step(p, *batch, lr)
            losses.append(float(loss))
        results[f"{tag}/losses"] = np.asarray(losses)
        for k, v in p.items():
            results[f"{tag}/{k}"] = mine[f"{tag}/{k}"] = v.numpy()
    w2v = Word2Vec(CORPUS, mesh=mesh, device="cpu", **W2V)
    w2v.fit(CORPUS)
    results["w2v/syn0"] = mine["w2v"] = w2v._syn0()
    results["w2v/words"] = np.asarray(w2v.vocab.words())
    results["w2v/sim"] = np.asarray(w2v.similarity("quick", "lazy"))
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    results["ranks_agree"] = np.asarray(all(
        all(np.array_equal(g[k], mine[k]) for k in mine) for g in gathered))
    try:
        step(p, *(t[:B - 1] for t in batch), 0.025)
        results["indivisible_error"] = np.asarray("no error")
    except ValueError as e:
        results["indivisible_error"] = np.asarray(str(e))
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
