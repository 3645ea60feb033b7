"""The port's multi-process bootstrap (``parallel/distributed.py``) and
meshes (``parallel/mesh.py``).

``initialize`` forms a gloo group of 2 ranks from the environment
(``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost port, ``WORLD_SIZE``,
``RANK``); the ranks are child processes of this file (``python
tests/test_torch_distributed.py --child RANK WORLD DIR``) and report
``global_mesh``, the batch feeding helpers and the default digest
agreement back through an npz. ``agree_on_digest`` with an injected
``allgather`` is held against the JAX package's in this process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 2


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("distributed")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD))
    procs = []
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(r),
             str(WORLD), str(out_dir)], env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
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
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


def test_initialize_from_env_forms_the_group(ranks):
    for r, res in enumerate(ranks):
        assert int(res["process_count"]) == WORLD
        assert int(res["process_index"]) == r
        assert bool(res["is_initialized"])
        assert str(res["backend"]) == "gloo"


def test_global_mesh_default_and_2d(ranks):
    for r, res in enumerate(ranks):
        assert res["mesh_names"].tolist() == ["data"]
        assert res["mesh_shape"].tolist() == [WORLD]
        # the first dim varies slowest across processes
        assert res["mesh2d"].tolist() == [[0, 1]]
        assert int(res["coord_model"]) == r


def test_host_local_batch_concatenates_the_ranks_shards(ranks):
    want = np.concatenate([np.full((2, 3), r, np.float32)
                           for r in range(WORLD)])
    for res in ranks:
        np.testing.assert_array_equal(res["local_batch"], want)


def test_host_replicated_batch_keeps_the_array(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["replicated"],
                                      np.arange(6.0).reshape(2, 3))


def test_default_digest_agreement_over_the_group(ranks):
    for res in ranks:
        assert bool(res["agree_same"])
        assert not bool(res["agree_diff"])


def test_mesh_needs_as_many_ranks_as_devices(ranks):
    for res in ranks:
        assert "devices" in str(res["too_many"])


@pytest.mark.parametrize("rows", [[1, 1, 1], [1, 2, 1]])
def test_agree_on_digest_with_injected_allgather(rows):
    """The commit gate on a store-backed gather (no process group): the
    port's answer equals the JAX package's for the same gathered rows."""
    from deeplearning4j_tpu.parallel.distributed import \
        agree_on_digest as j_agree
    from deeplearning4j_tpu_torch.parallel.distributed import agree_on_digest
    digests = {1: "ab" * 32, 2: "cd" * 32}
    mine = digests[rows[0]]

    def allgather(local):
        assert local.dtype == np.uint8 and local.size == 32
        return np.stack([np.frombuffer(bytes.fromhex(digests[r]), np.uint8)
                         for r in rows])
    assert agree_on_digest(mine, allgather=allgather) == \
        j_agree(mine, allgather=allgather) == (len(set(rows)) == 1)


def test_exports_equal_the_reference():
    import deeplearning4j_tpu.parallel as jpar
    import deeplearning4j_tpu_torch.parallel as tpar
    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, name) for name in tpar.__all__)


def test_single_process_is_a_no_op():
    from deeplearning4j_tpu_torch.parallel import distributed
    if "MASTER_ADDR" in os.environ:
        pytest.skip("a launcher set MASTER_ADDR")
    distributed.initialize(num_processes=1, device="cpu")
    assert not distributed.is_initialized()
    if distributed.process_count() == 1:
        assert distributed.agree_on_digest("ab" * 32)


def test_host_values_cross_an_nccl_group_on_the_card(monkeypatch):
    """NCCL takes no CPU tensor: a host count crossing an NCCL group is
    built on this process's card, one crossing a gloo group on the CPU."""
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    backend = {"g": "nccl"}
    monkeypatch.setattr(coll.dist, "get_backend", lambda g: backend[g])
    monkeypatch.setattr(coll.torch.cuda, "current_device", lambda: 3)
    assert coll.group_device(["g"]) == torch.device("cuda", 3)
    backend["g"] = "gloo"
    assert coll.group_device(["g"]) == torch.device("cpu")


def test_global_count_builds_a_host_count_on_the_groups_device(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    seen = []

    def reduce_(x, groups):
        seen.append((x.device, x.dtype, groups))
        return torch.tensor(6.0, dtype=torch.float64)
    monkeypatch.setattr(coll, "group_size", lambda g: 2)
    monkeypatch.setattr(coll, "group_device",
                        lambda groups: torch.device("meta"))
    monkeypatch.setattr(coll, "_all_reduce_", reduce_)
    with coll.batch_split(["g"]):
        assert coll.global_count(3, examples_only=True) == 6.0
    assert seen == [(torch.device("meta"), torch.float64, ("g",))]


def test_split_contexts_hold_in_their_thread_only(monkeypatch):
    """A sharded step's contexts do not reach another thread's forward
    (an in-process server, elastic hosts on threads)."""
    import threading
    from deeplearning4j_tpu_torch.ops import attention as tattn
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    monkeypatch.setattr(coll, "group_size", lambda g: 2)
    seen = {}

    def other():
        seen["other"] = (coll.active_batch_groups(),
                         coll.active_expert_group(),
                         tattn.active_sequence_sharding())
    with coll.batch_split(["g"], time_groups=["t"]), \
            coll.expert_split("e"), tattn.sequence_sharding("mesh", "seq"):
        seen["own"] = (coll.active_batch_groups(), coll.active_expert_group(),
                       tattn.active_sequence_sharding())
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert seen["own"] == (("g", "t"), "e", ("mesh", "seq", None))
    assert seen["other"] == ((), None, None)
    assert (coll.active_batch_groups(), coll.active_expert_group(),
            tattn.active_sequence_sharding()) == ((), None, None)


def test_checkpointed_recompute_runs_under_the_forward_context(monkeypatch):
    """The backward's recompute of a checkpointed segment, run from a
    thread outside the step's context, sees the context of the forward."""
    import threading
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    from deeplearning4j_tpu_torch.util.netutil import checkpoint_segment
    monkeypatch.setattr(coll, "group_size", lambda g: 2)
    seen = []

    def segment(x):
        seen.append(coll.active_batch_groups())
        return x * x
    x = torch.ones(3, requires_grad=True)
    with coll.batch_split(["g"]):
        y = checkpoint_segment(segment, None, x)
    th = threading.Thread(target=lambda: y.sum().backward())
    th.start()
    th.join()
    assert seen == [("g",), ("g",)]
    torch.testing.assert_close(x.grad, torch.full((3,), 2.0))


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (
        create_mesh, data_parallel_mesh, distributed, global_mesh,
        host_local_batch, host_replicated_batch, initialize, mesh)
    from deeplearning4j_tpu_torch.util.durable import params_digest
    torch.set_num_threads(1)
    initialize(device="cpu")
    res = {"process_count": distributed.process_count(),
           "process_index": distributed.process_index(),
           "is_initialized": distributed.is_initialized(),
           "backend": dist.get_backend()}
    gm = global_mesh()
    res["mesh_names"] = np.asarray(list(mesh.axis_names(gm)))
    res["mesh_shape"] = np.asarray(gm.mesh.shape)
    gm2 = global_mesh({"data": 1, "model": world})
    res["mesh2d"] = gm2.mesh.numpy()
    res["coord_model"] = mesh.axis_rank(gm2, "model")
    dp = data_parallel_mesh(device_type="cpu")
    res["local_batch"] = host_local_batch(
        dp, np.full((2, 3), rank, np.float32)).numpy()
    res["replicated"] = host_replicated_batch(
        dp, np.arange(6.0).reshape(2, 3)).numpy()
    same = params_digest({"a": {"w": torch.ones(3)}})
    diff = params_digest({"a": {"w": torch.full((3,), float(rank))}})
    res["agree_same"] = distributed.agree_on_digest(same)
    res["agree_diff"] = distributed.agree_on_digest(diff)
    try:
        create_mesh({"data": world + 1}, device_type="cpu")
        res["too_many"] = "no error"
    except ValueError as e:
        res["too_many"] = str(e)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    dist.barrier()
    distributed.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
