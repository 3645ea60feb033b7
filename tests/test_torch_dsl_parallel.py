"""Sequence-, tensor-, pipeline- and expert-parallel training of DSL models:
the port against the JAX package.

The models are ``transformer_lm(V=11, n_layers=2, d_model=16, ...)`` and
its MoE variant (4 experts, top-2), plus an attention stack built with the
list DSL (a ``MultiLayerNetwork``). Each scenario starts both packages
from the same weights (the reference's checkpoint zip) and the same
numpy-seeded one-hot batch [8, 16], and takes 2 steps:

- tp, pp and ep (and dp × tp, dp × pp) against the JAX package's
  ``TensorParallelGraphTrainer`` / ``GraphPipelineTrainer`` /
  ``ExpertParallelGraphTrainer`` on meshes of the same shape;
- sp, dp × sp and sp × ep against the JAX package's single-device
  ``fit_batch`` (its ring does not run on this jax; ROADMAP §C), the ring
  on its plain route and, in ``sp2_flash``, on the flash route (the
  kernels' plain versions on the CPU);
- ``sp2`` and ``tp2`` also hold the sharded ``output()`` against the
  reference's forward, and ``sp_mln`` serves a MultiLayerNetwork;
- the standalone trainers from the reference's initial parameters: the
  block LM's ``SequenceParallelTrainer`` against its dense single-device
  step, ``PipelineParallelTrainer`` and ``ExpertParallelTrainer`` (each
  rank computing its 2 of 4 experts) against the JAX package's.

The port's side runs over gloo process groups of 2 and 4 ranks — child
processes of this file (``python tests/test_torch_dsl_parallel.py --child
RANK WORLD DIR``), started once per world size.

Tolerance: ``STEP_TOL`` 1e-4 on losses and parameters after the steps,
relative to the largest magnitude compared; outputs 1e-5 absolute (the
reference's own sp/tp output checks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

STEP_TOL = 1e-4
OUT_TOL = 1e-5
V, T, B = 11, 16, 8
STEPS = 2

# scenario: (world, checkpoint, oracle)
SCENARIOS = {
    "sp2": (2, "lm", "dense"),
    "sp2_masked": (2, "lm", "dense_masked"),
    "sp2_flash": (2, "lm", "dense"),
    "tp2": (2, "lm", "tp2"),
    "pp2": (2, "lm", "pp2"),
    "ep2": (2, "moe", "ep2"),
    "sp_mln": (2, "mln", "mln_dense"),
    "sp4": (4, "lm", "dense"),
    "dp_sp": (4, "lm", "dense"),
    "sp_ep": (4, "moe", "moe_dense"),
    "dp_tp": (4, "lm", "dp_tp"),
    "dp_pp": (4, "lm", "dp_pp"),
}
OUTPUT_SCENARIOS = ("sp2", "tp2", "sp_mln")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    mask = np.ones((B, T), np.float32)
    mask[:, T - 4:] = 0.0
    mask[0, 5:] = 0.0
    return eye[ids[:, :-1]], eye[ids[:, 1:]], mask


# ----------------------------------------------------------------------
# the reference side
# ----------------------------------------------------------------------

def _jconf(kind):
    from deeplearning4j_tpu.models import transformer_lm
    if kind == "lm":
        return transformer_lm(V, n_layers=2, d_model=16, n_heads=2, d_ff=32,
                              updater="sgd", learning_rate=0.05, seed=5)
    if kind == "moe":
        return transformer_lm(V, n_layers=2, d_model=16, n_heads=2, d_ff=32,
                              updater="sgd", learning_rate=0.05, seed=5,
                              moe_experts=4, moe_top_k=2)
    from deeplearning4j_tpu.nn.conf.attention import SelfAttentionLayer
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import (LayerNormalization,
                                                   RnnOutputLayer)
    return (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.05).list()
            .layer(LayerNormalization())
            .layer(SelfAttentionLayer(n_in=V, n_out=V, n_heads=1,
                                      causal=True))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V)).build())


def _jflat(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _joracle(name, path):
    """(losses, params, output-before-training) of one reference run."""
    from deeplearning4j_tpu.parallel import (ExpertParallelGraphTrainer,
                                             GraphPipelineTrainer,
                                             TensorParallelGraphTrainer,
                                             create_mesh)
    from deeplearning4j_tpu.util.serialization import load_model
    x, y, mask = _data()
    net = load_model(path)
    graph = hasattr(net, "topo_order")
    out0 = np.asarray(net.output([x] if graph else x))
    losses = []
    if name in ("dense", "dense_masked", "moe_dense", "mln_dense"):
        for _ in range(STEPS):
            if not graph:
                losses.append(float(net.fit_batch(x, y)))
            elif name == "dense_masked":
                losses.append(float(net.fit_batch([x], [y], [mask])))
            else:
                losses.append(float(net.fit_batch([x], [y])))
        return losses, _jflat(net.params), out0
    if name in ("tp2", "dp_tp"):
        mesh = create_mesh({"model": 2} if name == "tp2"
                           else {"data": 2, "model": 2})
        tr = TensorParallelGraphTrainer(net, mesh)
    elif name in ("pp2", "dp_pp"):
        mesh = create_mesh({"pp": 2} if name == "pp2"
                           else {"dp": 2, "pp": 2})
        tr = GraphPipelineTrainer(net, mesh,
                                  batch_axis=None if name == "pp2" else "dp")
    else:
        tr = ExpertParallelGraphTrainer(net, create_mesh({"ep": 2}))
    for _ in range(STEPS):
        losses.append(float(tr.fit_batch(x, y)))
    if name in ("pp2", "dp_pp"):
        tr.sync_to_net()
    return losses, _jflat(net.params), out0


def _jstandalone(out_dir):
    """The standalone trainers of the JAX package (the block LM's dense
    single-device step, its pipeline and expert trainers on 2-device
    meshes): their initial parameters go to ``standalone.npz`` for the
    port's ranks, their outputs and losses come back."""
    import jax
    from deeplearning4j_tpu import rng as jrng
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer
    from deeplearning4j_tpu.parallel import (ExpertParallelTrainer,
                                             PipelineParallelTrainer,
                                             create_mesh)
    from deeplearning4j_tpu.parallel.sequence import (dense_attention_fn,
                                                      init_block_params,
                                                      lm_loss)
    x, y, _ = _data()
    ff = np.random.default_rng(7).normal(size=(8, 8)).astype(np.float32)
    ffy = np.tanh(ff[:, ::-1]).copy()
    saved, ref = {}, {}
    # the block LM, dense attention, SGD at 0.1
    params = init_block_params(jrng.key(3), 8, 16, 2, V)
    saved.update({f"block/{k}": np.asarray(v) for k, v in params.items()})
    losses = []
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(lm_loss)(
            params, x, y, n_heads=2, attention_fn=dense_attention_fn)
        params = jax.tree_util.tree_map(lambda p, d: p - 0.1 * d, params, g)
        losses.append(float(loss))
    ref["block"] = (losses, {k: np.asarray(v) for k, v in params.items()})
    # the pipeline of two dense stages, M = 2
    pt = PipelineParallelTrainer(DenseLayer(n_in=8, n_out=8,
                                            activation="tanh"), 2,
                                 create_mesh({"pp": 2}), n_micro=2,
                                 learning_rate=0.05)
    saved.update({f"pp/{k}": np.asarray(v) for k, v in
                  jax.device_get(pt.params).items()})
    out0 = np.asarray(pt.forward(ff))
    losses = [float(pt.fit_batch(ff, ffy)) for _ in range(STEPS)]
    ref["pp"] = (losses, {k: np.asarray(v) for k, v in
                          jax.device_get(pt.params).items()}, out0)
    # the experts, 4 over ep = 2, top 2
    et = ExpertParallelTrainer(d_model=8, d_hidden=16, n_experts=4,
                               mesh=create_mesh({"ep": 2}), top_k=2,
                               learning_rate=0.1, seed=5)
    saved.update({f"ep/{k}": np.asarray(v) for k, v in
                  jax.device_get(et.params).items()})
    out0 = np.asarray(et.forward(ff))
    losses = [float(et.fit_batch(ff, ffy)) for _ in range(STEPS)]
    ref["ep"] = (losses, {k: np.asarray(v) for k, v in
                          jax.device_get(et.params).items()}, out0)
    np.savez(out_dir / "standalone.npz", ff=ff, ffy=ffy, **saved)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from deeplearning4j_tpu.nn.graph_runtime import ComputationGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.util.serialization import save_model
    out_dir = tmp_path_factory.mktemp("dsl_parallel")
    for kind in ("lm", "moe", "mln"):
        cls = MultiLayerNetwork if kind == "mln" else ComputationGraph
        save_model(cls(_jconf(kind)).init(), str(out_dir / f"{kind}.zip"))
    needed = {(o, ck) for _, ck, o in SCENARIOS.values()}
    ref = {o: _joracle(o, str(out_dir / f"{ck}.zip")) for o, ck in needed}
    ref["standalone"] = _jstandalone(out_dir)
    port = {}
    for world in (2, 4):
        port.update(_spawn(world, str(out_dir)))
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
    return dict(np.load(os.path.join(out_dir, f"world{world}.npz")))


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_trainer_matches_reference(name, runs):
    ref, port = runs
    losses, params, _ = ref[SCENARIOS[name][2]]
    assert _rel_err(port[f"{name}/losses"], losses) <= STEP_TOL
    for key, want in params.items():
        assert _rel_err(port[f"{name}/params/{key}"], want) <= STEP_TOL, key


@pytest.mark.parametrize("name", OUTPUT_SCENARIOS)
def test_sharded_output_matches_reference(name, runs):
    ref, port = runs
    want = ref[SCENARIOS[name][2]][2]
    got = port[f"{name}/output"]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= OUT_TOL


@pytest.mark.parametrize("name", ["block", "pp", "ep"])
def test_standalone_trainers_match_reference(name, runs):
    """The block LM's SequenceParallelTrainer (seq 2) against the dense
    single-device step; PipelineParallelTrainer (pp 2) and
    ExpertParallelTrainer (ep 2, each rank its 2 experts) against the
    JAX package's on meshes of the same shape, from its parameters."""
    ref, port = runs
    want = ref["standalone"][name]
    assert _rel_err(port[f"{name}/losses"], want[0]) <= STEP_TOL
    for key, w in want[1].items():
        assert _rel_err(port[f"{name}/params/{key}"], w) <= STEP_TOL, key
    if len(want) > 2:
        assert float(np.abs(port[f"{name}/output"] - want[2]).max()) \
            <= OUT_TOL


def test_updater_state_partitioned_over_the_dim(runs):
    """tp2: rank 0 holds half of the FFN kernel's columns of the updater
    state (momentum-free sgd keeps none, so the adam check builds one)."""
    _, port = runs
    assert port["tp_adam/slot_shape"].tolist() == [16, 16]
    assert port["tp_adam/param_shape"].tolist() == [16, 32]


def test_pipeline_stage_holds_only_its_blocks(runs):
    _, port = runs
    assert port["pp2/stage_vertices"].tolist() == ["blk0_ln1", "blk0_attn"][:2]


def test_unpipelineable_and_indivisible_graphs_raise(runs):
    _, port = runs
    assert "not divisible" in str(port["errors/indivisible_blocks"])
    assert "MoELayer" in str(port["errors/moe_pipeline"])
    assert "does not chunk" in str(port["errors/tbptt"])


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------

def _pflat(tree):
    return {f"{v}/{k}": t.detach().float().cpu().numpy()
            for v, lp in tree.items() for k, t in lp.items()}


def _prun(name, net, world):
    from deeplearning4j_tpu_torch.parallel import (
        ExpertParallelGraphTrainer, GraphPipelineTrainer,
        SequenceParallelGraphTrainer, TensorParallelGraphTrainer,
        create_mesh)
    x, y, mask = _data()
    res = {}
    if name in ("sp2", "sp2_masked", "sp2_flash", "sp_mln", "sp4"):
        tr = SequenceParallelGraphTrainer(
            net, create_mesh({"seq": world}, device_type="cpu"))
    elif name == "dp_sp":
        tr = SequenceParallelGraphTrainer(
            net, create_mesh({"dp": 2, "seq": 2}, device_type="cpu"),
            batch_axis="dp")
    elif name == "sp_ep":
        tr = SequenceParallelGraphTrainer(
            net, create_mesh({"seq": 2, "ep": 2}, device_type="cpu"),
            expert_axis="ep")
    elif name in ("tp2", "dp_tp"):
        tr = TensorParallelGraphTrainer(net, create_mesh(
            {"model": 2} if name == "tp2" else {"data": 2, "model": 2},
            device_type="cpu"))
    elif name in ("pp2", "dp_pp"):
        tr = GraphPipelineTrainer(
            net, create_mesh({"pp": 2} if name == "pp2"
                             else {"dp": 2, "pp": 2}, device_type="cpu"),
            batch_axis=None if name == "pp2" else "dp")
        res["stage_vertices"] = np.asarray(
            list(tr.params["stage"]["0"])[:2])
    else:
        tr = ExpertParallelGraphTrainer(
            net, create_mesh({"ep": 2}, device_type="cpu"))
    if name in OUTPUT_SCENARIOS:
        res["output"] = tr.output(x).detach().numpy()
    if name == "sp2_flash":
        os.environ["DL4JTPU_FLASH_ATTENTION"] = "1"
    losses = []
    for _ in range(STEPS):
        if name == "sp2_masked":
            losses.append(float(tr.fit_batch(x, y, masks=[mask])))
        else:
            losses.append(float(tr.fit_batch(x, y)))
    os.environ.pop("DL4JTPU_FLASH_ATTENTION", None)
    if name in ("pp2", "dp_pp"):
        tr.sync_to_net()
    res["losses"] = np.asarray(losses)
    for key, a in _pflat(net.params).items():
        res[f"params/{key}"] = a
    return res


def _pstandalone(out_dir, world):
    """The port's standalone trainers from the reference's parameters."""
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.parallel import (ExpertParallelTrainer,
                                                   PipelineParallelTrainer,
                                                   collectives, create_mesh)
    from deeplearning4j_tpu_torch.parallel.mesh import axis_rank
    from deeplearning4j_tpu_torch.parallel.sequence import \
        SequenceParallelTrainer
    data = np.load(os.path.join(out_dir, "standalone.npz"))
    x, y, _ = _data()
    ff, ffy = data["ff"], data["ffy"]
    res = {}

    def saved(prefix):
        # f32 (the reference's expert initialisation is f64 under x64)
        return {k[len(prefix) + 1:]: torch.from_numpy(
                    data[k].astype(np.float32))
                for k in data.files if k.startswith(prefix + "/")}
    sp = SequenceParallelTrainer(8, 16, 2, V, create_mesh(
        {"seq": world}, device_type="cpu"), learning_rate=0.1)
    sp.params = saved("block")
    res["block/losses"] = np.asarray([float(sp.fit_batch(x, y))
                                      for _ in range(STEPS)])
    res.update({f"block/params/{k}": v.numpy()
                for k, v in sp.params.items()})
    mesh = create_mesh({"pp": world}, device_type="cpu")
    pt = PipelineParallelTrainer(DenseLayer(n_in=8, n_out=8,
                                            activation="tanh"), 2, mesh,
                                 n_micro=2, learning_rate=0.05)
    stage = axis_rank(mesh, "pp")
    pt.params = {k: v[stage] for k, v in saved("pp").items()}
    res["pp/output"] = pt.forward(ff).numpy()
    res["pp/losses"] = np.asarray([float(pt.fit_batch(ff, ffy))
                                   for _ in range(STEPS)])
    for k, v in pt.params.items():      # every stage's block, stacked
        res[f"pp/params/{k}"] = collectives.all_gather_dim(
            v.detach()[None].contiguous(), mesh.get_group("pp"), 0).numpy()
    et = ExpertParallelTrainer(8, 16, 4, create_mesh({"ep": world},
                                                     device_type="cpu"),
                               top_k=2, learning_rate=0.1)
    et.params = et.shard(saved("ep"))
    res["ep/output"] = et.forward(ff).numpy()
    res["ep/losses"] = np.asarray([float(et.fit_batch(ff, ffy))
                                   for _ in range(STEPS)])
    group = et._group
    for k, v in et.params.items():
        res[f"ep/params/{k}"] = (v.detach().numpy() if k == "router" else
                                 collectives.all_gather_dim(
                                     v.detach().contiguous(), group,
                                     0).numpy())
    return res


def _errors(out_dir):
    """The refusals the JAX package's trainers make, as messages."""
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import (
        GraphPipelineTrainer, SequenceParallelGraphTrainer, create_mesh)
    from deeplearning4j_tpu_torch.util.serialization import load_model
    res = {}

    def msg(fn):
        try:
            fn()
            return "no error"
        except ValueError as e:
            return str(e)
    mesh3 = create_mesh({"pp": 2}, device_type="cpu")
    three = ComputationGraph(transformer_lm(V, n_layers=3, d_model=16,
                                            n_heads=2, d_ff=32),
                             device="cpu").init()
    res["indivisible_blocks"] = msg(lambda: GraphPipelineTrainer(three,
                                                                 mesh3))
    moe = load_model(os.path.join(out_dir, "moe.zip"), device="cpu")
    res["moe_pipeline"] = msg(lambda: GraphPipelineTrainer(moe, mesh3))
    tb = load_model(os.path.join(out_dir, "lm.zip"), device="cpu")
    tb.conf.backprop_type = "truncated_bptt"
    tb.conf.tbptt_fwd_length = 4
    x, y, _ = _data()
    sp = SequenceParallelGraphTrainer(tb, create_mesh({"seq": 2},
                                                      device_type="cpu"))
    res["tbptt"] = msg(lambda: sp.fit_batch(x, y))
    return res


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (TensorParallelGraphTrainer,
                                                   create_mesh, initialize)
    from deeplearning4j_tpu_torch.util.serialization import load_model
    torch.set_num_threads(1)
    initialize(f"file://{out_dir}/rdv{world}", num_processes=world,
               process_id=rank, device="cpu")
    results = {}
    for name, (w, ckpt, _) in SCENARIOS.items():
        if w != world:
            continue
        net = load_model(os.path.join(out_dir, f"{ckpt}.zip"), device="cpu")
        for key, a in _prun(name, net, world).items():
            results[f"{name}/{key}"] = a
    if world == 2:
        net = load_model(os.path.join(out_dir, "lm.zip"), device="cpu")
        net.conf.training.updater = "adam"
        net.init_updater()
        tr = TensorParallelGraphTrainer(net, create_mesh({"model": 2},
                                                         device_type="cpu"))
        slot = next(iter(tr.opt_state.values()))
        results["tp_adam/slot_shape"] = np.asarray(
            slot["blk0_ff1"]["W"].shape)
        results["tp_adam/param_shape"] = np.asarray(
            net.params["blk0_ff1"]["W"].shape)
        for key, m in _errors(out_dir).items():
            results[f"errors/{key}"] = np.asarray(m)
        results.update(_pstandalone(out_dir, world))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"world{world}.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
