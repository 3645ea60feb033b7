"""One DSL transformer, four parallelism modes (counterpart of the JAX
package's ``examples/parallel_transformer.py``).

The same ``models.transformer.transformer_lm`` ComputationGraph trains:
  1. sequence-parallel   — time axis ring-sharded over `seq`
  2. pipeline-parallel   — blocks 1/S-sharded over `pp` (GPipe schedule)
  3. expert-parallel     — MoE variant, expert dims sharded over `ep`
  4. composed dp x seq   — 2-D mesh
One process per rank; start them with the ``torch.distributed``
environment, e.g. four CPU ranks on this host:

  MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=4 RANK=<r> \
  python -m deeplearning4j_tpu_torch.examples.parallel_transformer --smoke --device cpu
"""

import numpy as np

from deeplearning4j_tpu_torch.examples._cli import run


def batch(vocab, b, t, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, t + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def main(smoke: bool = False, device="cuda"):
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import (
        ExpertParallelGraphTrainer, GraphPipelineTrainer,
        SequenceParallelGraphTrainer, create_mesh, distributed)

    distributed.initialize(device=device)   # from the environment, if set
    n = distributed.process_count()
    if n < 2:
        print("need >1 process — start one per rank with WORLD_SIZE, RANK, "
              "MASTER_ADDR and MASTER_PORT set")
        return
    V, T, B = 11, 2 * n, 4
    steps = 3 if smoke else 30

    def tlm(**kw):
        return ComputationGraph(transformer_lm(
            V, d_model=16, n_heads=2, d_ff=32, updater="adam",
            learning_rate=1e-2, seed=7, **kw), device=device).init()

    device_type = tlm(n_layers=1).device.type
    x, y = batch(V, B, T)

    sp = SequenceParallelGraphTrainer(
        tlm(n_layers=2), create_mesh({"seq": n}, device_type=device_type))
    losses = [float(sp.fit_batch(x, y)) for _ in range(steps)]
    print(f"sequence-parallel ({n} ranks): {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")

    # every rank is a stage: an n-stage pipeline of an n-layer model (a mesh
    # over fewer ranks would leave processes outside it)
    pp = GraphPipelineTrainer(tlm(n_layers=n),
                              create_mesh({"pp": n}, device_type=device_type),
                              n_micro=2)
    losses = [float(pp.fit_batch(x, y)) for _ in range(steps)]
    print(f"pipeline-parallel ({n} stages): {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")

    if smoke:
        # tests/test_torch_dsl_parallel.py pins the same trainer against
        # the single-device oracle; the smoke skips it
        print("expert-parallel: skipped in --smoke "
              "(see tests/test_torch_dsl_parallel.py)")
    else:
        ep = ExpertParallelGraphTrainer(
            tlm(n_layers=2, moe_experts=2 * n),
            create_mesh({"ep": n}, device_type=device_type))
        losses = [float(ep.fit_batch(x, y)) for _ in range(steps)]
        print(f"expert-parallel ({2 * n} experts / {n} ranks): "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")

    if n % 2 == 0 and n >= 4:
        sp2 = SequenceParallelGraphTrainer(
            tlm(n_layers=2),
            create_mesh({"dp": 2, "seq": n // 2}, device_type=device_type),
            batch_axis="dp")
        losses = [float(sp2.fit_batch(x, y)) for _ in range(steps)]
        print(f"dp x seq 2-D mesh: {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    run(main, __doc__)
