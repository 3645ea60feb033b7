"""Long-context transformer LM: flash attention + sequence parallelism
(counterpart of the JAX package's ``examples/transformer_long_context.py``).

No DL4J analog (LSTM era): a causal transformer built from the config DSL
whose attention runs the hand-written flash kernels on the card where
the shape is eligible, plus the same model trained with the TIME axis
sharded over a mesh of processes (ring attention). The sequence-parallel
half needs more than one process; start one per rank with the
``torch.distributed`` environment:

  MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=<r> \
  python -m deeplearning4j_tpu_torch.examples.transformer_long_context --smoke --device cpu
"""
import numpy as np

from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph


def cyclic_batch(vocab, batch, t):
    ids = np.array([[(i + j) % vocab for i in range(t + 1)]
                    for j in range(batch)])
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]], ids


def main(smoke: bool = False, device="cuda"):
    from deeplearning4j_tpu_torch.parallel import (
        SequenceParallelGraphTrainer, create_mesh, distributed)
    distributed.initialize(device=device)   # from the environment, if set
    V = 8
    T, steps = (16, 12) if smoke else (4096, 200)
    net = ComputationGraph(transformer_lm(
        V, n_layers=2, d_model=32 if smoke else 256,
        n_heads=2 if smoke else 4, d_ff=64 if smoke else 1024,
        learning_rate=1e-2 if smoke else 3e-4), device=device).init()
    x, y, ids = cyclic_batch(V, 4, T)
    for step in range(steps):
        loss = net.fit_batch([x], [y])
        if step % 20 == 0:
            print(f"step {step}: loss {float(loss):.4f}")
    pred = net.output([x]).float().cpu().numpy().argmax(-1)
    acc = (pred[:, T // 2:] == ids[:, T // 2 + 1:]).mean()
    print(f"next-token accuracy (2nd half): {acc:.3f}")

    # the SAME DSL model trained with the time axis sharded over a mesh —
    # SelfAttentionLayer routes to ring attention (K/V rotate around the
    # ranks) under the trainer's sequence_sharding context
    n = distributed.process_count()
    if n == 1:
        print("sequence-parallel half skipped: 1 process (start one per "
              "rank with WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT set)")
    else:
        sp_net = ComputationGraph(transformer_lm(
            V, n_layers=2, d_model=16, n_heads=2, d_ff=32,
            updater="adam", learning_rate=1e-2), device=device).init()
        tr = SequenceParallelGraphTrainer(
            sp_net, create_mesh({"seq": n}, device_type=net.device.type))
        xs, ys, _ = cyclic_batch(V, 4, 8 * n)
        losses = [float(tr.fit_batch(xs, ys))
                  for _ in range(8 if smoke else 40)]
        print(f"sequence-parallel DSL transformer ({n} ranks): loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    run(main, __doc__)
