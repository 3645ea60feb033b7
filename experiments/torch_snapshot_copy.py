"""What copying a snapshot to the host costs the training thread, on the card.

    python3 experiments/torch_snapshot_copy.py [--steps 16] [--at 4]

Builds the kernels (chip_smoke.phase_build) and the flagship transformer
LM at full width and depth (mixed bf16, adam), and trains it with ``fit``
over ``--steps`` copies of one [8, 2048] batch of ids, a listener
recording the host time of every step. After step ``--at`` the listener
takes ``util.durable.TrainingState.capture`` (device clones of the masters,
the adam moments and the layer state, ≈ 1.6 GB) and a second thread
copies the clones to the host, as the snapshot writer does. Ways to copy,
in turns (none, pageable, pinned, pinned, pageable, none):

- ``none``: the capture alone, nothing copied;
- ``pageable``: each clone by ``Tensor.to("cpu")`` on a stream of the
  thread's own (pageable host memory straight from the device);
- ``pinned``: ``TrainingState.to_host`` as the package does it (two
  pinned slots, asynchronous copies polled for, host copies out).

Prints the card's name and power limit and, last, one JSON object: for
each turn the gaps between consecutive steps (ms) and the copy's seconds.
Needs one card; imports nothing of JAX.
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    print("torch_snapshot_copy: no CUDA device available", file=sys.stderr)
    sys.exit(1)

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.util import ingest  # noqa: E402
from deeplearning4j_tpu_torch.util.durable import TrainingState  # noqa: E402


def to_pageable(tree):
    if isinstance(tree, dict):
        return {k: to_pageable(v) for k, v in tree.items()}
    return tree.to("cpu") if torch.is_tensor(tree) else tree


def pageable_copy(state):
    """The clones into pageable host memory, straight from the device."""
    ingest.wait_event(state.event)
    stream = torch.cuda.Stream(state.device)
    with torch.cuda.stream(stream):
        out = [to_pageable(t) for t in (state.params, state.layer_state,
                                        state.updater_state)]
    stream.synchronize()
    return out


class Probe:
    def __init__(self, mode, at):
        self.mode, self.at = mode, at
        self.times, self.copy_s = [], None
        self.state = self.thread = None

    def iteration_done(self, model, iteration, score):
        self.times.append(time.perf_counter())
        if len(self.times) == self.at:
            self.state = TrainingState.capture(model)
            if self.mode != "none":
                self.thread = threading.Thread(target=self.copy)
                self.thread.start()

    def copy(self):
        t0 = time.perf_counter()
        if self.mode == "pinned":
            self.state.to_host()
        else:
            pageable_copy(self.state)
        self.copy_s = time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--at", type=int, default=4)
    args = ap.parse_args()
    print(cs.card_line(), flush=True)
    cs.phase_build()
    net = cs.ComputationGraph(cs.substrate_conf()).init()
    rng = np.random.default_rng(cs.SEED)
    V, B, T = cs.FLAGSHIP["V"], cs.FLAGSHIP["B"], cs.FLAGSHIP["T"]
    x = rng.integers(0, V, (B, T)).astype(np.int32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    net.fit([(x, y)] * 2)
    torch.cuda.synchronize()
    turns = []
    for mode in ("none", "pageable", "pinned", "pinned", "pageable", "none"):
        probe = Probe(mode, args.at)
        net.set_listeners(probe)
        net.fit([(x, y)] * args.steps)
        torch.cuda.synchronize()
        if probe.thread is not None:
            probe.thread.join()
        gaps = np.diff(np.asarray(probe.times)) * 1e3
        turns.append({"mode": mode, "gaps_ms": [float(g) for g in gaps],
                      "copy_s": probe.copy_s})
        print(f"{mode}: copy {probe.copy_s} s, gaps "
              f"{np.array2string(gaps, precision=2)} ms", flush=True)
        del probe
        torch.cuda.empty_cache()
    print(json.dumps({"steps": args.steps, "capture_after": args.at,
                      "turns": turns}))


if __name__ == "__main__":
    main()
