"""Every example of the port (``deeplearning4j_tpu_torch/examples/``) runs
end to end with ``--smoke --device cpu``, one case per example.

A module-scoped fixture starts three runs at once: every example in turn
in ONE interpreter at one rank (an ``OK <name>`` marker each, as
``tests/test_examples.py`` does for the JAX package's scripts), and the
distributed ones again over gloo ranks, one process per rank with the
``torch.distributed`` environment: ``data_parallel_training`` and
``transformer_long_context`` at 2 ranks, ``parallel_transformer`` at 4
(the reference's mesh sizes for its smokes). No example downloads: they
run with the downloader off and fall back to the synthetic datasets.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "deeplearning4j_tpu_torch", "examples")
EXAMPLES = sorted(f[:-3] for f in os.listdir(_PKG)
                  if f.endswith(".py") and not f.startswith("_"))
RANKED = {2: ["data_parallel_training", "transformer_long_context"],
          4: ["parallel_transformer"]}
# what each run must print besides its OK marker (one rank, or every rank)
EXPECT = {
    "char_rnn_shakespeare": {1: "sampled:"},
    "data_parallel_training": {1: "processes: 1", 2: "processes: 2"},
    "early_stopping_mnist": {1: "best model restored: True"},
    "keras_import": {1: "rows sum to 1: True"},
    "mnist_lenet": {1: "accuracy:"},
    "parallel_transformer": {1: "need >1 process",
                             4: "dp x seq 2-D mesh"},
    "pretrain_autoencoder": {1: "curves reconstruction mse"},
    "resnet_cifar": {1: "Accuracy"},
    "serving_and_dashboard": {1: "served 4 predictions over HTTP"},
    "transformer_long_context": {
        1: "sequence-parallel half skipped: 1 process",
        2: "sequence-parallel DSL transformer (2 ranks)"},
    "tsne_embeddings": {1: "embedded: (24, 2)"},
    "word2vec_text": {1: "vocab round-trips: True"},
}

_DRIVER = r"""
import runpy, sys, traceback
for name in sys.argv[1:]:
    sys.argv = [name, "--smoke", "--device", "cpu"]
    try:
        runpy.run_module("deeplearning4j_tpu_torch.examples." + name,
                         run_name="__main__")
    except SystemExit as e:
        if e.code not in (None, 0):
            print(f"FAILED {name} (SystemExit {e.code})", flush=True)
            continue
    except BaseException:
        print(f"FAILED {name}:", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        continue
    print(f"OK {name}", flush=True)
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(names, env):
    return subprocess.Popen([sys.executable, "-c", _DRIVER, *names],
                            cwd=_REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs():
    """{world: [output of each rank]} for the one-rank run and the gloo
    launches, all started together."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    # one thread a process: the examples' smokes are small, and the
    # seven processes share the cores with the other test workers
    base.update(PYTHONPATH=_REPO + os.pathsep + base.get("PYTHONPATH", ""),
                DL4J_TPU_AUTO_DOWNLOAD="0", OMP_NUM_THREADS="1")
    procs = {1: [_start(EXAMPLES, base)]}
    for world, names in RANKED.items():
        env = dict(base, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
        procs[world] = [_start(names, dict(env, RANK=str(r)))
                        for r in range(world)]
    out = {}
    try:
        for world, ps in procs.items():
            out[world] = [p.communicate(timeout=600)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def test_every_example_has_a_case():
    assert sorted(EXPECT) == EXAMPLES == sorted(
        f[:-3] for f in os.listdir(os.path.join(_REPO, "examples"))
        if f.endswith(".py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke(runs, name):
    for world, want in EXPECT[name].items():
        for rank, log in enumerate(runs[world]):
            assert f"OK {name}" in log, (
                f"{name} at world {world}, rank {rank}:\n{log[-6000:]}")
            assert want in log, (
                f"{name} at world {world}, rank {rank} did not print "
                f"{want!r}:\n{log[-6000:]}")
