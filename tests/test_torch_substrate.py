"""The port's package boundary and checkpoint format.

* The port imports neither ``jax`` nor the JAX package. Checked in a fresh
  subprocess: this test process already imported jax (tests/conftest.py).
  The prefix matters — ``deeplearning4j_tpu_torch`` starts with
  ``deeplearning4j_tpu`` — so the check matches the module name exactly or
  with a dot.
* Checkpoints cross both ways: the reference's ``save_model`` → the port's
  ``load_model`` gives bit-identical arrays, and the port's ``save_model``
  → the reference's ``load_model`` works.
* Entry points default to the card and raise without one.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.util.serialization import load_model as j_load_model
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.util.serialization import (CheckpointInvalid,
                                                         load_model,
                                                         params_from_numpy,
                                                         save_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "deeplearning4j_tpu" or m.startswith("deeplearning4j_tpu."))
print(len(names), sorted(names), bad, sep="\n")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr
    n, names, bad = res.stdout.strip().split("\n")
    assert int(n) >= 20                       # the server and ops included
    for mod in ("losses", "optimize.updaters", "ops.flash_attention",
                "nn.graph_runtime", "util.serialization"):
        assert f"'deeplearning4j_tpu_torch.{mod}'" in names, mod
    assert bad.strip() == "[]", bad


def _jax_net(dtype="float32", seed=3):
    conf = j_transformer_lm(64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
                            dtype=dtype, input_ids=True, seed=seed)
    return JComputationGraph(conf).init()


def _jax_params(jnet):
    return {f"params/{v}/{k}": np.asarray(a)
            for v, ps in jnet.params.items() for k, a in ps.items()}


def test_reference_checkpoint_loads_bit_identical(tmp_path):
    jnet = _jax_net()
    path = str(tmp_path / "ref.zip")
    j_save_model(jnet, path)
    tnet = load_model(path, device="cpu")
    want = _jax_params(jnet)
    got = {f"params/{v}/{k}": t.detach().numpy()
           for v, ps in tnet.params.items() for k, t in ps.items()}
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    # the reference's adam state becomes the port's updater state, leaf
    # for leaf at the same paths
    assert set(tnet.updater_state) == {"m", "v"}
    for rule, tree in tnet.updater_state.items():
        for v, ps in tree.items():
            for k, t in ps.items():
                want = np.asarray(jnet.updater_state[rule][v][k])
                assert t.dtype == torch.float32
                assert np.array_equal(t.numpy(), want), (rule, v, k)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jnet = _jax_net(seed=4)
    ref_path = str(tmp_path / "ref.zip")
    j_save_model(jnet, ref_path)
    tnet = load_model(ref_path, device="cpu")
    port_path = str(tmp_path / "port.zip")
    save_model(tnet, port_path)
    back = j_load_model(port_path)
    assert type(back).__name__ == "ComputationGraph"
    for key, a in _jax_params(jnet).items():
        assert np.array_equal(_jax_params(back)[key], a), key
    ids = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(np.asarray(back.output(ids)),
                               tnet.output(ids).numpy(), atol=1e-5, rtol=0)
    # updater state survives the round trip into the reference
    ref_leaves = jax.tree_util.tree_leaves(jnet.updater_state)
    back_leaves = jax.tree_util.tree_leaves(back.updater_state)
    assert len(ref_leaves) == len(back_leaves)
    for a, b in zip(ref_leaves, back_leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_port_round_trip_and_bf16_params(tmp_path):
    conf = transformer_lm(64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
                          input_ids=True)
    net = ComputationGraph(conf, device="cpu").init()
    tree = {v: dict(ps) for v, ps in net.params.items()}
    tree["out"]["W"] = tree["out"]["W"].detach().to(torch.bfloat16)
    net.set_params(tree)
    path = str(tmp_path / "p.zip")
    save_model(net, path)
    with zipfile.ZipFile(path) as zf:
        assert json.loads(zf.read("dtypes.json")) == {
            "params/out/W": "bfloat16"}
    again = load_model(path, device="cpu")
    for v, ps in net.params.items():
        for k, t in ps.items():
            assert again.params[v][k].dtype == t.dtype
            assert torch.equal(again.params[v][k], t)
    # the reference reads the same artifact (bfloat16 restored via ml_dtypes)
    jback = j_load_model(path)
    assert str(np.asarray(jback.params["out"]["W"]).dtype) == "bfloat16"


def test_corrupt_checkpoint_is_refused(tmp_path):
    jnet = _jax_net()
    path = str(tmp_path / "ref.zip")
    j_save_model(jnet, path)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    cfg = json.loads(entries["configuration.json"])
    cfg["training"]["seed"] += 1                  # edited after the manifest
    entries["configuration.json"] = json.dumps(cfg).encode()
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(bad, "w") as zf:
        for n, data in entries.items():
            zf.writestr(n, data)
    with pytest.raises(CheckpointInvalid, match="sha256"):
        load_model(bad, device="cpu")
    with open(str(tmp_path / "trunc.zip"), "wb") as f:
        f.write(open(path, "rb").read()[:100])
    with pytest.raises(CheckpointInvalid):
        load_model(str(tmp_path / "trunc.zip"), device="cpu")


def test_params_from_numpy_checks_names_and_shapes():
    jnet = _jax_net()
    conf_json = jnet.conf.to_json()
    from deeplearning4j_tpu_torch.nn.conf.graph import \
        ComputationGraphConfiguration
    conf = ComputationGraphConfiguration.from_json(conf_json)
    arrays = _jax_params(jnet)
    net = params_from_numpy(conf, arrays, device="cpu")
    assert net.num_params() == sum(a.size for a in arrays.values())
    missing = dict(arrays)
    missing.pop("params/out/b")
    with pytest.raises(ValueError, match="out"):
        params_from_numpy(conf, missing, device="cpu")
    wrong = dict(arrays)
    wrong["params/out/b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(conf, wrong, device="cpu")


@pytest.mark.parametrize("name,expected", [
    ("float32", torch.float32), ("mixed_bf16", torch.bfloat16),
    ("bf16", torch.bfloat16), ("float64", torch.float64)])
def test_policy_names(name, expected):
    pol = tdtypes.policy_from_name(name)
    assert pol.compute_dtype == expected
    assert pol.param_dtype in (torch.float32, torch.float64)
    assert tdtypes.MIXED_BF16.output_dtype == torch.bfloat16


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from deeplearning4j_tpu_torch.serving import InferenceServer
    conf = transformer_lm(64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
                          input_ids=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf)
    net = ComputationGraph(conf, device="cpu").init()
    path = str(tmp_path / "m.zip")
    save_model(net, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(net)
