"""Checkpoint zip: read and write the JAX package's format (counterpart of
its ``util/serialization.py``).

The artifact is a zip holding ``configuration.json``, ``arrays.npz``
(every leaf under a path key: ``params/<vertex>/<name>``,
``state/...``, ``updater/<rule key>/<vertex>/<name>``),
``training_state.json`` (counters and the model class), ``dtypes.json``
(original dtype names of arrays stored widened to float32, e.g.
``bfloat16``) and ``checksums.json`` (sha256 of every other entry). A zip
written by either package loads in the other, the optimizer state
included, so training resumes across them. Both runtimes are covered:
``ComputationGraph`` (keys by vertex name) and ``MultiLayerNetwork``
(keys ``layer_{i}``, BatchNormalization's running statistics under
``state/``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch

from .. import dtypes as _dtypes
from . import faults as _faults

_CONFIG_ENTRY = "configuration.json"
_ARRAYS_ENTRY = "arrays.npz"
_STATE_ENTRY = "training_state.json"
_DTYPES_ENTRY = "dtypes.json"
_CHECKSUMS_ENTRY = "checksums.json"
_FORMAT_VERSION = 1


class CheckpointInvalid(ValueError):
    """The artifact is not a loadable checkpoint (truncated, corrupt, a
    failed checksum, or missing required entries)."""


def _write_file_atomic(path: str, data: bytes) -> None:
    """Same-directory temp file + rename: a crash mid-write never leaves a
    partial file under the final name."""
    _faults.check("checkpoint.write", {"path": path, "data": data})
    d, base = os.path.split(os.path.abspath(path))
    tmp = os.path.join(d, f".wip_{os.getpid()}_{base}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read(path: str) -> Tuple[str, Dict[str, np.ndarray], dict, dict]:
    """(configuration json, arrays, training state, dtype map), after
    checking every entry against ``checksums.json`` (or the zip CRCs for
    an artifact without one)."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            missing = {_CONFIG_ENTRY, _ARRAYS_ENTRY, _STATE_ENTRY} - names
            if missing:
                raise CheckpointInvalid(
                    f"{path}: missing entries {sorted(missing)}")
            data = {n: zf.read(n) for n in names}
            if _CHECKSUMS_ENTRY not in names and zf.testzip() is not None:
                raise CheckpointInvalid(f"{path}: CRC mismatch")
    except (zipfile.BadZipFile, OSError, EOFError) as e:
        raise CheckpointInvalid(f"{path}: {type(e).__name__}: {e}") from e
    if _CHECKSUMS_ENTRY in data:
        manifest = json.loads(data[_CHECKSUMS_ENTRY])
        for name, want in manifest.items():
            if name not in data:
                raise CheckpointInvalid(
                    f"{path}: manifest names missing entry {name!r}")
            if hashlib.sha256(data[name]).hexdigest() != want:
                raise CheckpointInvalid(f"{path}: sha256 mismatch for {name!r}")
    npz = np.load(io.BytesIO(data[_ARRAYS_ENTRY]), allow_pickle=False)
    arrays = {k: npz[k] for k in npz.files}
    dtype_map = (json.loads(data[_DTYPES_ENTRY])
                 if _DTYPES_ENTRY in data else {})
    return (data[_CONFIG_ENTRY].decode("utf-8"), arrays,
            json.loads(data[_STATE_ENTRY]), dtype_map)


def _tensor(a: np.ndarray, dtype_name=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))        # a writable copy
    return t.to(_dtypes.torch_dtype(dtype_name)) if dtype_name else t


_MODEL_CLASSES = ("ComputationGraph", "MultiLayerNetwork")


def _network(conf, device):
    """The runtime for a configuration: a ``MultiLayerNetwork`` over a
    ``MultiLayerConfiguration``, else a ``ComputationGraph``."""
    from ..nn.conf.multi_layer import MultiLayerConfiguration
    if isinstance(conf, MultiLayerConfiguration):
        from ..nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(conf, device=device)
    from ..nn.graph_runtime import ComputationGraph
    return ComputationGraph(conf, device=device)


def params_from_numpy(conf, arrays: Dict[str, np.ndarray], *, device="cuda",
                      dtype_map=None):
    """A network over ``conf`` (a :class:`ComputationGraph`, or a
    :class:`MultiLayerNetwork` for a ``MultiLayerConfiguration``) carrying
    the given parameters: ``arrays`` maps ``params/<vertex or layer_i>/
    <name>`` to numpy arrays, as the JAX package's checkpoint stores them
    (other keys are ignored). Every parameter the configuration declares
    must be present, with its shape; anything else under ``params/`` is an
    error."""
    dtype_map = dtype_map or {}
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, a in arrays.items():
        parts = key.split("/")
        if parts[0] != "params":
            continue
        if len(parts) != 3:
            raise ValueError(f"unexpected parameter key {key!r}")
        tree.setdefault(parts[1], {})[parts[2]] = _tensor(a, dtype_map.get(key))
    net = _network(conf, device)
    net.set_params(tree)
    return net


def load_model(path: str, device="cuda"):
    """Load a checkpoint zip written by either package into a
    :class:`ComputationGraph` or :class:`MultiLayerNetwork` (as its
    ``training_state.json`` names) on ``device`` (``"cuda"`` by default;
    pass ``device="cpu"`` for the CPU): parameters, layer state (BN running
    statistics), the optimizer state and the counters."""
    from ..nn.conf.graph import ComputationGraphConfiguration
    from ..nn.conf.layers import NotYetPorted
    from ..nn.conf.multi_layer import MultiLayerConfiguration
    config_json, arrays, training_state, dtype_map = _read(path)
    model_class = training_state.get("model_class")
    if model_class not in _MODEL_CLASSES:
        raise NotYetPorted(f"{path}: model class {model_class!r} is not yet "
                           "ported to the PyTorch package")
    conf = (MultiLayerConfiguration if model_class == "MultiLayerNetwork"
            else ComputationGraphConfiguration).from_json(config_json)
    net = params_from_numpy(conf, arrays, device=device, dtype_map=dtype_map)
    for key, a in arrays.items():
        head, _, rest = key.partition("/")
        if head == "state":
            vertex, _, name = rest.partition("/")
            net.state.setdefault(vertex, {})[name] = _tensor(
                a, dtype_map.get(key)).to(net.device)
    net.init_updater()
    if training_state.get("has_updater"):
        _restore_updater(net, {k: a for k, a in arrays.items()
                               if k.startswith("updater/")})
    net.iteration_count = training_state.get("iteration_count", 0)
    net.epoch_count = training_state.get("epoch_count", 0)
    net._update_count = training_state.get("update_count", 0)
    return net


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor]) -> None:
    """Path-keyed leaves of a nested-dict tree (the reference's
    ``_flatten``; '/' in keys is reserved)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"'/' not allowed in checkpoint key: {k!r}")
            _flatten(f"{prefix}/{k}", v, out)
    elif tree is not None:
        out[prefix] = tree


def _restore_updater(net, arrays: Dict[str, np.ndarray]) -> None:
    """Fill ``net.updater_state`` (freshly initialised, the template) from
    a checkpoint's ``updater/...`` arrays, path by path; every leaf must be
    present with its shape, and nothing else."""
    template: Dict[str, torch.Tensor] = {}
    _flatten("updater", net.updater_state, template)
    if set(arrays) != set(template):
        raise ValueError(
            "updater state mismatch: the checkpoint has "
            f"{sorted(set(arrays) - set(template))[:5]} the model lacks and "
            f"lacks {sorted(set(template) - set(arrays))[:5]} — was the "
            "configuration changed?")
    with torch.no_grad():
        for key, t in template.items():
            a = torch.from_numpy(np.asarray(arrays[key], dtype=np.float32))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(a.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(a)


def _numpy(t: torch.Tensor, key: str, dtype_map: Dict[str, str]) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # npz has no bfloat16: store widened, name the dtype in dtypes.json
        dtype_map[key] = "bfloat16"
        t = t.float()
    return t.numpy()


def save_model(net, path: str, save_updater: bool = True) -> None:
    """Write ``net`` as a checkpoint zip the JAX package's ``load_model``
    reads (and this package's :func:`load_model`)."""
    arrays: Dict[str, np.ndarray] = {}
    dtype_map: Dict[str, str] = {}
    for vertex, params in net.params.items():
        for name, t in params.items():
            key = f"params/{vertex}/{name}"
            arrays[key] = _numpy(t, key, dtype_map)
    for vertex, st in net.state.items():
        for name, t in st.items():
            key = f"state/{vertex}/{name}"
            arrays[key] = _numpy(t, key, dtype_map)
    has_updater = bool(save_updater and net.updater_state is not None)
    if has_updater:
        leaves: Dict[str, torch.Tensor] = {}
        _flatten("updater", net.updater_state, leaves)
        for key, t in leaves.items():
            arrays[key] = _numpy(t, key, dtype_map)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    training_state = {
        "format_version": _FORMAT_VERSION,
        "model_class": type(net).__name__,
        "iteration_count": net.iteration_count,
        "epoch_count": net.epoch_count,
        "update_count": net._update_count,
        "has_updater": has_updater,
    }
    entries = {_CONFIG_ENTRY: net.conf.to_json().encode("utf-8"),
               _ARRAYS_ENTRY: buf.getvalue(),
               _STATE_ENTRY: json.dumps(training_state,
                                        indent=2).encode("utf-8")}
    if dtype_map:
        entries[_DTYPES_ENTRY] = json.dumps(dtype_map, indent=2).encode("utf-8")
    manifest = {name: hashlib.sha256(data).hexdigest()
                for name, data in entries.items()}
    zbuf = io.BytesIO()
    with zipfile.ZipFile(zbuf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in entries.items():
            # the arrays are stored, not deflated: float weights barely
            # compress, and inflating gigabytes dominated a large model's
            # load (either package reads both methods)
            zf.writestr(name, data, compress_type=(
                zipfile.ZIP_STORED if name == _ARRAYS_ENTRY else None))
        zf.writestr(_CHECKSUMS_ENTRY, json.dumps(manifest, indent=2))
    _write_file_atomic(path, zbuf.getbuffer())
