"""Device-mesh bootstrap (counterpart of the JAX package's
``parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group takes the place of ``jax.sharding.Mesh``: one rank per
device, named dims that the trainers shard over:

  - ``data``  — batch dimension (dp)
  - ``model`` — tensor-parallel dimension (tp), used by parallel/tensor.py
  - ``seq``   — sequence/context-parallel dimension (sp), used by ring attention

Each dim's process group (``axis_group``) carries that dim's collectives.
The device type is ``cuda`` (NCCL) unless the caller asks for ``cpu``
(gloo) or the process group already formed says otherwise. Without a
process group, a mesh over one rank forms a one-rank group in this
process (``distributed.ensure_world``), so single-process use needs no
bootstrap, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import distributed as _distributed


def mesh_devices(n: Optional[int] = None,
                 device_type: Optional[str] = None) -> List[int]:
    """The first ``n`` ranks of the process group (default: all), each
    rank one device."""
    _distributed.ensure_world(device_type)
    world = dist.get_world_size()
    if n is not None:
        if n > world:
            raise ValueError(
                f"requested {n} devices but only {world} available (one "
                "per rank of the process group); start one process per "
                "device and call parallel.initialize()")
        return list(range(n))
    return list(range(world))


def create_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None,
                device_type: Optional[str] = None) -> DeviceMesh:
    """Mesh with named dims, e.g. ``create_mesh({"data": 4, "model": 2})``;
    ``devices`` are global ranks (default: the first ranks)."""
    names = tuple(axes.keys())
    shape = tuple(int(s) for s in axes.values())
    total = int(np.prod(shape))
    device_type = _distributed.ensure_world(device_type)
    devs = list(devices) if devices is not None else mesh_devices(total)
    if len(devs) != total:
        raise ValueError(f"mesh {axes} needs {total} devices, got {len(devs)}")
    ranks = torch.tensor(devs, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def data_parallel_mesh(n: Optional[int] = None, devices=None,
                       device_type: Optional[str] = None) -> DeviceMesh:
    """1-D ``data`` mesh over n ranks (default: every rank)."""
    device_type = _distributed.ensure_world(device_type)
    devs = list(devices) if devices is not None else mesh_devices(n)
    return create_mesh({"data": len(devs)}, devs, device_type)


# --------------------------------------------------------------------------
# mesh queries (``mesh.shape[name]`` / ``axis_index`` of the JAX package)
# --------------------------------------------------------------------------


def axis_names(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, name: Optional[str]) -> int:
    return 1 if name is None else int(mesh_shape(mesh)[name])


def axis_group(mesh: DeviceMesh, name: Optional[str]):
    """The process group of this rank's slice along dim ``name`` (None for
    no dim)."""
    if name is None:
        return None
    if name not in axis_names(mesh):
        raise ValueError(f"mesh has no {name!r} dim: {axis_names(mesh)}")
    return mesh.get_group(name)


def axis_rank(mesh: DeviceMesh, name: Optional[str]) -> int:
    """This rank's coordinate along dim ``name`` (0 for no dim)."""
    return 0 if name is None else int(mesh.get_local_rank(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The torch device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
