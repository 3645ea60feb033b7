"""Multi-process bootstrap and global meshes (counterpart of the JAX
package's ``parallel/distributed.py``).

Every process runs the same program over its own device and its shard of
the work; ``torch.distributed`` joins the processes into one process
group, NCCL between cards and gloo between CPU processes, chosen from the
device and never swapped for another when it fails to form. A global
mesh's first dim varies slowest across processes, so shard it by
boundary-tolerant traffic (data parallelism) and the inner dims by
bandwidth-hungry traffic (tensor and sequence parallelism).

Membership and round state of ELASTIC fleets do not ride on the process
group: a collective hangs on a dead peer, the failure that layer must
survive. That state lives on the coordination store of
:mod:`.elastic`, and :func:`agree_on_digest` takes an injectable
``allgather`` so the elastic layer can run the same commit gate over its
store-backed gather.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("deeplearning4j_tpu")

_initialized = False

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type "
                         f"{device_type!r} (cuda → nccl, cpu → gloo)")
    return BACKENDS[device_type]


def world_device_type() -> Optional[str]:
    """The device type of the formed process group (None before one
    forms)."""
    if not dist.is_initialized():
        return None
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _set_cuda_device(rank: int, local_device_ids) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for an NCCL process "
                           "group; pass device='cpu' for gloo")
    ids = (list(local_device_ids) if local_device_ids is not None
           else list(range(torch.cuda.device_count())))
    torch.cuda.set_device(ids[rank % len(ids)])


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               device: str = "cuda") -> None:
    """Join (or form) the process group.

    Pass the coordinator's ``host:port`` (or a ``tcp://``/``file://`` URL),
    the world size and this process's rank, or set ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``torchrun`` does). The
    backend follows ``device``: NCCL for ``"cuda"``, gloo for ``"cpu"``;
    a group that fails to form raises.

    Single-process use (no coordinator, no ``MASTER_ADDR``,
    ``num_processes`` in (None, 1)) is a no-op: a mesh forms its
    one-rank group when it is built (:func:`ensure_world`).
    """
    global _initialized
    if _initialized:
        return
    explicit = (coordinator_address is not None
                or os.environ.get("MASTER_ADDR"))
    if not explicit and num_processes in (None, 1):
        return
    device_type = torch.device(device).type
    backend = backend_for(device_type)
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
        kwargs = dict(init_method=url, world_size=world, rank=rank)
    else:
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None
                   else os.environ["RANK"])
        kwargs = dict(init_method="env://", world_size=world, rank=rank)
    if device_type == "cuda":
        _set_cuda_device(rank, local_device_ids)
    dist.init_process_group(backend=backend, **kwargs)
    _initialized = True


def ensure_world(device_type: Optional[str] = None) -> str:
    """The device type of the process group, forming a one-rank group in
    this process when none exists (``cuda`` unless asked). A formed
    group of another device type raises."""
    have = world_device_type()
    if have is not None:
        if device_type is not None and device_type != have:
            raise ValueError(f"the process group runs on {have!r} "
                             f"({dist.get_backend()}); a {device_type!r} "
                             "mesh needs a group of that device type")
        return have
    device_type = device_type or "cuda"
    backend = backend_for(device_type)
    if device_type == "cuda":
        _set_cuda_device(0, None)
    dist.init_process_group(backend=backend, store=dist.HashStore(),
                            rank=0, world_size=1)
    return device_type


def is_initialized() -> bool:
    return _initialized


def shutdown() -> None:
    """Leave the process group (also a one-rank group a mesh formed)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axes: Optional[Dict[str, int]] = None,
                device_type: Optional[str] = None):
    """Mesh over ALL ranks of the process group.

    Default: 1-D ``data`` mesh over every rank. With ``axes``, the
    product must equal the world size; ranks are laid out row-major, so
    the FIRST dim varies slowest across processes."""
    from .mesh import create_mesh
    device_type = ensure_world(device_type)
    world = dist.get_world_size()
    if axes is None:
        return create_mesh({"data": world}, device_type=device_type)
    total = int(np.prod(list(axes.values())))
    if total != world:
        raise ValueError(
            f"mesh {axes} needs {total} devices, runtime has {world} "
            f"across {world} process(es)")
    return create_mesh(axes, device_type=device_type)


def _default_allgather(local: np.ndarray) -> np.ndarray:
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, local)
    return np.stack(rows)


def agree_on_digest(digest: str, *, allgather=None) -> bool:
    """Pre-commit barrier for the multi-process dp path: every process
    presents its training-state digest (``util.durable.params_digest``)
    and the checkpoint commits only if ALL agree.

    ``allgather`` is injectable (the elastic layer passes its
    store-backed gather); the default gathers over the process group
    (single process: trivially True)."""
    local = np.frombuffer(bytes.fromhex(digest), dtype=np.uint8)
    if allgather is None:
        if process_count() == 1:
            return True
        allgather = _default_allgather
    world = np.atleast_2d(np.asarray(allgather(local)))
    return bool((world == world[0]).all())


def _to_device(mesh, a) -> Optional[torch.Tensor]:
    from .mesh import mesh_device
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a)).to(mesh_device(mesh))


def host_replicated_batch(mesh, *arrays):
    """Tensors on this rank's device from identical per-process host
    arrays — the feeding path for meshes whose dims carry model state
    (tensor/pipeline dims). Every process passes the same full array."""
    out = [_to_device(mesh, a) for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


def host_local_batch(mesh, *arrays, axis: str = "data"):
    """GLOBAL batches from per-process host-local ones: each process
    passes ITS shard, and the shards of the ``axis`` dim are concatenated
    in rank order on every rank (the trainers take global batches and
    keep their own rows). Single process: the array on the device."""
    from .collectives import all_gather_dim
    from .mesh import axis_group
    group = axis_group(mesh, axis)
    out = []
    for a in arrays:
        t = _to_device(mesh, a)
        out.append(None if t is None else all_gather_dim(t, group, 0))
    return out[0] if len(out) == 1 else tuple(out)
