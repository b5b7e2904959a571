"""Device mesh construction: a `DeviceMesh` with named axes.

Port of `flash_attention_tpu/parallel/mesh.py`.  The axes are the JAX
package's:

  data  — data parallelism
  model — tensor parallelism over attention heads / MLP hidden
  seq   — sequence (context) parallelism for ring attention

One process drives one device (torch.distributed's model), so the mesh
holds global ranks where the JAX mesh holds devices.  A JAX
`NamedSharding(mesh, PartitionSpec(...))` becomes a `Sharding`: the mesh
and one DTensor placement (`Shard(dim)` or `Replicate()`) per mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from ..config import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


class Sharding(NamedTuple):
    """A mesh and one placement per mesh axis (JAX's NamedSharding):
    `distribute_tensor(x, *sharding)` places a global tensor."""

    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def _check_backend(device_type: str) -> None:
    backend = dist.get_backend()
    if device_type == "cuda" and backend != "nccl":
        raise ValueError(f"a CUDA mesh needs an NCCL process group, this one is {backend}")
    if device_type == "cpu" and "gloo" not in backend:
        raise ValueError(f"a CPU mesh needs a gloo process group, this one is {backend}")


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    *,
    devices=None,
    device=None,
) -> DeviceMesh:
    """Build a (data, model, seq) mesh over the process group's ranks.

    Any axis set to -1 absorbs the remaining ranks.  devices: the global
    ranks to use, default every rank of the default group; the mesh takes
    the first data * model * seq of them.  device: the device type of the
    mesh, default the card ("cuda", which needs NCCL); "cpu" (gloo) when
    asked for.  The process group must be up (`initialize_multihost`).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost() first")
    device_type = resolve_device(device).type
    _check_backend(device_type)
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(ranks)
    dims = [data, model, seq]
    if dims.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in dims:
        known = int(np.prod([d for d in dims if d != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        dims[dims.index(-1)] = n // known
    total = int(np.prod(dims))
    if total > n:
        raise ValueError(f"mesh {dims} needs {total} devices, have {n}")
    grid = torch.tensor(ranks[:total], dtype=torch.int64).reshape(dims)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along mesh axis `axis` (JAX's mesh.shape[axis])."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh: DeviceMesh, spec: tuple) -> tuple[Placement, ...]:
    """The placements of a JAX-style spec (one mesh axis name or None per
    tensor dim, as a PartitionSpec): Shard(dim) on each named axis,
    Replicate() on the others."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, placements(mesh, ()))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading batch dim over the data axis."""
    return Sharding(mesh, placements(mesh, (DATA_AXIS,)))


def seq_batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Context-parallel training batches [B, T]: batch over data, tokens
    over seq.  Pairs with GPTConfig/LlamaConfig(seq_mesh=mesh,
    seq_batch_axis=DATA_AXIS): each rank keeps its rows and its tokens
    through the whole transformer, and the ring keeps both axes
    distributed."""
    return Sharding(mesh, placements(mesh, (DATA_AXIS, SEQ_AXIS)))
