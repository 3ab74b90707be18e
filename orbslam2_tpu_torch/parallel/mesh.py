"""The device mesh and its collectives.

Port of ``orbslam2_tpu/parallel/mesh.py``.  The reference's mesh is a
``jax.sharding.Mesh`` over the ``"map"`` axis, on which ``shard_map``
programs run one block per device.  Here it is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ``"map"`` over the
process group the caller initialized, one process (rank) per device: each
rank runs the same host program, holds its block of a sharded leading axis
(``block_rows``: the counterpart of ``kf_sharding``; a replicated tensor,
``replicated``, is a whole copy on every rank) and meets the others in the
collectives below.

The collectives take plain tensors.  ``all_gather_rows`` concatenates the
ranks' blocks in rank order; ``sum_over_ranks`` (the reference's ``psum``)
gathers the ranks' partial sums and adds them over the rank axis in rank
order, so that every rank holds the same bits.  The gloo backend gathers
CUDA tensors through the host (it gathers CPU tensors only); NCCL gathers
on the device.  ``STATS`` counts the collectives and their wall time.
Given ``mesh`` None the helpers are those of one device: the whole axis,
no collective.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MAP_AXIS = "map"

# Collectives made and their wall seconds (host staging included).
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def make_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """A 1-D mesh named ``"map"`` over every rank of the default process
    group (``initialize_distributed`` or ``init_process_group`` first).
    ``n_devices``, when given, must be the world size: one rank per device.
    DeviceMesh keeps its own bookkeeping on "cuda" under NCCL and on "cpu"
    under gloo; where the map lives is the caller's."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks, "
                         f"one per device")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(MAP_AXIS,))


def check_mesh(mesh, owner: str) -> Optional[DeviceMesh]:
    """``mesh`` if it shards (more than one rank), None for None or a
    mesh of one (the reference ignores a one-device mesh); a TypeError for
    anything that is not a DeviceMesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{owner}(mesh=...) takes a torch.distributed DeviceMesh "
                        f"(parallel/mesh.make_mesh), not {type(mesh).__name__}")
    return mesh if mesh.size() > 1 else None


def block_rows(n: int, mesh: Optional[DeviceMesh]) -> slice:
    """This rank's block of a leading axis of ``n`` rows, which must divide
    by the mesh size: rows [r n / size, (r + 1) n / size)."""
    if mesh is None:
        return slice(None)
    size = mesh.size()
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} ranks")
    c = n // size
    r = mesh.get_local_rank()
    return slice(r * c, (r + 1) * c)


def collective_route(mesh: DeviceMesh, device) -> str:
    """How the mesh's gathers move tensors on ``device``."""
    backend = dist.get_backend(mesh.get_group())
    staged = backend == "gloo" and torch.device(device).type == "cuda"
    return f"{backend}, through the host" if staged else backend


def all_gather_rows(x: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0
    in rank order."""
    return x if mesh is None else torch.cat(_gather(x, mesh), 0)


def sum_over_ranks(x: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order: the same bits on
    every rank."""
    return x if mesh is None else torch.stack(_gather(x, mesh)).sum(0)


def _gather(x: torch.Tensor, mesh: DeviceMesh):
    group = mesh.get_group()
    t0 = time.perf_counter()
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    if src.dtype == torch.bool:  # gathered as bytes
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src, group=group)
    parts = [p.to(x.device).view(x.dtype) for p in parts]
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += src.numel() * src.element_size() * mesh.size()
    return parts
