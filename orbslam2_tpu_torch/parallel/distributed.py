"""Process-group start-up and the live map sharded over the mesh.

Port of ``orbslam2_tpu/parallel/distributed.py``:

  * ``initialize_distributed`` wraps ``torch.distributed.
    init_process_group`` for a mesh of several processes, one per device
    (the reference's ``jax.distributed.initialize``); one process needs no
    group and returns False;
  * ``shard_map_state`` keeps this rank's block of rows of every
    keyframe-major field of a ``MapState`` (poses, keypoints, descriptors,
    bindings), the point pools and counters whole, as the reference places
    its live map with keyframe-block sharding; ``gather_map_state`` rebuilds
    the whole map on every rank.  Where the keyframe capacity does not
    divide by the mesh size the fields stay whole, as in the reference.

Launch, on every rank::

    initialize_distributed("tcp://host0:29500", num_processes=N,
                           process_id=i, backend="nccl")  # "gloo" on CPUs
    mesh = make_mesh()
    system = SlamSystem(settings, "rgbd", mesh=mesh)    # the same frames

The caller names the backend: NCCL for one rank per GPU, gloo for CPU
ranks (or several ranks on one GPU, which NCCL refuses).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import map_state as ms
from .mesh import all_gather_rows, block_rows

# The keyframe-major fields: sharded along the keyframe axis.
KF_FIELDS = (
    "kf_pose_cw", "kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_ur",
    "kf_kp_valid", "kf_point", "kf_valid", "kf_frame_id", "kf_parent",
)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join this process to a group of ``num_processes`` as rank
    ``process_id`` through ``coordinator`` ("tcp://host:port", "host:port"
    or "file:///path"), on ``backend``.  Returns False, doing nothing, for
    one process; True once the group is up (also when it already was)."""
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        raise ValueError("initialize_distributed: name the backend (\"nccl\" or \"gloo\")")
    if coordinator is not None and "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    dist.init_process_group(backend=backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return True


class ShardedMap(NamedTuple):
    """This rank's part of a live map: ``block`` holds this rank's block of
    rows of the keyframe fields (every row where ``sharded`` is False) and
    the whole point pools and counters."""

    block: ms.MapState
    mesh: DeviceMesh
    sharded: bool


def map_state_shardings(m: ms.MapState, mesh: DeviceMesh) -> ms.MapState:
    """Per field, "shard" (rows split over the mesh) or "replicate"."""
    split = m.kf_capacity % mesh.size() == 0
    return type(m)(*("shard" if split and name in KF_FIELDS else "replicate"
                     for name in m._fields))


def shard_map_state(m: ms.MapState, mesh: DeviceMesh) -> ShardedMap:
    """This rank's block of the live map ``m`` (which every rank holds)."""
    placements = map_state_shardings(m, mesh)
    sharded = "shard" in placements
    rows = block_rows(m.kf_capacity, mesh) if sharded else None
    block = type(m)(*(x[rows].clone() if p == "shard" else x
                      for x, p in zip(m, placements)))
    return ShardedMap(block, mesh, sharded)


def gather_map_state(sm: ShardedMap) -> ms.MapState:
    """The whole map, on every rank, from each rank's block."""
    if not sm.sharded:
        return sm.block
    return type(sm.block)(*(
        all_gather_rows(x, sm.mesh) if name in KF_FIELDS else x
        for name, x in zip(sm.block._fields, sm.block)
    ))

