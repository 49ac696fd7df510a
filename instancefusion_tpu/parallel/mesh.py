"""Device mesh + distributed-runtime helpers.

The reference is strictly single-GPU (SURVEY.md §3.2: no NCCL/MPI of any
kind); the distributed layer is new design mandated by BASELINE.json.
This module is the single owner of mesh/axis names so kernels and engine
code never call `jax.devices()` or collectives with ad-hoc axis strings.

The one axis, ``"shards"``, is the map axis: voxel-block payload rows and
BA edge/observation sets partition over it (NVLink within a host).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

SHARD_AXIS = "shards"


def make_mesh(num_shards: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the map axis (the centerpiece sharding).

    The first `num_shards` devices (all when None); raises when fewer are
    visible.  One axis suffices: the GPUs of one host are all-to-all.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if num_shards is not None:
        if num_shards > len(devices):
            raise ValueError(
                f"{num_shards} map shards need {num_shards} devices; "
                f"{len(devices)} visible"
            )
        devices = devices[:num_shards]
    return Mesh(devices, axis_names=(SHARD_AXIS,))


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids: list[int] | None = None) -> None:
    """`jax.distributed.initialize` wrapper (config 5, multi-host pods).

    Nothing tells JAX of a cluster on a plain GPU host or a CPU test rig,
    so the three arguments are passed explicitly there.  Several processes
    on one GPU host each take their own card via `local_device_ids`.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
