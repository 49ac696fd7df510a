"""Scaling sweep: sharded-engine frames/s at 1..N shards (SURVEY §5).

On the GPUs of one host this measures strong-scaling efficiency of the
slab-sharded map (BASELINE target: >= 70 % at N = 4); on a virtual CPU mesh
it runs functionally:

    BENCH_PLATFORM=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py          # functional validation only

One process normally drives every GPU of the host.  Multi-process: launch
one process per device with SCALE_COORD/SCALE_NPROC/SCALE_PID set
(jax.distributed.initialize via parallel.mesh); on GPUs each process takes
the one card SCALE_LOCAL_DEVICE (default SCALE_PID) names.

Prints one JSON line per shard count:
  {"metric": "sharded_frames_per_s", "shards": S, "value": fps,
   "efficiency_vs_1": e}
"""

from __future__ import annotations

import json
import os
import time


def main() -> None:
    import jax

    platform = os.environ.get("BENCH_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    if os.environ.get("SCALE_COORD"):
        from instancefusion_tpu.parallel.mesh import initialize_multihost

        pid = int(os.environ["SCALE_PID"])
        initialize_multihost(
            coordinator=os.environ["SCALE_COORD"],
            num_processes=int(os.environ["SCALE_NPROC"]),
            process_id=pid,
            local_device_ids=None if platform == "cpu" else [
                int(os.environ.get("SCALE_LOCAL_DEVICE", pid))
            ],
        )
    from instancefusion_tpu.utils.runtime import setup

    dev = setup(platform)

    from instancefusion_tpu.config import (
        EngineConfig, IcpConfig, RaycastConfig, TsdfConfig,
    )
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import slam_sharded
    from instancefusion_tpu.geometry.camera import Intrinsics
    from instancefusion_tpu.parallel import mesh as meshmod

    ndev = jax.device_count()
    grid = int(os.environ.get("SCALE_GRID", "128"))
    nframes = int(os.environ.get("SCALE_FRAMES", "10"))
    width = int(os.environ.get("SCALE_W", "160"))
    height = int(os.environ.get("SCALE_H", "120"))
    intr = Intrinsics(
        fx=width * 0.81, fy=width * 0.81,
        cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    extent = grid * 0.015
    sweep = []
    s = 1
    while s <= ndev:
        sweep.append(s)
        s *= 2

    # The splat path (use_splat): per-shard prediction work is
    # proportional to the shard's OWN in-frustum block count, not
    # all-pixels-everywhere — emitted below as blocks_per_shard_max so the
    # sweep shows per-shard work dropping as shards grow.
    use_splat = os.environ.get("SCALE_SPLAT", "1") != "0"
    rmax = int(os.environ.get("SCALE_RMAX", "3"))
    base_fps = None
    for shards in sweep:
        cfg = EngineConfig(
            intrinsics=intr,
            tsdf=TsdfConfig(
                voxel_size=2 * extent / grid, trunc=12 * extent / grid,
                grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
                block_size=8, table_capacity=1024 * shards,
            ),
            icp=IcpConfig(iters=(4, 3, 3), min_valid=50, rgb_weight=0.0),
            raycast=RaycastConfig(
                near=0.2, far=4.0, use_depth_prior=use_splat,
                screen_space_normals=use_splat, use_splat=use_splat,
                splat_rmax=rmax,
            ),
            map_kind="blocks",
        )
        mesh = meshmod.make_mesh(shards)
        state = slam_sharded.init_state(cfg, mesh)
        step = slam_sharded.make_step(cfg, mesh, donate=True)
        poses = synthetic.orbit_trajectory(nframes + 2)
        frames = [
            synthetic.render_frame(poses[i], intr) for i in range(nframes + 2)
        ]
        for i in range(2):
            state, _ = step(state, frames[i].depth, frames[i].color)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for i in range(2, 2 + nframes):
            state, _ = step(state, frames[i].depth, frames[i].color)
        jax.block_until_ready(state)
        fps = nframes / (time.perf_counter() - t0)
        if base_fps is None:
            base_fps = fps
        # Per-shard owned-row counts: the raycast/integrate work metric.
        import numpy as np

        counts = np.asarray(state.volume.n_active)
        print(json.dumps({
            "metric": "sharded_frames_per_s",
            "shards": shards,
            "value": fps,
            "efficiency_vs_1": fps / base_fps,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "splat_fast_path": use_splat,
            "blocks_total": int(counts.sum()),
            "blocks_per_shard_max": int(counts.max()),
        }), flush=True)


if __name__ == "__main__":
    main()
