"""Sharded-engine frames/s at bench.py's configuration.

Runs engine/slam_sharded on a SHARDS-device mesh (default 1) with EXACTLY
bench.py's 512^3/VGA configuration, so the number is directly comparable
to the single-device headline.

Env: BENCH_GRID/BENCH_FRAMES/BENCH_TOUCHED as bench.py; SHARDS (default 1);
BENCH_CHUNK=K replays K frames per dispatch via slam_sharded.make_run_chunk
(the sharded analog of bench.py's chunked mode).  Needs GPUs;
BENCH_PLATFORM=cpu runs on virtual CPU devices instead.
"""

from __future__ import annotations

import json
import os
import time


def main() -> None:
    import jax

    platform = os.environ.get("BENCH_PLATFORM")
    shards = int(os.environ.get("SHARDS", "1"))
    if platform == "cpu":
        jax.config.update("jax_num_cpu_devices", shards)
    from instancefusion_tpu.utils.runtime import setup

    dev = setup(platform)
    import jax.numpy as jnp

    from instancefusion_tpu.config import (
        EngineConfig, IcpConfig, RaycastConfig, TsdfConfig,
    )
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import slam_sharded
    from instancefusion_tpu.geometry.camera import TUM_FR1
    from instancefusion_tpu.parallel import mesh as meshmod

    grid = int(os.environ.get("BENCH_GRID", "512"))
    nframes = int(os.environ.get("BENCH_FRAMES", "30"))
    warmup = 3
    touched_cap = int(os.environ.get("BENCH_TOUCHED", "2048"))
    extent = grid * 0.0075
    cfg = EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(
            voxel_size=extent / grid * 2,
            trunc=6 * extent / grid * 2,
            grid_size=grid,
            origin=(-extent, -extent, 1.2 - extent),
            block_size=8,
            table_capacity=65536,
            touched_capacity=touched_cap,
        ),
        icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0,
                      assoc_every=(2, 2, 4)),
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True,
                              predict_color=False),
        map_kind="blocks",
        use_color=True,
        color_every=int(os.environ.get("BENCH_COLOR_EVERY", "4")),
        num_shards=shards,
    )

    mesh = meshmod.make_mesh(shards)
    poses = synthetic.orbit_trajectory(nframes + warmup)
    frames = [
        synthetic.render_frame(poses[i], cfg.intrinsics)
        for i in range(nframes + warmup)
    ]
    state = slam_sharded.init_state(cfg, mesh, poses[0])
    step = slam_sharded.make_step(cfg, mesh, donate=True)
    chunk = int(os.environ.get("BENCH_CHUNK", "0"))

    for i in range(warmup):
        state, _ = step(state, frames[i].depth, frames[i].color)
    jax.block_until_ready(state)
    if chunk:
        assert nframes % chunk == 0, "BENCH_FRAMES must be a multiple of BENCH_CHUNK"
        run_chunk = slam_sharded.make_run_chunk(cfg, mesh)
        staged = [
            (
                jnp.stack([f.depth for f in frames[i : i + chunk]]),
                jnp.stack([f.color for f in frames[i : i + chunk]]),
            )
            for i in range(warmup, warmup + nframes, chunk)
        ]
        state, _ = run_chunk(state, *staged[0])  # compile
        jax.block_until_ready(state)
        staged = staged[1:] + [staged[0]]
        t0 = time.perf_counter()
        for d, c in staged:
            state, _ = run_chunk(state, d, c)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + nframes):
            state, _ = step(state, frames[i].depth, frames[i].color)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"sharded_frames_per_s_{grid}cubed_{shards}shard",
        "value": nframes / dt,
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "color_every": cfg.color_every,
        "chunk": chunk,
    }))


if __name__ == "__main__":
    main()
