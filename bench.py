"""Headline benchmark: fused frames/s on one device (BASELINE.json metric).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline":
N, "device": {"platform", "kind", "count"}, ...}.

Runs the full per-frame pipeline (preprocess -> 3-level ICP -> TSDF
integrate -> raycast prediction) over synthetic frames at 640x480 with a
512^3 block-hashed TSDF (the BASELINE headline configuration; >= 30 fused
frames/s is the target).  Steps are chained (state feeds state) and the
timed region ends in `block_until_ready`, so no step can be elided or
overlapped out of the measurement.

Needs a GPU; BENCH_PLATFORM=cpu runs on the CPU instead.  Env overrides:
BENCH_GRID (512), BENCH_FRAMES (30), BENCH_MAP (blocks|dense), BENCH_CHUNK
(6; 1 = per-frame dispatch), BENCH_TOUCHED (2048), BENCH_RGB (0.0),
BENCH_PREDCOLOR (0), BENCH_COLOR_EVERY (4).
"""

from __future__ import annotations

import json
import os
import time


def main() -> None:
    from instancefusion_tpu.utils.runtime import setup

    dev = setup(os.environ.get("BENCH_PLATFORM"))
    import jax
    import jax.numpy as jnp

    from instancefusion_tpu.config import (
        EngineConfig,
        IcpConfig,
        RaycastConfig,
        TsdfConfig,
    )
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import slam
    from instancefusion_tpu.geometry.camera import TUM_FR1

    grid = int(os.environ.get("BENCH_GRID", "512"))
    nframes = int(os.environ.get("BENCH_FRAMES", "30"))
    map_kind = os.environ.get("BENCH_MAP", "blocks")
    warmup = 3

    touched_cap = int(os.environ.get("BENCH_TOUCHED", "2048"))
    extent = grid * 0.0075  # keep the synthetic room inside the volume
    cfg = EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(
            voxel_size=extent / grid * 2,  # ~1.5cm at 512
            trunc=6 * extent / grid * 2,
            grid_size=grid,
            origin=(-extent, -extent, 1.2 - extent),
            block_size=8,
            table_capacity=65536,
            touched_capacity=touched_cap,
        ),
        icp=IcpConfig(iters=(10, 5, 4),
                      # BENCH_RGB: photometric-term weight; the recorded
                      # headline stays geometric-only unless set.
                      rgb_weight=float(os.environ.get("BENCH_RGB", "0.0")),
                      assoc_every=(2, 2, 4)),
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True,
                              predict_color=os.environ.get(
                                  "BENCH_PREDCOLOR", "0") == "1"),
        map_kind=map_kind,
        use_color=True,
        color_every=int(os.environ.get("BENCH_COLOR_EVERY", "4")),
    )

    poses = synthetic.orbit_trajectory(nframes + warmup)
    # Pre-render frames on device (rendering is not part of the timed loop).
    frames = [
        synthetic.render_frame(poses[i], cfg.intrinsics)
        for i in range(nframes + warmup)
    ]

    # Chunked offline-log replay (slam.run_chunk): K frames per dispatch,
    # identical per-frame pipeline, host dispatch amortized.  chunk=1
    # falls back to the per-frame step_donated driver (live mode).
    chunk = int(os.environ.get("BENCH_CHUNK", "6"))

    state = slam.init_state(cfg, poses[0])
    for i in range(warmup):
        state, info = slam.step_donated(
            cfg, state, frames[i].depth, frames[i].color
        )
    jax.block_until_ready(state)

    if chunk > 1:
        assert nframes % chunk == 0, "BENCH_FRAMES must be a multiple of BENCH_CHUNK"
        batches = [
            (
                jnp.stack([frames[i + j].depth for j in range(chunk)]),
                jnp.stack([frames[i + j].color for j in range(chunk)]),
            )
            for i in range(warmup, warmup + nframes, chunk)
        ]
        # Warm the chunk program too (donates state; rebind).
        state, _ = slam.run_chunk(cfg, state, *batches[0])
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for d, c in batches:
            state, _ = slam.run_chunk(cfg, state, d, c)
        jax.block_until_ready(state)
    else:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + nframes):
            state, info = slam.step_donated(
                cfg, state, frames[i].depth, frames[i].color
            )
        jax.block_until_ready(state)
    fps = nframes / (time.perf_counter() - t0)
    # The measurement MODE rides along with the number (chunked offline
    # replay vs per-frame live dispatch, and the color cadence).
    print(
        json.dumps(
            {
                "metric": f"fused_frames_per_s_{grid}cubed_{map_kind}",
                "value": fps,
                "unit": "frames/s",
                "vs_baseline": fps / 30.0,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "chunk": chunk,
                "color_every": cfg.color_every,
                "predict_color": cfg.raycast.predict_color,
            }
        )
    )


if __name__ == "__main__":
    main()
