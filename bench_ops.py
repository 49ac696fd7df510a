#!/usr/bin/env python3
"""Per-op times of the config2 per-frame path, and its step per predictor.

    python3 bench_ops.py              # on the GPU
    python3 bench_ops.py --rehearse   # CPU, small shapes (control flow only)

Each op of one config2 frame (640x480, 512^3 block map, 4096 touched
blocks) is jitted alone and timed on the host clock around
`block_until_ready` (the median of REPS calls after a warm-up call), and
its device busy time per call is read from a profiler trace.  Then
`slam.step_donated` is timed over a synthetic orbit with each predictor:
the marched raycast (the presets) and the scatter-add splat
(`RaycastConfig.use_splat`).  Prints one JSON line per measurement, each
naming the device; the first line is the card's `nvidia-smi` name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPS = 20


def _timed(fn, *args, reps=REPS):
    """Median wall ms of `fn(*args)` over `reps` calls after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts)


def _device_ms(fn, *args, reps=10):
    """Device busy time per call from a profiler trace of `reps` calls.

    The union of the event intervals on the GPU planes' stream lines (the
    kernels and copies), divided by `reps`; None where the trace has no
    GPU plane (CPU runs).
    """
    import glob
    import tempfile

    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True)
        pd = jax.profiler.ProfileData.from_file(path)
        spans = sorted(
            (e.start_ns, e.start_ns + e.duration_ns)
            for pl in pd.planes if pl.name.startswith("/device:GPU")
            for ln in pl.lines if ln.name.startswith("Stream")
            for e in ln.events
        )
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / reps / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args(argv)

    from chip_smoke import card_line

    print(f"card: {card_line()}", flush=True)
    from instancefusion_tpu.utils.runtime import setup

    dev = setup("cpu" if args.rehearse else None)
    import jax

    from instancefusion_tpu.config import PRESETS, TsdfConfig
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import slam
    from instancefusion_tpu.geometry.camera import Intrinsics
    from instancefusion_tpu.models import segmentation as segm
    from instancefusion_tpu.ops import blocks, icp, labels, preprocess

    cfg = PRESETS["config2"]()
    if args.rehearse:
        cfg = dataclasses.replace(
            cfg,
            intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5,
                                  width=160, height=120),
            tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                            origin=(-1.92, -1.92, -0.4), table_capacity=2048,
                            touched_capacity=512),
            raycast=dataclasses.replace(cfg.raycast, splat_rmax=3),
        )
    intr, tsdf, rc = cfg.intrinsics, cfg.tsdf, cfg.raycast
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def emit(name, fn, *fargs, **extra):
        ms, ms_min = _timed(fn, *fargs)
        print(json.dumps({"op": name, "median_ms": ms, "min_ms": ms_min,
                          "device_ms": _device_ms(fn, *fargs), "reps": REPS,
                          "device": device, **extra}), flush=True)

    n = args.frames + 1
    poses = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses[i], intr) for i in range(n)]
    fa, fb = frames[0], frames[1]

    # A map holding frame a, with frame b's blocks allocated.
    k = min(tsdf.touched_capacity, blocks.num_blocks_per_axis(tsdf) ** 3)

    @jax.jit
    def frame_slots(bm, d, T):
        bm = blocks.discover_allocate(bm, d, T, intr, tsdf)
        s, v = blocks.frustum_slots(bm, T, intr, tsdf, rc.near, rc.far, k)
        return bm, s, v

    integ = jax.jit(lambda bm, s, v, d, c, T: blocks.integrate_slots(
        bm, s, v, d, c, T, intr, tsdf))
    bm, s, v = frame_slots(blocks.allocate(tsdf), fa.depth, poses[0])
    bm = integ(bm, s, v, fa.depth, fa.color, poses[0])
    bm, s, v = frame_slots(bm, fb.depth, poses[1])
    n_touched = int(v.sum())

    pyr_fn = jax.jit(lambda d, c: preprocess.build_frame_pyramid(
        d, intr, cfg.preprocess, cfg.icp.levels,
        preprocess.rgb_to_intensity(c)))
    emit("preprocess_pyramid", pyr_fn, fb.depth, fb.color)
    emit("frame_slots", frame_slots, bm, fb.depth, poses[1])
    emit("integrate_slots_color", integ, bm, s, v, fb.depth, fb.color,
         poses[1], blocks=n_touched)
    bm = integ(bm, s, v, fb.depth, fb.color, poses[1])

    march = jax.jit(lambda bm, prior, T: blocks.raycast(
        bm, T, intr, tsdf, rc, with_color=False, depth_prior=prior,
        screen_space_normals=True))
    emit("raycast_marched", march, bm, fb.depth, poses[1])
    pred = march(bm, fb.depth, poses[1])

    pyr = pyr_fn(frames[2].depth, frames[2].color)
    T_pred_cw = jax.numpy.linalg.inv(poses[1])
    assoc = jax.jit(lambda p, T: icp.reduce_equations(
        p[0]["vmap"], p[0]["nmap"], p[0]["valid"],
        *icp.associate(p[0]["vmap"], p[0]["valid"], pred.vertex_w,
                       pred.normal_w, pred.valid, T, T_pred_cw, intr,
                       cfg.icp),
        T, cfg.icp))
    emit("icp_associate_reduce_l0", assoc, pyr, poses[1])
    track = jax.jit(lambda p, T: icp.track(
        p, pred.vertex_w, pred.normal_w, pred.valid, T, poses[1], intr,
        cfg.icp))
    emit("icp_track_3_levels", track, pyr, poses[1],
         iters=list(cfg.icp.iters), assoc_every=list(cfg.icp.assoc_every))

    vote = jax.jit(lambda vt, bm, gid, d, T: labels.fuse(
        vt, bm, gid, d, T, intr, tsdf))
    emit("label_vote", vote, labels.allocate(tsdf), bm, fb.instance,
         fb.depth, poses[1])
    params, _, _ = segm.load_pretrained()
    head = jax.jit(segm.head_apply)
    emit("seg_head", head, params, fb.color, size=[intr.height, intr.width])

    # The whole step, per predictor, over the orbit (state chained).
    for splat in (False, True):
        c2 = dataclasses.replace(cfg, raycast=dataclasses.replace(
            rc, use_splat=splat))
        state = slam.init_state(c2, poses[0])
        t_compile = time.perf_counter()
        state, _ = slam.step_donated(c2, state, fa.depth, fa.color)
        jax.block_until_ready(state)
        t_compile = time.perf_counter() - t_compile
        ts = []
        for i in range(1, n):
            t0 = time.perf_counter()
            state, info = slam.step_donated(
                c2, state, frames[i].depth, frames[i].color)
            jax.block_until_ready(state)
            ts.append((time.perf_counter() - t0) * 1e3)
        err = float(jax.numpy.linalg.norm(state.T_wc[:3, 3]
                                          - poses[n - 1][:3, 3]))
        # Device time of the non-donated step on the last frame: it writes
        # a fresh payload, so it bounds the donated step from above.
        dev_ms = _device_ms(lambda st, d, c: slam.step(c2, st, d, c), state,
                            frames[-1].depth, frames[-1].color)
        print(json.dumps({
            "op": "step_" + ("splat" if splat else "marched"),
            "median_ms": statistics.median(ts), "min_ms": min(ts),
            "max_ms": max(ts), "frames": len(ts),
            "nondonated_device_ms": dev_ms,
            "first_call_s": t_compile, "final_pos_err_m": err,
            "splat_rmax": rc.splat_rmax if splat else None,
            "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
