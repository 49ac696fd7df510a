#!/usr/bin/env python3
"""Smoke test: the SLAM engine's main path on a GPU, end to end.

    python3 chip_smoke.py                # one GPU (the default)
    python3 chip_smoke.py --devices 4    # the sharded map on four GPUs
    python3 chip_smoke.py --rehearse     # CPU, small shapes: control flow only

One GPU, in one process:

1. the card (`nvidia-smi` name and power limit), JAX version and devices;
   fails unless JAX's platform is `gpu`;
2. parity at config2 widths (640x480, 512^3 block map, 4096 touched
   blocks): each plain op of the per-frame path, compiled for the GPU, is
   compared with the same function on the process's CPU device (the
   reference); each op prints its error beside its tolerance and why;
3. `compiled.memory_analysis()` of the config2 step;
4. config2 through `cli.main` (synthetic orbit, 60 frames, `--loops`):
   ATE RMSE below the preset's voxel size, no frame lost; then config3 with
   the packaged segmentation head: a non-empty instance table and voxels
   holding votes.

`--devices 4` runs only the config4 CLI path at 4 shards and the same
sequence on one device, and checks that trajectories and block counts
agree.  Every phase exits nonzero on failure; the last line of a passing
GPU run is `{"ok": true, "device": {"platform", "kind", "count"}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """`nvidia-smi` name and power limit of each card, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu(devices) -> None:
    """Refuse to report a result unless every device is a GPU."""
    platforms = sorted({d.platform for d in devices})
    check(platforms == ["gpu"], f"JAX platform is {platforms}, not gpu")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
    })


# --------------------------------------------------------------------------
# Phase 2: per-op parity, GPU vs the CPU device of the same process
# --------------------------------------------------------------------------


def _run_on(dev, fn, *args):
    import jax

    return jax.device_get(jax.jit(fn)(*jax.device_put(args, dev)))


def _report(name, err, tol, reason):
    ok = err <= tol
    print(f"parity {name}: {err:.3e} (tolerance {tol:.0e}: {reason})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"parity {name}: {err} > {tol}")


def _flip_frac(a, b, thresh):
    """Fraction of entries differing by more than `thresh`."""
    return float(np.mean(np.abs(np.asarray(a, np.float64) - b) > thresh))


def parity(cfg, gpu, cpu) -> None:
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.geometry.se3 import se3_inverse
    from instancefusion_tpu.models import segmentation as segm
    from instancefusion_tpu.ops import blocks, icp, labels, preprocess

    intr, tsdf = cfg.intrinsics, cfg.tsdf
    poses = synthetic.orbit_trajectory(8)
    fa = synthetic.render_frame(poses[0], intr)
    fb = synthetic.render_frame(poses[1], intr)
    print(f"parity inputs: {intr.width}x{intr.height} frames, "
          f"{tsdf.grid_size}^3 map, capacity {tsdf.table_capacity}, "
          f"{tsdf.touched_capacity} touched blocks x {tsdf.block_size ** 3} "
          "voxels", flush=True)

    def both(fn, *args):
        return _run_on(gpu, fn, *args), _run_on(cpu, fn, *args)

    # Preprocess pyramid (bilateral + vertex/normal maps, 3 levels).
    def pyramid(d, c):
        return preprocess.build_frame_pyramid(
            d, intr, cfg.preprocess, cfg.icp.levels,
            preprocess.rgb_to_intensity(c),
        )

    pg, pc = both(pyramid, fb.depth, fb.color)
    for key, tol, why in (
        ("depth", 1e-5, "f32 exp/divide ulps in the bilateral weights, m"),
        ("vmap", 1e-5, "backprojection of that depth, m"),
        ("nmap", 1e-3, "normalized cross product of vertex differences"),
    ):
        err = 0.0
        for g, c in zip(pg, pc):
            both_ok = g["valid"] & c["valid"]
            err = max(err, float(np.max(np.abs(g[key] - c[key])[both_ok])))
        _report(f"preprocess {key}", err, tol, why)
    mism = max(float(np.mean(g["valid"] != c["valid"])) for g, c in zip(pg, pc))
    _report("preprocess valid-mask mismatch", mism, 1e-4,
            "fraction of pixels on a validity threshold")

    # ICP association + normal-equation reduction at level 0 (source:
    # frame b's pyramid; target: frame a's maps in world coordinates).
    pa = _run_on(cpu, pyramid, fa.depth, fa.color)
    Ta = np.asarray(poses[0])
    tgt_v = (pa[0]["vmap"] @ Ta[:3, :3].T + Ta[:3, 3]).astype(np.float32)
    tgt_n = (pa[0]["nmap"] @ Ta[:3, :3].T).astype(np.float32)

    def assoc_reduce(vs, ns, vals, tv, tn, tval, T_est, T_tgt_cw):
        q, n, ok = icp.associate(vs, vals, tv, tn, tval, T_est, T_tgt_cw,
                                 intr, cfg.icp)
        return icp.reduce_equations(vs, ns, vals, q, n, ok, T_est, cfg.icp)

    src = pc[0]
    (Hg, bg, ng, _), (Hc, bc, nc, _) = both(
        assoc_reduce, src["vmap"], src["nmap"], src["valid"], tgt_v, tgt_n,
        pa[0]["valid"], poses[0], se3_inverse(poses[0]))
    _report("icp H (rel)", float(np.max(np.abs(Hg - Hc)) / np.max(np.abs(Hc))),
            1e-5, "f32 sums over 307k pixels in another order; TF32 would "
            "show ~1e-3")
    _report("icp b (rel)", float(np.max(np.abs(bg - bc)) / np.max(np.abs(bc))),
            1e-5, "as H")
    _report("icp inliers (rel)", abs(float(ng) - float(nc)) / float(nc), 1e-3,
            "pixels on an association rounding tie")

    # Integrate with colour into touched_capacity x 512 voxels: frame a
    # builds the map (on the GPU), frame b's blocks are allocated on it and
    # frame b is fused on both devices.
    k = min(tsdf.touched_capacity, blocks.num_blocks_per_axis(tsdf) ** 3)

    def frame_slots(bm, d, T):
        bm = blocks.discover_allocate(bm, d, T, intr, tsdf)
        s, v = blocks.frustum_slots(bm, T, intr, tsdf, cfg.raycast.near,
                                    cfg.raycast.far, k)
        return bm, s, v

    def integ_map(bm, s, v, d, c, T):
        return blocks.integrate_slots(bm, s, v, d, c, T, intr, tsdf)

    bm, slots, valid = _run_on(gpu, frame_slots, blocks.allocate(tsdf),
                               fa.depth, poses[0])
    bm = _run_on(gpu, integ_map, bm, slots, valid, fa.depth, fa.color,
                 poses[0])
    bm, slots, valid = _run_on(gpu, frame_slots, bm, fb.depth, poses[1])
    rows = np.asarray(valid)
    check(rows.sum() > 100, f"only {rows.sum()} touched blocks")
    print(f"parity integrate: {int(rows.sum())} blocks x "
          f"{tsdf.block_size ** 3} voxels", flush=True)

    def integ(bm, s, v, d, c, T):
        out = integ_map(bm, s, v, d, c, T)
        return out.sdf[s], out.weight[s], out.color[s]

    (sg, wg, cg), (sc, wc, cc) = both(
        integ, bm, slots, valid, fb.depth, fb.color, poses[1])
    for name, g, c in (("sdf", sg, sc), ("weight", wg, wc), ("color", cg, cc)):
        g, c = g[rows], c[rows]
        _report(f"integrate {name} flips", _flip_frac(g, c, 1e-4), 1e-4,
                "voxels whose projection rounds to another pixel")
        d = np.abs(g - c)
        _report(f"integrate {name}", float(np.max(d[d <= 1e-4], initial=0.0)),
                5e-5, "psi = (d - z) / trunc: one f32 ulp of z at 2-3 m is "
                "6e-6 trunc, averaged over weights")

    # The per-frame predictor: marched raycast with the depth prior.
    bm = _run_on(gpu, integ_map, bm, slots, valid, fb.depth, fb.color,
                 poses[1])

    def predict(bm, prior, T):
        return blocks.raycast(bm, T, intr, tsdf, cfg.raycast, with_color=True,
                              depth_prior=prior, screen_space_normals=True)

    rg, rcp = both(predict, bm, fb.depth, poses[1])
    both_ok = rg.valid & rcp.valid
    check(both_ok.sum() > 1000, f"only {both_ok.sum()} predicted pixels")
    dd = np.abs(rg.depth - rcp.depth)[both_ok]
    _report("raycast depth p99.9", float(np.percentile(dd, 99.9)), 1e-4,
            "trilinear samples + 6 secant refinements, m")
    _report("raycast depth max", float(np.max(dd)), tsdf.trunc,
            "a march step landing on the other side of a crossing, m")
    _report("raycast valid mismatch", float(np.mean(rg.valid != rcp.valid)),
            1e-3, "rays grazing a block or band edge")

    # Label vote (config3 widths: the same map, a VGA instance image).
    def vote(bm, gid, d, T):
        v = labels.fuse(labels.allocate(tsdf), bm, gid, d, T, intr, tsdf)
        return v.label, v.count

    (lg, cg2), (lc, cc2) = both(vote, bm, fb.instance, fb.depth, poses[1])
    voted = int(np.sum(cc2 > 0))
    check(voted > 1000, f"only {voted} voxels voted")
    _report("label vote mismatch", float(np.sum((lg != lc) | (cg2 != cc2)))
            / voted, 1e-3, "voxels whose projection rounds to another pixel")

    # Segmentation head on a VGA frame (convolutions may run in TF32 on
    # the GPU: the tolerance is on the decision, not on digits).
    params, _, _ = segm.load_pretrained()
    (sem_g, cen_g, _), (sem_c, cen_c, _) = both(
        segm.head_apply, params, fb.color)
    agree = float(np.mean(np.argmax(sem_g, -1) == np.argmax(sem_c, -1)))
    print(f"parity seg head logits max |diff| {np.max(np.abs(sem_g - sem_c)):.3e}"
          f", center {np.max(np.abs(cen_g - cen_c)):.3e}", flush=True)
    _report("seg head class disagreement", 1.0 - agree, 1e-2,
            "TF32 convolutions flip near-tied logits")


# --------------------------------------------------------------------------
# Phases 3-4: step memory, CLI runs
# --------------------------------------------------------------------------


def step_memory(cfg) -> None:
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import slam

    poses = synthetic.orbit_trajectory(2)
    f = synthetic.render_frame(poses[0], cfg.intrinsics)
    state = slam.init_state(cfg, poses[0])
    compiled = slam.step_donated.lower(cfg, state, f.depth, f.color).compile()
    print(f"config step memory_analysis: {compiled.memory_analysis()}",
          flush=True)


def run_cli(argv, tmp):
    """`cli.main` in process; returns (summary dict, per-frame metrics)."""
    from instancefusion_tpu import cli

    metrics = os.path.join(tmp, "metrics.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run", *argv, "--quiet", "--metrics-out", metrics])
    check(rc == 0, f"cli {argv} exited {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])["summary"]
    with open(metrics) as fh:
        frames = [json.loads(line) for line in fh]
    print(f"cli {' '.join(argv)}: {json.dumps(summary)}", flush=True)
    return summary, frames


def read_traj(path):
    return np.loadtxt(path)[:, 1:4]


def main_path(cfg2_voxel, small, card) -> None:
    plat = ["--platform", "cpu", "--small"] if small else []
    with tempfile.TemporaryDirectory() as tmp:
        s2, frames = run_cli(["--preset", "config2", "--dataset", "synthetic",
                              "--frames", "60", "--loops", *plat], tmp)
        lost = sum(not f["track_ok"] for f in frames)
        print(f"config2: ATE RMSE {s2['ate_rmse_m'] * 1000:.3f} mm (bound "
              f"{cfg2_voxel * 1000:.1f} mm, the voxel size), {lost} lost "
              f"frames; {s2['fps']:.2f} frames/s over the whole run, first "
              f"compilations included [{card}]", flush=True)
        bound = 0.04 if small else cfg2_voxel  # small camera: 4 cm voxels
        check(s2["ate_rmse_m"] < bound, f"config2 ATE {s2['ate_rmse_m']}")
        check(lost == 0, f"config2 lost {lost} frames")
        s3, _ = run_cli(["--preset", "config3", "--dataset", "synthetic",
                         "--frames", "24", "--instances", "--seg-head",
                         "trained", *plat], tmp)
        print(f"config3: {s3['instances']} instances, {s3['voted_voxels']} "
              "voxels holding votes", flush=True)
        check(s3["instances"] > 0, "config3 instance table is empty")
        check(s3["voted_voxels"] > 0, "config3 voted no voxels")


def sharded_path(small) -> None:
    """config4 at 4 shards vs the same sequence on one device."""
    plat = ["--platform", "cpu", "--small"] if small else []
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shards in (4, 1):
            traj = os.path.join(tmp, f"traj{shards}.txt")
            res[shards], _ = run_cli(
                ["--preset", "config4", "--dataset", "synthetic", "--frames",
                 "30", "--loops", "--shards", str(shards), "--export-traj",
                 traj, *plat], tmp)
            res[shards]["traj"] = read_traj(traj)
    dt = float(np.max(np.linalg.norm(res[4]["traj"] - res[1]["traj"], axis=1)))
    db = abs(res[4]["blocks"] - res[1]["blocks"]) / res[1]["blocks"]
    print(f"config4 4 shards vs 1 device: max trajectory difference "
          f"{dt * 1000:.3f} mm (tolerance 10 mm, half a 2 cm voxel); "
          f"blocks {res[4]['blocks']} vs {res[1]['blocks']} ({db:.4f}, "
          "tolerance 0.02: halo and seam allocation order)", flush=True)
    check(dt <= 0.01, "sharded trajectory diverged")
    check(db <= 0.02, "sharded block count diverged")
    for s in (4, 1):
        check(res[s]["ate_rmse_m"] < (0.08 if small else 0.02),
              f"config4 ({s} shards) ATE {res[s]['ate_rmse_m']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded config4 comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU at small shapes: checks control flow only and "
                         "prints no result")
    args = ap.parse_args(argv)
    if args.rehearse and args.devices == 4:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")

    import jax

    from instancefusion_tpu.config import PRESETS
    from instancefusion_tpu.utils.runtime import setup

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = setup("cpu" if args.rehearse else None)
    devices = jax.devices()
    print(f"jax {jax.__version__}; devices {devices}", flush=True)
    if not args.rehearse:
        require_gpu(devices)
    check(len(devices) >= args.devices,
          f"{args.devices} devices asked, {len(devices)} visible")

    if args.devices == 4:
        sharded_path(args.rehearse)
    else:
        cfg = PRESETS["config2"]()
        if args.rehearse:
            import dataclasses

            from instancefusion_tpu.config import TsdfConfig
            from instancefusion_tpu.geometry.camera import Intrinsics

            cfg = dataclasses.replace(
                cfg,
                intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5,
                                      width=160, height=120),
                tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                                origin=(-1.92, -1.92, -0.4),
                                table_capacity=2048, touched_capacity=512),
            )
        parity(cfg, dev, jax.devices("cpu")[0])
        step_memory(cfg)
        main_path(cfg.tsdf.voxel_size, args.rehearse, card)
    if args.rehearse:
        print("rehearsal passed (CPU; no result is reported)")
        return 0
    print(f"card: {card}", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
