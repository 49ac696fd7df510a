"""Command-line entry point.

Replaces the reference's Pangolin GUI app (`GUI/src/Main.cpp`,
`MainController` — expected layout, SURVEY.md §2 L7) with a headless CLI:
run a sequence (synthetic / TUM / ScanNet) through the engine, stream
per-frame JSONL metrics, and report ATE + throughput at the end.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="config1", help="config1..config5")
    p.add_argument(
        "--dataset",
        default="synthetic",
        help="'synthetic', or a path to a TUM-format sequence directory",
    )
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--small", action="store_true",
                   help="run the preset on a small test camera/volume")
    p.add_argument("--platform", default=None,
                   help="JAX platform to run on (e.g. cpu); by default the "
                        "run needs a GPU and fails without one")
    p.add_argument("--metrics-out", default=None, help="write JSONL metrics here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--loops", action="store_true", help="enable keyframes + loop closure")
    p.add_argument("--instances", action="store_true",
                   help="enable instance fusion (trained seg head by "
                        "default; see --seg-head)")
    p.add_argument("--seg-head", default="trained", choices=["trained", "gt"],
                   help="'trained' runs the packaged network "
                        "(models/weights); 'gt' feeds ground-truth masks "
                        "(synthetic only)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export-traj", default=None,
                   help="write the trajectory in TUM format here")
    p.add_argument("--export-mesh", default=None,
                   help="write the reconstructed mesh (PLY) here")
    p.add_argument("--export-instances", default=None,
                   help="directory for per-instance model PLYs "
                        "(instance_<id>.ply; needs --instances)")
    p.add_argument("--profile", default=None,
                   help="capture a jax.profiler trace (Perfetto/XProf) to this dir")
    p.add_argument("--stream-every", type=int, default=0,
                   help="active-window block streaming cadence (0 = off)")
    p.add_argument("--stream-radius", type=float, default=4.0,
                   help="active-window radius in meters (blocks beyond "
                        "stream to host DRAM)")
    p.add_argument("--clean-every", type=int, default=0,
                   help="map hygiene cadence (confidence culling, 0 = off)")
    p.add_argument("--gt-odometry", action="store_true",
                   help="bypass tracking: fuse at the dataset's ground-truth "
                        "poses (isolates the mapping pipeline)")
    p.add_argument("--local-loops", action="store_true",
                   help="active/inactive local loop closure (per-block "
                        "observation stamps; blocks map only)")
    p.add_argument("--local-every", type=int, default=3,
                   help="local-loop evidence poll cadence in frames")
    p.add_argument("--shards", type=int, default=0,
                   help="map shard count (0 = the preset's: configs 4/5 take "
                        "one shard per visible device; >1 runs the slab-"
                        "sharded engine on a 1-D device mesh)")
    p.add_argument("--reshard-every", type=int, default=0,
                   help="occupancy-rebalance poll cadence for the sharded "
                        "map (0 = off; fires on skew > --reshard-skew)")
    p.add_argument("--reshard-skew", type=float, default=1.5,
                   help="max/mean blocks-per-shard ratio that triggers an "
                        "all_to_all rebalance")
    p.add_argument("--sentinel", action="store_true",
                   help="enable the map-consistency drift sentinel (EWMA of "
                        "frame-to-frame vs frame-to-model disagreement; a "
                        "persistent alarm forces out-of-cadence loop-closure "
                        "keyframes)")
    p.add_argument("--sentinel-thresh", type=float, default=0.0012,
                   help="sentinel alarm threshold in meters (the default "
                        "splits clean vs map-dragging regimes on the "
                        "synthetic 512^3 rig)")


def cmd_run(args: argparse.Namespace) -> int:
    import jax

    if args.platform == "cpu" and args.shards > 1:
        # The sharded engine needs a device mesh; on the CPU platform fork
        # enough virtual devices.  Must run before the backend initializes.
        try:
            jax.config.update("jax_num_cpu_devices", args.shards)
        except RuntimeError:
            pass  # backend already up (e.g. env flags set the count)

    from instancefusion_tpu.utils.runtime import setup

    setup(args.platform)

    import numpy as np

    from instancefusion_tpu.config import PRESETS, resolve_shards
    from instancefusion_tpu.utils.ate import ate_rmse

    cfg = PRESETS[args.preset]()
    if args.small:
        # The preset's paths (map kind, shards, instances, predictor) on a
        # 160x120 camera and a 96^3 volume.
        import dataclasses

        from instancefusion_tpu.config import IcpConfig, TsdfConfig
        from instancefusion_tpu.geometry.camera import Intrinsics

        cfg = dataclasses.replace(
            cfg,
            intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120),
            tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                            origin=(-1.92, -1.92, -0.4), table_capacity=2048),
            icp=IcpConfig(iters=(10, 7, 7), min_valid=60, rgb_weight=0.0),
            raycast=dataclasses.replace(cfg.raycast, near=0.2, far=4.0),
        )

    cfg = resolve_shards(cfg, args.shards)
    if args.sentinel:
        import dataclasses as _dcs

        cfg = _dcs.replace(
            cfg, consistency_check=True,
            consistency_thresh=args.sentinel_thresh,
        )
    if args.dataset == "synthetic":
        from instancefusion_tpu.datasets import synthetic

        # Scale the synthetic room preset volume to the camera.
        poses = synthetic.orbit_trajectory(args.frames)
        frame_iter = (
            synthetic.render_frame(poses[i], cfg.intrinsics)
            for i in range(args.frames)
        )
        gt = np.asarray(poses)
        T0 = poses[0]
    else:
        import os

        if os.path.isdir(os.path.join(args.dataset, "intrinsic")):
            from instancefusion_tpu.datasets import scannet

            seq = scannet.ScanNetSequence(args.dataset)
            if seq.intrinsics is not None:
                import dataclasses as _dc2

                cfg = _dc2.replace(cfg, intrinsics=seq.intrinsics)
        else:
            from instancefusion_tpu.datasets import tum

            seq = tum.TumSequence(args.dataset, cfg.intrinsics)
        frame_iter = seq.frames(limit=args.frames or None)
        gt = seq.gt_poses(limit=args.frames or None)
        T0 = None if gt is None else gt[0]

    import dataclasses as _dc

    from instancefusion_tpu.engine import pipeline
    from instancefusion_tpu.utils.metrics import MetricsWriter

    if args.instances and not cfg.use_instances:
        cfg = _dc.replace(cfg, map_kind="blocks", use_instances=True)
    if args.local_loops:
        cfg = _dc.replace(cfg, map_kind="blocks", track_stamps=True)

    segment_fn = None
    if args.instances and args.seg_head == "trained":
        # The packaged trained network (models/weights, _train_seghead.py)
        # — the config-3 real path: head -> masks -> association -> votes.
        import jax as _jax

        from instancefusion_tpu.models import segmentation as _segm

        params, seg_nc, seg_w = _segm.load_pretrained()
        k = cfg.instances.max_instances
        _seg_jit = _jax.jit(
            lambda rgb: _segm.segment(params, rgb, seg_nc, k, seg_w)
        )

        def segment_fn(frame):
            return _seg_jit(frame.color)
    elif args.instances and args.dataset == "synthetic":
        import jax.numpy as jnp

        from instancefusion_tpu.models.segmentation import Segmentation

        k = cfg.instances.max_instances

        def segment_fn(frame):
            present = jnp.arange(k) < 4
            return Segmentation(
                mask_id=frame.instance,
                classes=jnp.where(present, jnp.arange(k, dtype=jnp.int32) + 1, 0),
                scores=jnp.where(present, 1.0, 0.0),
                valid=present,
            )

    metrics = MetricsWriter(args.metrics_out, echo=not args.quiet)
    import contextlib

    profile_cm = contextlib.nullcontext()
    if args.profile:
        import jax.profiler

        profile_cm = jax.profiler.trace(args.profile)
    with profile_cm:
        res = pipeline.run(
            cfg,
            frame_iter,
            T_init_wc=T0,
            segment_fn=segment_fn,
            metrics=metrics,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            enable_loops=args.loops,
            resume=args.resume,
            clean_every=args.clean_every,
            stream_every=args.stream_every,
            stream_radius=args.stream_radius,
            gt_odometry=np.asarray(gt) if (args.gt_odometry and gt is not None) else None,
            local_loops=args.local_loops,
            local_every=args.local_every,
            reshard_every=args.reshard_every,
            reshard_skew=args.reshard_skew,
        )
    metrics.close()

    if args.export_mesh:
        from instancefusion_tpu.utils import meshing

        has_color = getattr(res.state.volume, "color", None) is not None and \
            res.state.volume.color.size > 0
        if has_color:
            verts, tris, cols = meshing.extract_mesh(
                res.state.volume, cfg.tsdf, with_color=True
            )
            meshing.save_ply(args.export_mesh, verts, tris, colors=cols)
        else:
            verts, tris = meshing.extract_mesh(res.state.volume, cfg.tsdf)
            meshing.save_ply(args.export_mesh, verts, tris)

    if args.export_instances:
        import os

        from instancefusion_tpu.utils import meshing

        if res.state.votes is None:
            print("--export-instances needs --instances", file=sys.stderr)
        else:
            os.makedirs(args.export_instances, exist_ok=True)
            parts = meshing.extract_instance_meshes(
                res.state.volume, res.state.votes, cfg.tsdf
            )
            for gid, (v, t) in parts.items():
                meshing.save_ply(
                    os.path.join(args.export_instances, f"instance_{gid}.ply"),
                    v, t,
                )
            if not args.quiet:
                print(f"exported {len(parts)} instance models", file=sys.stderr)

    if args.export_traj:
        with open(args.export_traj, "w") as f:
            for i, T in enumerate(res.poses):
                # TUM format: t tx ty tz qx qy qz qw
                from instancefusion_tpu.utils.ate import rotmat_to_quat

                q = rotmat_to_quat(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{i / 30.0:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                )

    summary = {
        "frames": int(res.poses.shape[0]),
        "fps": res.fps,
        "keyframes": res.n_keyframes,
        "loop_closures": res.n_loops,
    }
    if cfg.map_kind == "blocks":
        summary["blocks"] = int(np.sum(np.asarray(res.state.volume.n_active)))
    if res.state.votes is not None:
        summary["instances"] = int(np.sum(np.asarray(res.state.table.active)))
        summary["voted_voxels"] = int(np.sum(np.asarray(res.state.votes.count) > 0))
    if gt is not None and len(res.poses) == len(gt):
        summary["ate_rmse_m"] = ate_rmse(res.poses, np.asarray(gt))
    print(json.dumps({"summary": summary}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ifusion", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run SLAM over a sequence")
    _add_run_args(runp)
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    parser.error(f"unknown command {args.cmd}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
