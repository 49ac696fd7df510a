"""Host-side orchestration: the full SLAM pipeline over a sequence.

Replaces the reference's `MainController` loop (SURVEY.md §4.1): per frame
it runs the jitted engine step, and at the configured cadences inserts
keyframes, queries the fern database for loop candidates, verifies them
with ICP, optimizes the pose graph, fuses instance segmentations, and
writes checkpoints.  The host only *sequences* jitted calls — every
numeric step stays on device.

Map consistency after a correction: the TSDF stays anchored where it was
integrated; the engine pose is shifted by the last-keyframe correction
(T_opt T_old^-1), so tracking continues in the corrected frame and new
geometry fuses consistently with the loop-closed trajectory.  cm-scale
drift corrections leave mm-scale smearing in already-fused blocks — the
same approximation class as the reference's deformation-graph warp, which
moves surfels but cannot unfuse their accumulated weights.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable

import jax
import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.config import EngineConfig
from instancefusion_tpu.engine import instances as inst  # noqa: F401 (re-export)
from instancefusion_tpu.engine import localloop as ll, posegraph as pg, slam
from instancefusion_tpu.geometry.se3 import se3_inverse
from instancefusion_tpu.ops import preprocess
from instancefusion_tpu.utils import checkpoint as ckpt
from instancefusion_tpu.utils.metrics import MetricsWriter, Timer

_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class PipelineResult:
    poses: np.ndarray  # (N,4,4) estimated trajectory
    n_keyframes: int
    n_loops: int
    fps: float
    state: Any
    backend: Any


def _optimize_after_loop(backend, cfg, kf_a, kf_b, T_rel, ba_terms_fn=None):
    """Graph correction after a verified loop (kf_a, kf_b, T_rel).

    With `use_landmark_ba` (the default) this first samples paired
    landmark observations across the loop pair into the backend bank
    (pg.build_loop_landmarks — the BAObservations producer of SURVEY.md
    §4.6) and runs the joint pose-graph + landmark Schur solve;
    `ba_terms_fn` injects the psum-sharded reducer on a mesh.  Otherwise
    it runs pose-graph GN alone.
    """
    pgc = cfg.posegraph
    if pgc.use_landmark_ba:
        pts, obs = pg.build_loop_landmarks(
            backend, kf_a, kf_b, T_rel, cfg.intrinsics, cfg
        )
        backend = pg.add_loop_landmarks(backend, pts, obs)
        return pg.optimize_landmark(backend, pgc, ba_terms_fn)
    return pg.optimize(backend, pgc)


def run(
    cfg: EngineConfig,
    frames: Iterable,
    T_init_wc=None,
    segment_fn: Callable | None = None,
    metrics: MetricsWriter | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 200,
    enable_loops: bool = True,
    resume: bool = False,
    relocalize_after: int = 5,
    clean_every: int = 0,
    retire_every: int = 0,
    stream_every: int = 0,
    stream_radius: float = 4.0,
    gt_odometry=None,
    local_loops: bool = False,
    local_every: int = 3,
    local_min_blocks: int = 24,
    reshard_every: int = 0,
    reshard_skew: float = 1.5,
) -> PipelineResult:
    """Run the full pipeline over `frames` (iterable of dataset Frames).

    `segment_fn(frame) -> Segmentation | None` supplies instance masks
    (network head, ground truth, or None to disable).  It is invoked at
    the `cfg.instances.seg_every` cadence and its result is consumed ONE
    frame later without ever fetching in between — the head's device work
    overlaps the intervening tracking/fusion (the reference's
    asynchronous Mask R-CNN thread, SURVEY §4.5/§3.2).
    """
    # Engine selection (SURVEY §0.1 configs 4/5): num_shards > 1 routes the
    # map work through the slab-sharded engine on a device mesh; the host
    # orchestration below (keyframes, fern loops, relocalization, landmark
    # BA) is engine-agnostic — it only consumes the replicated prediction
    # maps and poses, which both engines expose identically.
    sharded = cfg.num_shards > 1
    ba_terms_fn = None
    if sharded:
        from instancefusion_tpu.engine import slam_sharded
        from instancefusion_tpu.parallel import mesh as meshmod
        from instancefusion_tpu.parallel import shard as shardmod

        if cfg.map_kind != "blocks":
            raise ValueError("num_shards > 1 requires map_kind='blocks'")
        if local_loops or cfg.track_stamps:
            raise ValueError(
                "active/inactive local loops are a single-shard feature"
            )
        if cfg.posegraph.max_landmarks % cfg.num_shards:
            raise ValueError("max_landmarks must divide num_shards")
        mesh = meshmod.make_mesh(cfg.num_shards)
        state = slam_sharded.init_state(cfg, mesh, T_init_wc)
        _step = slam_sharded.make_step(cfg, mesh, donate=True)
        _step_gt = (
            slam_sharded.make_step_gt(cfg, mesh, donate=True)
            if gt_odometry is not None else None
        )
        _fuse_seg = (
            slam_sharded.make_fuse_segmentation(cfg, mesh, donate=True)
            if (cfg.use_instances and segment_fn is not None) else None
        )
        ba_terms_fn = shardmod.sharded_paired_terms(mesh)

        def _rerender(volume, T):
            return shardmod.raycast(
                volume, T, mesh, cfg.intrinsics, cfg.tsdf, cfg.raycast,
                with_color=cfg.use_color,
            )
    else:
        state = slam.init_state(cfg, T_init_wc)
        _step = lambda st, d, c: slam.step_donated(cfg, st, d, c)  # noqa: E731
        _step_gt = lambda st, d, c, T: slam.step_gt_donated(cfg, st, d, c, T)  # noqa: E731
        _fuse_seg = lambda st, s, d, T: slam.fuse_segmentation_donated(cfg, st, s, d, T)  # noqa: E731

        def _rerender(volume, T):
            return slam._map_ops(cfg).raycast(
                volume, T, cfg.intrinsics, cfg.tsdf, cfg.raycast,
                with_color=cfg.use_color,
            )

    backend = pg.allocate(cfg)
    # Map anchor: world-from-map.  The engine tracks and fuses in the MAP
    # frame; loop-closure corrections re-anchor the WHOLE map by updating
    # this one transform — the voxels never move, the engine pose never
    # jumps, and tracking stays self-consistent (the reference's
    # deformation graph warps every surfel instead; a rigid anchor is the
    # exact sparse-map analog for corrections dominated by accumulated
    # rigid drift).  World pose of frame k = T_wm @ T_mc(k).
    T_wm = jnp.eye(4, dtype=jnp.float32)
    start_frame = 0
    if resume and checkpoint_dir:
        try:
            (state, backend, T_wm), start_frame = ckpt.restore(
                checkpoint_dir, (state, backend, T_wm), cfg
            )
        except FileNotFoundError:
            pass

    streamer = None
    if stream_every and cfg.map_kind == "blocks":
        if sharded:
            from instancefusion_tpu.engine.streaming import ShardedBlockStreamer

            streamer = ShardedBlockStreamer(
                cfg.tsdf, mesh, radius=stream_radius,
                with_color=cfg.use_color, with_votes=cfg.use_instances,
            )
        else:
            from instancefusion_tpu.engine.streaming import BlockStreamer

            streamer = BlockStreamer(
                cfg.tsdf, radius=stream_radius,
                with_color=cfg.use_color, with_votes=cfg.use_instances,
                with_stamps=cfg.track_stamps,
            )
        if resume and checkpoint_dir and start_frame:
            # Evicted blocks live ONLY in the host store (device XOR
            # store) — restore it with the device state or they are gone.
            spath = os.path.join(
                checkpoint_dir, f"step_{start_frame}.streamer.npz"
            )
            if os.path.exists(spath):
                streamer.load(spath)

    pgc = cfg.posegraph
    est: list[np.ndarray] = []
    timer = Timer()
    n_loops = 0
    local_fails = 0
    # Map-consistency sentinel streak (cfg.consistency_check): persistent
    # alarms mean the map is dragging the solver — force out-of-cadence
    # keyframe/loop-closure attempts (see the force_kf policy below).
    drift_streak = 0
    # In-flight (device-async) segmentation result: (seg, depth, T_mc).
    pending_seg = None
    t0 = time.perf_counter()
    i = start_frame - 1

    for i, frame in enumerate(frames):
        if i < start_frame:
            continue
        # Failure recovery (SURVEY §6): after `relocalize_after` consecutive
        # tracking failures the pose is likely gone — query the fern
        # database with the raw frame, verify against the retrieved
        # keyframe by ICP, and re-seat the pose there.  The reference
        # recovers only implicitly via its fern loop closures; this makes
        # the same machinery an explicit relocalization mode.
        relocalized = False
        if (
            enable_loops
            and relocalize_after > 0
            and int(state.lost_frames) >= relocalize_after
            and int(backend.kf.count) > 0
        ):
            with timer.phase("relocalize"):
                d = preprocess.clamp_depth(frame.depth, cfg.preprocess)
                pyr = preprocess.build_frame_pyramid(d, cfg.intrinsics, cfg.preprocess, 1)
                cand, diss = pg.detect_loop(
                    backend, frame.color, frame.depth, min_gap=0
                )
                if float(diss) < 2 * pgc.loop_dist_thresh:
                    T_cand = backend.kf.poses[cand]
                    T_rel, inliers, ok = pg.verify_loop(
                        backend, cand, pyr[0]["vmap"], pyr[0]["nmap"],
                        cfg.intrinsics, cfg, T_cur_wc=T_cand,
                    )
                    if bool(ok):
                        # Keyframe poses are world-frame; re-seat the
                        # engine in the map frame.
                        T_new = jnp.matmul(
                            se3_inverse(T_wm),
                            jnp.matmul(T_cand, T_rel, precision=_PREC),
                            precision=_PREC,
                        )
                        if streamer is not None:
                            # The re-seated view may cover streamed-out
                            # geometry — admit the window there first.
                            volume, votes, stamp, _ = streamer.tick(
                                state.volume, state.votes, T_new,
                                getattr(state, "stamp", None),
                            )
                            state = state._replace(volume=volume, votes=votes)
                            if stamp is not None:
                                state = state._replace(stamp=stamp)
                        # Re-render the model prediction from the re-seated
                        # pose: the stale prediction views the wrong part of
                        # the map and would starve the next ICP of
                        # associations.
                        pred = _rerender(state.volume, T_new)
                        # No map-based "polish" here on purpose: the
                        # verify-vs-keyframe ICP ran against raw (undrifted)
                        # sensor geometry and is the most accurate estimate
                        # available; refining against the map prediction
                        # would re-absorb whatever drift got fused into the
                        # map around the revisited view.
                        # _unalias: T_new lands in three leaves, which the
                        # next donated step could not donate (shared buffer).
                        state = slam._unalias_pytree(
                            state._replace(
                                T_wc=T_new,
                                pred=pred,
                                pred_T_wc=T_new,
                                T_prev_wc=T_new,  # zero the velocity model
                                lost_frames=jnp.zeros((), jnp.int32),
                            )
                        )
                        if getattr(state, "drift_ewma", None) is not None:
                            # The re-seat invalidates the accumulated
                            # disagreement — restart the sentinel clean.
                            state = state._replace(
                                drift_ewma=jnp.zeros((3,), jnp.float32)
                            )
                        drift_streak = 0
                        relocalized = True

        # Asynchronous segmentation overlap (SURVEY §3.2 "Pipeline
        # overlap" — the reference's Mask R-CNN thread): a result
        # dispatched on an earlier frame is consumed now, against ITS OWN
        # depth and pose; the head's device work overlapped with the
        # intervening tracking/fusion steps because JAX dispatch is
        # asynchronous and nothing fetched it.
        if pending_seg is not None:
            with timer.phase("seg_fuse"):
                state = _fuse_seg(state, *pending_seg)
                pending_seg = None
        with timer.phase("step"):
            # Donated variants: the previous frame's state buffers are
            # rebound every iteration, so XLA may update the block payload
            # in place instead of copying it (see slam.step_donated).
            if gt_odometry is not None:
                # Tracking bypass (the reference's GroundTruthOdometry):
                # fuse at the dataset pose, isolating the mapping pipeline.
                state, info = _step_gt(
                    state, frame.depth, frame.color,
                    jnp.matmul(
                        se3_inverse(T_wm),
                        jnp.asarray(gt_odometry[i], jnp.float32),
                        precision=_PREC,
                    ),
                )
            else:
                state, info = _step(state, frame.depth, frame.color)
        if relocalized:
            # The first post-relocalization solve is itself a correction
            # (the re-seat is only keyframe-accurate); extrapolating it
            # as "velocity" walks the next frame away from a static view
            # (measured: 113 mm on the blackout-recovery rig).  Zero the
            # motion model for one more frame.
            state = slam._unalias_pytree(
                state._replace(T_prev_wc=state.T_wc)
            )
        if info.drift_alarm is not None:
            drift_streak = drift_streak + 1 if bool(info.drift_alarm) else 0
        # Dispatch the segmentation head at the configured cadence
        # (InstanceConfig.seg_every) without fetching the result.
        seg_dispatched = False
        if (
            segment_fn is not None
            and cfg.use_instances
            and i % max(cfg.instances.seg_every, 1) == 0
            and bool(info.track_ok)
        ):
            with timer.phase("seg_dispatch"):
                seg = segment_fn(frame)
            if seg is not None:
                # Copy the pose: the captured buffer must survive the next
                # step's state donation (f(donate(state), state.T_wc) would
                # use a donated buffer).
                pending_seg = (seg, frame.depth, state.T_wc.copy())
                seg_dispatched = True

        # Local (active/inactive) loop closure: when the engine starts
        # fusing into blocks unseen for > local_window frames, register
        # the current frame against the inactive model view and pull the
        # engine back onto the old geometry (engine/localloop.py — the
        # reference's per-frame active-vs-inactive registration).
        local_closed = False
        n_evidence = 0
        if (
            local_loops
            and cfg.track_stamps
            and cfg.map_kind == "blocks"
            and (i + 1) % local_every == 0
            and bool(info.track_ok)
        ):
            n_evidence = int(ll.evidence_count(cfg, state))
            if n_evidence >= local_min_blocks:
                with timer.phase("localloop"):
                    d = preprocess.clamp_depth(frame.depth, cfg.preprocess)
                    pyr = preprocess.build_frame_pyramid(
                        d, cfg.intrinsics, cfg.preprocess, 1
                    )
                    res = ll.attempt(
                        cfg, state, pyr[0]["vmap"], pyr[0]["nmap"],
                        pyr[0]["valid"],
                    )
                    if bool(res.ok):
                        T_corr = res.T_corr_wc
                        T_world_corr = jnp.matmul(T_wm, T_corr, precision=_PREC)
                        # Pose-graph constraint: loop edge from the nearest
                        # old keyframe to a keyframe inserted at the
                        # corrected pose.
                        nkf = int(backend.kf.count)
                        if nkf > 2:
                            poses_np = np.asarray(backend.kf.poses[:nkf])
                            dists = np.linalg.norm(
                                poses_np[: nkf - 2, :3, 3]
                                - np.asarray(T_world_corr[:3, 3]),
                                axis=-1,
                            )
                            anchor = int(np.argmin(dists))
                            backend = pg.add_keyframe(
                                backend, T_world_corr, frame.color,
                                frame.depth, pyr[0]["vmap"], pyr[0]["nmap"],
                            )
                            kf_cur = backend.kf.count - 1
                            T_rel = jnp.matmul(
                                se3_inverse(backend.kf.poses[anchor]),
                                T_world_corr, precision=_PREC,
                            )
                            backend = pg.add_loop_edge(
                                backend, anchor, kf_cur, T_rel
                            )
                            T_before = backend.kf.poses[kf_cur]
                            backend, _ = _optimize_after_loop(
                                backend, cfg, anchor, kf_cur, T_rel
                            )
                            corr = jnp.matmul(
                                backend.kf.poses[kf_cur],
                                se3_inverse(T_before), precision=_PREC,
                            )
                            T_wm = jnp.matmul(corr, T_wm, precision=_PREC)
                        # Re-seat the engine on the inactive (old) geometry
                        # and re-render the prediction from there.
                        pred = _rerender(state.volume, T_corr)
                        state = slam._unalias_pytree(
                            state._replace(
                                T_wc=T_corr, pred=pred, pred_T_wc=T_corr,
                                T_prev_wc=T_corr,
                                stamp=ll.reset_gaps(
                                    state.stamp, pgc.local_window
                                ),
                            )
                        )
                        n_loops += 1
                        local_closed = True
                        local_fails = 0
                    else:
                        local_fails += 1
                        if local_fails >= 5:
                            # Evidence keeps failing to register (e.g. too
                            # little overlap) — consume it and re-arm.
                            state = state._replace(
                                stamp=ll.reset_gaps(
                                    state.stamp, pgc.local_window
                                )
                            )
                            local_fails = 0

        # Keyframes only from frames that tracked (a lost frame would
        # poison the fern database and the odometry chain).
        #
        # A persistent map-consistency alarm (the sentinel integrating a
        # directional f2f/f2m disagreement — the map is dragging the
        # solver) forces an out-of-cadence keyframe + loop attempt: the
        # pose-graph + landmark-BA machinery is what arrests
        # map-feedback drift (measured on the SWEEP=1.6 rig: 19.5 mm
        # mean with loops vs 50-100 mm bare engine).  Hard fern
        # relocalization is NOT the right response while tracking is
        # still healthy — re-seating against a low-overlap retrieved
        # keyframe mid-sweep measured 655 mm mean on the same rig; it
        # stays reserved for genuinely lost tracking above.
        force_kf = drift_streak >= max(3 * relocalize_after, 15)
        is_kf = (
            enable_loops
            and (i % pgc.keyframe_every == 0 or force_kf)
            and bool(info.track_ok)
        )
        closed = False
        if is_kf:
            with timer.phase("keyframe"):
                d = preprocess.clamp_depth(frame.depth, cfg.preprocess)
                pyr = preprocess.build_frame_pyramid(d, cfg.intrinsics, cfg.preprocess, 1)
                vmap, nmap = pyr[0]["vmap"], pyr[0]["nmap"]
                T_world = jnp.matmul(T_wm, state.T_wc, precision=_PREC)
                backend = pg.add_keyframe(
                    backend, T_world, frame.color, frame.depth, vmap, nmap
                )
                cand, diss = pg.detect_loop(backend, frame.color, frame.depth)
                if float(diss) < pgc.loop_dist_thresh:
                    T_rel, inliers, ok = pg.verify_loop(
                        backend, cand, vmap, nmap, cfg.intrinsics, cfg,
                        T_cur_wc=T_world,
                    )
                    if bool(ok):
                        kf_cur = backend.kf.count - 1
                        backend = pg.add_loop_edge(backend, cand, kf_cur, T_rel)
                        T_before = backend.kf.poses[kf_cur]
                        backend, cost = _optimize_after_loop(
                            backend, cfg, cand, kf_cur, T_rel, ba_terms_fn
                        )
                        # Re-anchor the MAP: the engine state (map frame)
                        # is untouched — no pose jump against the fused
                        # geometry, no smear; only world-from-map moves.
                        corr = jnp.matmul(
                            backend.kf.poses[kf_cur], se3_inverse(T_before),
                            precision=_PREC,
                        )
                        T_wm = jnp.matmul(corr, T_wm, precision=_PREC)
                        n_loops += 1
                        closed = True
            if force_kf:
                # Re-arm: the next forced attempt needs a fresh
                # persistent streak, not one more alarmed frame.
                drift_streak = 0

        # Map hygiene at low cadence: confidence culling + slot compaction
        # (GlobalModel::clean analog) and instance-table retirement.
        if (
            clean_every
            and cfg.map_kind == "blocks"
            and (i + 1) % clean_every == 0
        ):
            if sharded:
                volume, votes = shardmod.clean(
                    state.volume, mesh, cfg.tsdf, min_weight=1.0,
                    votes=state.votes,
                )
                state = state._replace(volume=volume, votes=votes)
            else:
                from instancefusion_tpu.ops import blocks as blk

                out = blk.clean(
                    state.volume, cfg.tsdf, min_weight=1.0, votes=state.votes,
                    stamp=state.stamp,
                )
                if state.stamp is not None:
                    volume, votes, stamp = out
                    state = state._replace(
                        volume=volume, votes=votes, stamp=stamp
                    )
                else:
                    volume, votes = out
                    state = state._replace(volume=volume, votes=votes)
        if (
            retire_every
            and cfg.use_instances
            and (i + 1) % retire_every == 0
        ):
            state = state._replace(
                table=inst.retire_stale(state.table, cfg.instances)
            )
        stream_stats = {}
        if streamer is not None and (i + 1) % stream_every == 0:
            with timer.phase("stream"):
                volume, votes, stamp, stream_stats = streamer.tick(
                    state.volume, state.votes, state.T_wc,
                    getattr(state, "stamp", None),
                )
                state = state._replace(volume=volume, votes=votes)
                if stamp is not None:
                    state = state._replace(stamp=stamp)

        # Occupancy-rebalance policy (SURVEY §3.2 "all_to_all for block
        # re-sharding"): when per-shard occupancy skews — the camera
        # dwelling in one shard's slab — recompute occupancy-balanced
        # slab cuts from the replicated directory and drain the rows to
        # their new owners.  Also fires right after a loop closure or
        # relocalization (the trajectory re-anchors where the camera
        # will fuse next).
        reshard_migrated = 0
        if (
            sharded
            and reshard_every
            and ((i + 1) % reshard_every == 0 or closed or relocalized)
        ):
            counts = np.asarray(state.volume.n_active)
            if counts.max() > reshard_skew * max(counts.mean(), 1.0):
                with timer.phase("reshard"):
                    vol = state.volume._replace(
                        cuts=shardmod.balanced_cuts(
                            state.volume.directory, cfg.tsdf, cfg.num_shards
                        )
                    )
                    votes_r = state.votes
                    for _ in range(8):
                        vol, votes_r, migrated, leftover = shardmod.reshard(
                            vol, mesh, cfg.tsdf, votes=votes_r
                        )
                        reshard_migrated += int(migrated.sum())
                        if int(leftover.sum()) == 0:
                            break
                    state = slam._unalias_pytree(
                        state._replace(volume=vol, votes=votes_r)
                    )

        est.append(np.asarray(jnp.matmul(T_wm, state.T_wc, precision=_PREC)))
        if metrics is not None:
            metrics.write(
                {
                    "frame": i,
                    "inliers": float(info.inliers),
                    "residual_m": float(info.residual),
                    "track_ok": bool(info.track_ok),
                    "keyframe": bool(is_kf),
                    "loop_closed": closed,
                    "local_loop_closed": local_closed,
                    "local_evidence": n_evidence,
                    "relocalized": relocalized,
                    "seg_dispatched": seg_dispatched,
                    "lost_frames": int(state.lost_frames),
                    "reshard_migrated": reshard_migrated,
                    **(
                        {
                            "drift_ewma_mm": round(
                                float(info.drift_ewma) * 1000, 3
                            ),
                            "drift_alarm": bool(info.drift_alarm),
                        }
                        if info.drift_alarm is not None else {}
                    ),
                    **stream_stats,
                    **{f"t_{k}_ms": round(v, 2) for k, v in timer.times_ms.items()},
                }
            )
            timer.times_ms.clear()

        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            jax.block_until_ready((state, backend, T_wm))
            ckpt.save(checkpoint_dir, (state, backend, T_wm), cfg, i + 1)
            if streamer is not None:
                streamer.save(os.path.join(
                    checkpoint_dir, f"step_{i + 1}.streamer.npz"
                ))

    # Flush the last in-flight segmentation so its votes are not lost.
    if pending_seg is not None:
        state = _fuse_seg(state, *pending_seg)
    jax.block_until_ready(state.T_wc)
    elapsed = time.perf_counter() - t0
    n = len(est)
    return PipelineResult(
        poses=np.stack(est) if est else np.zeros((0, 4, 4)),
        n_keyframes=int(backend.kf.count),
        n_loops=n_loops,
        fps=n / max(elapsed, 1e-9),
        state=state,
        backend=backend,
    )
