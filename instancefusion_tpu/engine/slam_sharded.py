"""Sharded SLAM engine: the per-frame step over a device mesh (configs 4/5).

Same track -> fuse -> predict structure as engine/slam.py, with the map
ops routed through parallel/shard.py: integrate updates each shard's own
payload rows (zero communication), raycast halo-exchanges slab boundaries
and pmin-composites the predicted maps, and the composited (replicated)
maps feed the same ICP as the single-device engine.  The frame is
replicated — the map, not the sequence, is the long axis (SURVEY.md §6).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from instancefusion_tpu.config import EngineConfig
from instancefusion_tpu.engine.slam import StepInfo, _motion_seed, tsdf_integrate_count
from instancefusion_tpu.ops import icp, preprocess, raycast as rc
from instancefusion_tpu.parallel import shard
from instancefusion_tpu.parallel.mesh import SHARD_AXIS


class ShardedSlamState(NamedTuple):
    T_wc: jnp.ndarray
    volume: shard.ShardedBlockMap
    pred: rc.RaycastMaps
    pred_T_wc: jnp.ndarray
    frame_idx: jnp.ndarray
    lost_frames: jnp.ndarray
    # Previous frame's pose (constant-velocity ICP seed — engine/slam.py).
    T_prev_wc: jnp.ndarray = None
    # Instance subsystem (cfg.use_instances): votes shard with the block
    # payloads; the instance table is replicated (it is tiny and updated
    # from replicated images).
    votes: object = None
    table: object = None


def init_state(cfg: EngineConfig, mesh: Mesh, T_init_wc=None) -> ShardedSlamState:
    intr = cfg.intrinsics
    h, w = intr.height, intr.width
    num_shards = mesh.shape[SHARD_AXIS]
    volume = shard.allocate(cfg.tsdf, num_shards, with_color=cfg.use_color)
    pred = rc.RaycastMaps(
        vertex_w=jnp.zeros((h, w, 3), jnp.float32),
        normal_w=jnp.zeros((h, w, 3), jnp.float32),
        depth=jnp.zeros((h, w), jnp.float32),
        color=jnp.zeros((h, w, 3), jnp.float32),
        valid=jnp.zeros((h, w), bool),
    )
    T0 = jnp.eye(4, dtype=jnp.float32) if T_init_wc is None else T_init_wc
    votes = table = None
    if cfg.use_instances:
        from instancefusion_tpu.engine import instances as inst

        votes = shard.allocate_votes(cfg.tsdf, num_shards)
        table = inst.allocate(cfg.instances)
    from instancefusion_tpu.engine.slam import _unalias_pytree

    return _unalias_pytree(ShardedSlamState(
        T_wc=T0,
        volume=volume,
        pred=pred,
        pred_T_wc=T0,
        frame_idx=jnp.zeros((), jnp.int32),
        lost_frames=jnp.zeros((), jnp.int32),
        T_prev_wc=T0,
        votes=votes,
        table=table,
    ))


def _map_update(cfg: EngineConfig, mesh: Mesh, state, depth_masked, color, T_new):
    """Shared fuse+predict: splat path (use_splat) or the marched path."""
    intr = cfg.intrinsics
    if cfg.raycast.use_splat:
        prior = jnp.where(depth_masked > 0.0, depth_masked, state.pred.depth)
        pred_color = cfg.use_color and (
            cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
        )
        return shard.fused_step_map(
            state.volume, depth_masked,
            color if cfg.use_color else None,
            prior, T_new, mesh, intr, cfg.tsdf, cfg.raycast,
            pred_color=pred_color,
        )
    volume = shard.integrate(
        state.volume, depth_masked,
        color if cfg.use_color else None,
        T_new, mesh, intr, cfg.tsdf,
    )
    # The single-device engine's per-frame fast paths (slam.step).
    prior = None
    if cfg.raycast.use_depth_prior:
        prior = jnp.where(depth_masked > 0.0, depth_masked, state.pred.depth)
    pred = shard.raycast(
        volume, T_new, mesh, intr, cfg.tsdf, cfg.raycast,
        with_color=cfg.use_color, depth_prior=prior,
        screen_space_normals=cfg.raycast.screen_space_normals,
    )
    return volume, pred


def _donated(step):
    """Donate the input state; unalias the pose trio (slam._make_donated)."""

    def wrapper(state, *args):
        new_state, info = step(state, *args)
        t_wc, t_pred, t_prev = jax.lax.optimization_barrier(
            (new_state.T_wc, new_state.pred_T_wc, new_state.T_prev_wc)
        )
        return (
            new_state._replace(T_wc=t_wc, pred_T_wc=t_pred, T_prev_wc=t_prev),
            info,
        )

    return jax.jit(wrapper, donate_argnums=(0,))


def _step_fn(cfg: EngineConfig, mesh: Mesh):
    """The raw (untraced) sharded step closure shared by make_step and
    make_run_chunk."""
    intr = cfg.intrinsics

    def step(state: ShardedSlamState, depth, color):
        intensity = preprocess.rgb_to_intensity(color) if cfg.use_color else None
        pyr = preprocess.build_frame_pyramid(
            depth, intr, cfg.preprocess, cfg.icp.levels, intensity
        )
        pred_intensity = (
            preprocess.rgb_to_intensity(state.pred.color) if cfg.use_color else None
        )
        T_seed = _motion_seed(state.T_wc, state.T_prev_wc, cfg.icp.vel_seed)
        result = icp.track(
            pyr,
            state.pred.vertex_w,
            state.pred.normal_w,
            state.pred.valid,
            T_seed,
            state.pred_T_wc,
            intr,
            cfg.icp,
            pred_intensity=pred_intensity,
            )
        first = state.frame_idx == 0
        fuse_ok = result.valid | first
        T_new = jnp.where(result.valid, result.T_wc, state.T_wc)

        d0 = pyr[0]["depth"]
        fused = jnp.where(fuse_ok, tsdf_integrate_count(d0), 0.0)
        depth_masked = jnp.where(fuse_ok, d0, jnp.zeros_like(d0))
        volume, pred = _map_update(cfg, mesh, state, depth_masked, color, T_new)
        new_state = state._replace(
            T_wc=T_new,
            volume=volume,
            pred=pred,
            pred_T_wc=T_new,
            frame_idx=state.frame_idx + 1,
            lost_frames=jnp.where(result.valid | first, 0, state.lost_frames + 1).astype(
                jnp.int32
            ),
            T_prev_wc=jnp.where(result.valid, state.T_wc, T_new),
        )
        info = StepInfo(
            inliers=result.inliers,
            residual=result.residual,
            track_ok=result.valid | first,
            fused_voxels=fused,
        )
        return new_state, info

    return step


def make_step(cfg: EngineConfig, mesh: Mesh, donate: bool = False):
    """Build the jitted sharded step for (cfg, mesh).

    The mesh is closed over (it is not a pytree); the returned function
    has the same signature/behavior as engine/slam.step.  With
    `cfg.raycast.use_splat` the map work runs the splat path
    (shard.fused_step_map — list-based allocation, slot-addressed
    integrate, per-shard splat prediction composited exactly by psum);
    without it the marched path (shard.integrate + shard.raycast, halo
    exchange at slab seams) runs.
    `donate=True` donates the input state (sequential drivers rebind it
    every frame, letting XLA update the sharded payload in place).
    """
    step = _step_fn(cfg, mesh)
    return _donated(step) if donate else jax.jit(step)


def make_run_chunk(cfg: EngineConfig, mesh: Mesh):
    """Sharded chunked replay: `step` over K staged frames in ONE
    dispatch (`lax.scan`), the sharded analog of engine/slam.run_chunk.

    Per-frame host dispatch is the residual gap between the sharded and
    single-chip engines once the shard bodies run the same group kernels
    (~0.94x measured at the graded config); offline-log replay amortizes
    it across the chunk.  Signature: (state, depths (K,H,W), colors
    (K,H,W,3)) -> (state, stacked StepInfo).  The input state is donated
    — rebind it.
    """
    step = _step_fn(cfg, mesh)

    def run_chunk(state, depths, colors):
        def body(st, frame):
            d, c = frame
            return step(st, d, c)

        new_state, infos = jax.lax.scan(body, state, (depths, colors))
        t_wc, t_pred, t_prev = jax.lax.optimization_barrier(
            (new_state.T_wc, new_state.pred_T_wc, new_state.T_prev_wc)
        )
        return (
            new_state._replace(T_wc=t_wc, pred_T_wc=t_pred, T_prev_wc=t_prev),
            infos,
        )

    return jax.jit(run_chunk, donate_argnums=(0,))


def make_step_gt(cfg: EngineConfig, mesh: Mesh, donate: bool = False):
    """Sharded tracking bypass: fuse+predict at an external pose.

    The sharded analog of engine/slam.step_gt (the reference's
    GroundTruthOdometry mode) — signature (state, depth, color, T_gt_wc).
    """
    intr = cfg.intrinsics

    def step_gt(state: ShardedSlamState, depth, color, T_gt_wc):
        pyr = preprocess.build_frame_pyramid(depth, intr, cfg.preprocess, 1)
        d0 = pyr[0]["depth"]
        fused = tsdf_integrate_count(d0)
        volume, pred = _map_update(cfg, mesh, state, d0, color, T_gt_wc)
        new_state = state._replace(
            T_wc=T_gt_wc,
            volume=volume,
            pred=pred,
            pred_T_wc=T_gt_wc,
            frame_idx=state.frame_idx + 1,
            lost_frames=jnp.zeros((), jnp.int32),
            T_prev_wc=state.T_wc,
        )
        info = StepInfo(
            inliers=jnp.zeros(()),
            residual=jnp.zeros(()),
            track_ok=jnp.ones((), bool),
            fused_voxels=fused,
        )
        return new_state, info

    return _donated(step_gt) if donate else jax.jit(step_gt)


def make_step_seg(cfg: EngineConfig, mesh: Mesh, donate: bool = False):
    """Sharded `step` + distributed instance fusion (engine/slam.step_seg).

    The per-voxel votes shard with the block payloads (zero-communication
    voting into owned rows); the predicted instance-id image composites
    with one `pmax`; the instance table stays replicated — it is updated
    from replicated images by the same associate() as the single-device
    engine, so every shard computes the identical table.
    """
    assert cfg.use_instances, "make_step_seg requires cfg.use_instances"
    from instancefusion_tpu.engine import instances as inst
    from instancefusion_tpu.ops import labels

    base = make_step(cfg, mesh)
    intr = cfg.intrinsics

    def step_seg(state: ShardedSlamState, depth, color, seg):
        new_state, info = base(state, depth, color)
        mask_id = labels.refine_mask_edges(seg.mask_id, depth, intr=intr)
        seg_r = seg._replace(mask_id=mask_id)
        pred_gid = shard.sample_labels(
            new_state.votes, new_state.volume,
            new_state.pred.vertex_w, new_state.pred.valid, mesh, cfg.tsdf,
        )
        gid_image, table = inst.associate(
            new_state.table, seg_r, pred_gid, cfg.instances
        )
        depth_gated = jnp.where(info.track_ok, depth, jnp.zeros_like(depth))
        votes = shard.fuse_labels(
            new_state.votes, new_state.volume, gid_image, depth_gated,
            new_state.T_wc, mesh, intr, cfg.tsdf,
        )
        return new_state._replace(votes=votes, table=table), info

    return _donated(step_seg) if donate else jax.jit(step_seg)


def make_fuse_segmentation(cfg: EngineConfig, mesh: Mesh, donate: bool = False):
    """Sharded arrival-half of instance fusion (engine/slam.fuse_segmentation).

    Signature (state, seg, depth, T_mc) -> state.  Used by the pipeline's
    asynchronous segmentation overlap: voting runs against the SEG
    frame's own depth/pose into the sharded votes; association uses the
    current pmax-composited predicted-id image.
    """
    assert cfg.use_instances, "make_fuse_segmentation requires use_instances"
    from instancefusion_tpu.engine import instances as inst
    from instancefusion_tpu.ops import labels

    intr = cfg.intrinsics

    def fuse_seg(state: ShardedSlamState, seg, depth, T_mc):
        mask_id = labels.refine_mask_edges(seg.mask_id, depth, intr=intr)
        seg_r = seg._replace(mask_id=mask_id)
        pred_gid = shard.sample_labels(
            state.votes, state.volume,
            state.pred.vertex_w, state.pred.valid, mesh, cfg.tsdf,
        )
        # Duplicate-row merge (engine/slam.fuse_segmentation): relabeling
        # is elementwise, so it runs unchanged on the sharded vote planes.
        src, dst, mok = inst.find_merges(
            state.table, seg_r, pred_gid, cfg.instances
        )
        table = inst.apply_merges(state.table, src, dst, mok)
        votes = labels.relabel_votes(state.votes, src, dst, mok)
        for i in range(src.shape[0]):
            pred_gid = jnp.where(
                mok[i] & (pred_gid == src[i]), dst[i], pred_gid
            )
        gid_image, table = inst.associate(table, seg_r, pred_gid, cfg.instances)
        votes = shard.fuse_labels(
            votes, state.volume, gid_image, depth, T_mc,
            mesh, intr, cfg.tsdf,
        )
        return state._replace(votes=votes, table=table)

    return jax.jit(fuse_seg, donate_argnums=(0,) if donate else ())
