"""SLAM engine: the per-frame pipeline as one pure function under jit.

Replacement for the reference's engine facade
(`ElasticFusion::processFrame` in the expected `Core/src/ElasticFusion.cpp`
— SURVEY.md §4.2).  Differences dictated by XLA semantics:

- All state (pose, volume, predicted maps, health) is an explicit pytree;
  `step` is `state, frame -> state, info` with no hidden globals.
- The whole per-frame pipeline — preprocess, 3-level ICP (every
  iteration), TSDF integrate, raycast prediction — is traced into a
  single `jit` program; there is no device<->host round trip per ICP
  iteration like the reference's 6x6 CPU solve.
- Frame 0 needs no special case: the predicted maps start invalid, the
  tracking-health gate fails closed, and the engine fuses at the initial
  pose.

This is the dense-volume (config 1) engine; the block-sparse engine that
scales to 512^3+ builds on the same step structure in `engine/blocks.py`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import EngineConfig
from instancefusion_tpu.engine import instances as inst
from instancefusion_tpu.geometry.se3 import se3_inverse
from instancefusion_tpu.models.segmentation import Segmentation
from instancefusion_tpu.ops import blocks, icp, labels, preprocess, raycast as rc, tsdf


class _DenseOps:
    """Dense-volume map interface (config 1)."""

    allocate = staticmethod(tsdf.allocate)
    integrate = staticmethod(tsdf.integrate)
    raycast = staticmethod(rc.raycast)


def _map_ops(cfg: EngineConfig):
    """Map-kind dispatch: dense volume (config 1) vs sparse block table."""
    return blocks if cfg.map_kind == "blocks" else _DenseOps


class SlamState(NamedTuple):
    T_wc: jnp.ndarray  # (4,4) current camera-to-world pose
    volume: tsdf.TsdfVolume | blocks.BlockMap
    pred: rc.RaycastMaps  # model prediction rendered at pred_T_wc
    pred_T_wc: jnp.ndarray  # (4,4) pose the prediction was rendered from
    frame_idx: jnp.ndarray  # () i32
    lost_frames: jnp.ndarray  # () i32 — consecutive tracking failures
    # Previous frame's pose — feeds the constant-velocity ICP seed
    # (T_seed = T_wc · T_prev⁻¹·T_wc, i.e. replay the last camera-frame
    # increment).  The reference seeds with the previous pose only; the
    # velocity seed converges where large inter-frame motion would
    # otherwise exceed the projective-association basin.
    T_prev_wc: jnp.ndarray = None
    # Instance subsystem (None unless cfg.use_instances; None is an empty
    # pytree node, so the no-instance jit signature is unchanged).
    votes: labels.LabelVotes | None = None
    table: inst.InstanceTable | None = None
    # Per-slot observation stamps, i32[capacity, 2] = (last_fused_frame,
    # observation_gap) — None unless cfg.track_stamps.  `gap` records, for
    # the update streak a block is currently in, how many frames it went
    # UNSEEN before the streak began (sticky until reset): the evidence
    # signal for active/inactive local loop closure (engine/localloop.py) —
    # the reference's ElasticFusion-style time-windowed model split.
    stamp: jnp.ndarray | None = None
    # Map-consistency sentinel state (None unless cfg.consistency_check):
    # previous frame's coarse-level (vmap, nmap, valid) for the
    # frame-to-frame check, and the world-frame disagreement-bias EWMA
    # vector f32[3] (see slam._consistency_update).
    prev_coarse: tuple | None = None
    drift_ewma: jnp.ndarray | None = None


class StepInfo(NamedTuple):
    inliers: jnp.ndarray
    residual: jnp.ndarray
    track_ok: jnp.ndarray
    fused_voxels: jnp.ndarray  # voxels receiving an update this frame
    # Map-consistency sentinel (cfg.consistency_check): EWMA of the
    # frame-to-frame vs frame-to-model translation disagreement (m), and
    # whether it crossed cfg.consistency_thresh this frame.
    drift_ewma: jnp.ndarray | None = None
    drift_alarm: jnp.ndarray | None = None


def init_state(cfg: EngineConfig, T_init_wc: jnp.ndarray | None = None) -> SlamState:
    intr = cfg.intrinsics
    h, w = intr.height, intr.width
    volume = _map_ops(cfg).allocate(cfg.tsdf, with_color=cfg.use_color)
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
        if cfg.map_kind != "blocks":
            raise ValueError("instance fusion requires map_kind='blocks'")
        votes = labels.allocate(cfg.tsdf)
        table = inst.allocate(cfg.instances)
    stamp = None
    if cfg.track_stamps:
        if cfg.map_kind != "blocks":
            raise ValueError("track_stamps requires map_kind='blocks'")
        stamp = jnp.zeros((cfg.tsdf.table_capacity, 2), jnp.int32)
    prev_coarse = drift_ewma = None
    if cfg.consistency_check:
        s = 1 << max(cfg.icp.levels - 2, 0)
        hc, wc = h // s, w // s
        prev_coarse = (
            jnp.zeros((hc, wc, 3), jnp.float32),
            jnp.zeros((hc, wc, 3), jnp.float32),
            jnp.zeros((hc, wc), bool),
        )
        drift_ewma = jnp.zeros((3,), jnp.float32)  # world-frame bias vector
    state = SlamState(
        T_wc=T0,
        volume=volume,
        pred=pred,
        pred_T_wc=T0,
        frame_idx=jnp.zeros((), jnp.int32),
        lost_frames=jnp.zeros((), jnp.int32),
        T_prev_wc=T0,
        votes=votes,
        table=table,
        stamp=stamp,
        prev_coarse=prev_coarse,
        drift_ewma=drift_ewma,
    )
    # Leaves holding the same buffer (T0 three times; cached zeros
    # constants) would make the donated step variants fail with
    # "donate the same buffer twice" — split them once here.
    return _unalias_pytree(state)


@jax.jit
def _unalias_pytree(tree):
    """Give every leaf of `tree` its own buffer (see step_donated)."""
    leaves, treedef = jax.tree.flatten(tree)
    leaves = jax.lax.optimization_barrier(tuple(leaves))
    return jax.tree.unflatten(treedef, list(leaves))


def _splat_map_update(
    cfg: EngineConfig,
    volume,  # previous BlockMap
    pred_prev_depth: jnp.ndarray,  # previous prediction's depth (prior holes)
    depth_eff: jnp.ndarray,  # tracking-gated measured depth
    frame_color: jnp.ndarray | None,
    T_new: jnp.ndarray,
    frame_idx: jnp.ndarray,
):
    """The blocks+use_splat path: allocate + integrate + splat predict.

    Shared by `step` and `step_gt`.  One in-frustum block list feeds both
    the integrate and the splat prediction (ops/splat.py); list-based
    bookkeeping only (blocks.discover_allocate — no directory-sized
    scatters).
    """
    intr = cfg.intrinsics
    pred_color = cfg.use_color and (
        cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
    )
    prior = jnp.where(depth_eff > 0.0, depth_eff, pred_prev_depth)
    volume = blocks.discover_allocate(volume, depth_eff, T_new, intr, cfg.tsdf)

    def cadenced(integrate_fn):
        """Apply the color cadence (+ cadence-gain, see config.color_every)."""
        if frame_color is not None and cfg.color_every > 1:
            return jax.lax.cond(
                frame_idx % cfg.color_every == 0,
                lambda vol: integrate_fn(
                    vol, frame_color, float(cfg.color_every)
                ),
                lambda vol: integrate_fn(vol, None, 1.0),
                volume,
            )
        return integrate_fn(volume, frame_color, 1.0)

    k = min(
        cfg.tsdf.touched_capacity,
        blocks.num_blocks_per_axis(cfg.tsdf) ** 3,
    )
    slots, slot_valid = blocks.frustum_slots(
        volume, T_new, intr, cfg.tsdf,
        cfg.raycast.near, cfg.raycast.far, k,
    )
    new_volume = cadenced(
        lambda vol, col, gain: blocks.integrate_slots(
            vol, slots, slot_valid, depth_eff, col, T_new, intr,
            cfg.tsdf, color_gain=gain,
        )
    )
    pred = blocks.raycast_splat(
        new_volume, T_new, intr, cfg.tsdf, slots, slot_valid,
        with_color=pred_color,
        depth_prior=prior,
        rmax=cfg.raycast.splat_rmax,
    )
    return new_volume, pred


def _consistency_update(cfg: EngineConfig, state, pyr, result, T_new):
    """Map-consistency sentinel (SURVEY §6 failure detection).

    Slow map-feedback drift — frames fusing slightly misaligned so the
    map drags the next solve — keeps inliers high, so the per-frame
    health gate cannot see it.  This runs a coarse-level frame-to-FRAME
    ICP (previous frame's coarse vmap/nmap as the target — no map in the
    loop) seeded at the frame-to-model increment, and EWMAs the
    translation disagreement between the two odometries: a dragging map
    produces a persistent per-frame bias that the EWMA integrates, while
    honest ICP noise averages out.  ~80x60 x few GN steps: noise-level
    cost next to the VGA 3-level solve.
    """
    if not cfg.consistency_check:
        return None, None, None, None
    import dataclasses

    # One level above the coarsest: the coarsest (e.g. 160x120 at VGA) is
    # what the main solve uses for basin capture, but its f2f noise floor
    # (mm-scale) would bury the sub-mm/frame drift bias being integrated.
    lvl = max(cfg.icp.levels - 2, 0)
    coarse = pyr[lvl]
    cur = (coarse["vmap"], coarse["nmap"], coarse["valid"])
    pv, pn, pval = state.prev_coarse
    prec = jax.lax.Precision.HIGHEST
    # Frame-to-model relative increment (prev camera -> current camera).
    T_rel_f2m = jnp.matmul(se3_inverse(state.T_wc), T_new, precision=prec)
    icp_cfg = dataclasses.replace(
        cfg.icp, levels=1, iters=(6,), rgb_weight=0.0,
        min_valid=max(cfg.icp.min_valid // 8, 20), assoc_every=2,
    )
    f2f = icp.track(
        [coarse], pv, pn, pval,
        T_rel_f2m,  # seed at the f2m answer; measure the residual pull
        jnp.eye(4, dtype=jnp.float32),  # prev maps live in prev-cam frame
        cfg.intrinsics.level(lvl), icp_cfg,
    )
    delta = jnp.matmul(se3_inverse(f2f.T_wc), T_rel_f2m, precision=prec)
    # VECTOR EWMA in the world frame: per-frame ICP noise (~mm at VGA
    # with sensor noise) is directionally random and averages toward
    # zero, while a dragging map pulls in a world-consistent direction —
    # the bias survives the average.  A scalar-norm EWMA cannot make
    # this separation (measured: the noisy fr1-mean rig's norm floor
    # exceeds the drift rig's signal).
    d_w = jnp.matmul(
        state.T_wc[:3, :3], delta[:3, 3], precision=prec
    )
    ok = result.valid & f2f.valid & (state.frame_idx > 0)
    a = cfg.consistency_alpha
    ewma = jnp.where(ok, (1 - a) * state.drift_ewma + a * d_w, state.drift_ewma)
    mag = jnp.linalg.norm(ewma)
    # Hold the alarm down while the map settles (first ~10 frames fuse
    # into a near-empty model; their disagreement is honest).
    return cur, ewma, mag, (mag > cfg.consistency_thresh) & (state.frame_idx > 10)


@functools.partial(jax.jit, static_argnums=(0,))
def step(
    cfg: EngineConfig,
    state: SlamState,
    depth: jnp.ndarray,
    color: jnp.ndarray,
) -> tuple[SlamState, StepInfo]:
    """Track -> fuse -> predict for one RGB-D frame."""
    intr = cfg.intrinsics
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

    # Health gate: on tracking failure, fuse nothing and keep the pose
    # (the reference fuses regardless; gating is the SURVEY §6 failure-
    # detection design). Frame 0 "fails" tracking by construction but must
    # still fuse — allow fusion when the map is empty.
    first = state.frame_idx == 0
    fuse_ok = result.valid | first
    T_new = jnp.where(result.valid, result.T_wc, state.T_wc)

    d0 = pyr[0]["depth"]
    fused = jnp.where(
        fuse_ok,
        tsdf_integrate_count(d0),
        jnp.zeros((), jnp.float32),
    )
    depth_masked = jnp.where(fuse_ok, d0, jnp.zeros_like(d0))
    ops = _map_ops(cfg)
    frame_color = color if cfg.use_color else None
    # Predicted color only feeds the photometric term / visualization
    # (map color is still fused -- use_color governs integration).
    pred_color = cfg.use_color and (
        cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
    )
    if cfg.map_kind == "blocks" and cfg.raycast.use_splat:
        volume, pred = _splat_map_update(
            cfg, state.volume, state.pred.depth, depth_masked, frame_color,
            T_new, state.frame_idx,
        )
    else:
        volume = ops.integrate(
            state.volume, depth_masked, frame_color, T_new, intr, cfg.tsdf
        )
        rc_kwargs = {}
        if cfg.map_kind == "blocks":
            # Tracking-prediction fast paths (see ops/blocks.raycast): the
            # dense path keeps full-sweep semantics for golden parity.
            if cfg.raycast.use_depth_prior:
                # Prior: this frame's fused depth; holes (and lost frames,
                # where nothing was fused) fall back to the previous
                # prediction — the pose moved at most a frame's worth, well
                # inside the 1.5-trunc search band.
                rc_kwargs["depth_prior"] = jnp.where(
                    depth_masked > 0.0, depth_masked, state.pred.depth
                )
            rc_kwargs["screen_space_normals"] = cfg.raycast.screen_space_normals
        pred = ops.raycast(
            volume, T_new, intr, cfg.tsdf, cfg.raycast,
            with_color=pred_color, **rc_kwargs,
        )

    stamp = state.stamp
    if stamp is not None and cfg.map_kind == "blocks":
        stamp = _update_stamps(
            cfg, stamp, volume, state.volume.n_active, T_new, fuse_ok,
            state.frame_idx,
        )
    prev_coarse, drift_ewma, drift_mag, drift_alarm = _consistency_update(
        cfg, state, pyr, result, T_new
    )
    new_state = state._replace(
        T_wc=T_new,
        volume=volume,
        pred=pred,
        pred_T_wc=T_new,
        frame_idx=state.frame_idx + 1,
        lost_frames=jnp.where(
            result.valid | first, 0, state.lost_frames + 1
        ).astype(jnp.int32),
        # On failure T_new == T_wc, so setting prev := old pose keeps the
        # velocity term identity (no runaway extrapolation while lost).
        T_prev_wc=jnp.where(result.valid, state.T_wc, T_new),
        stamp=stamp,
        prev_coarse=prev_coarse,
        drift_ewma=drift_ewma,
    )
    info = StepInfo(
        inliers=result.inliers,
        residual=result.residual,
        track_ok=result.valid | first,
        fused_voxels=fused,
        drift_ewma=drift_mag,
        drift_alarm=drift_alarm,
    )
    return new_state, info


@functools.partial(jax.jit, static_argnums=(0,))
def step_gt(
    cfg: EngineConfig,
    state: SlamState,
    depth: jnp.ndarray,
    color: jnp.ndarray,
    T_gt_wc: jnp.ndarray,
) -> tuple[SlamState, StepInfo]:
    """Fuse -> predict with an externally supplied pose (tracking bypass).

    The reference's `GroundTruthOdometry` mode (SURVEY.md §5): feed the
    dataset's ground-truth trajectory instead of running ICP, isolating
    the fusion/raycast pipeline for reconstruction-quality evaluation.
    Identical map-update path to `step`; ICP is skipped entirely.
    """
    intr = cfg.intrinsics
    pyr = preprocess.build_frame_pyramid(depth, intr, cfg.preprocess, 1)
    T_new = T_gt_wc
    d0 = pyr[0]["depth"]
    fused = tsdf_integrate_count(d0)
    ops = _map_ops(cfg)
    frame_color = color if cfg.use_color else None
    # Predicted color only feeds the photometric term / visualization
    # (map color is still fused -- use_color governs integration).
    pred_color = cfg.use_color and (
        cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
    )
    if cfg.map_kind == "blocks" and cfg.raycast.use_splat:
        # Same map-update path as `step` (identical map contents under a
        # cadenced config — the GT path only skips ICP).
        volume, pred = _splat_map_update(
            cfg, state.volume, state.pred.depth, d0, frame_color, T_new,
            state.frame_idx,
        )
    else:
        volume = ops.integrate(
            state.volume, d0, frame_color, T_new, intr, cfg.tsdf
        )
        rc_kwargs = {}
        if cfg.map_kind == "blocks":
            if cfg.raycast.use_depth_prior:
                rc_kwargs["depth_prior"] = jnp.where(
                    d0 > 0.0, d0, state.pred.depth
                )
            rc_kwargs["screen_space_normals"] = cfg.raycast.screen_space_normals
        pred = ops.raycast(
            volume, T_new, intr, cfg.tsdf, cfg.raycast,
            with_color=pred_color, **rc_kwargs,
        )
    stamp = state.stamp
    if stamp is not None and cfg.map_kind == "blocks":
        stamp = _update_stamps(
            cfg, stamp, volume, state.volume.n_active, T_new,
            jnp.ones((), bool), state.frame_idx,
        )
    new_state = state._replace(
        T_wc=T_new, volume=volume, pred=pred, pred_T_wc=T_new,
        frame_idx=state.frame_idx + 1,
        lost_frames=jnp.zeros((), jnp.int32),
        T_prev_wc=state.T_wc,
        stamp=stamp,
    )
    info = StepInfo(
        inliers=jnp.zeros(()),
        residual=jnp.zeros(()),
        track_ok=jnp.ones((), bool),
        fused_voxels=fused,
    )
    return new_state, info


@functools.partial(jax.jit, static_argnums=(0,))
def step_seg(
    cfg: EngineConfig,
    state: SlamState,
    depth: jnp.ndarray,
    color: jnp.ndarray,
    seg: Segmentation,
) -> tuple[SlamState, StepInfo]:
    """`step` + instance fusion for frames that carry a segmentation.

    The reference runs Mask R-CNN asynchronously and applies its masks on
    arrival (SURVEY.md §4.5); here the host driver decides which frames
    carry a `Segmentation` (from the JAX head or an external source) and
    calls this entry instead of `step`.  Pipeline per seg frame:

    1. normal track -> fuse -> predict,
    2. mask-edge refinement against depth discontinuities,
    3. predicted instance-id map sampled at raycast hit points,
    4. mask <-> model association (IoU as a matmul) + table update,
    5. Boyer-Moore label voting into band voxels of touched blocks.
    """
    assert cfg.use_instances, "step_seg requires cfg.use_instances"
    new_state, info = step(cfg, state, depth, color)
    depth_gated = jnp.where(info.track_ok, depth, jnp.zeros_like(depth))
    new_state = fuse_segmentation.__wrapped__(
        cfg, new_state, seg, depth_gated, new_state.T_wc
    )
    return new_state, info


@functools.partial(jax.jit, static_argnums=(0,))
def fuse_segmentation(
    cfg: EngineConfig,
    state: SlamState,
    seg: Segmentation,
    depth: jnp.ndarray,  # the SEG frame's depth (pre-gated by its track_ok)
    T_mc: jnp.ndarray,  # the SEG frame's tracked (map-frame) pose
) -> SlamState:
    """Apply a segmentation result to the live state — the arrival half.

    Split out of `step_seg` so the pipeline can overlap the head with
    tracking (the reference's asynchronous Mask R-CNN thread, SURVEY.md
    §3.2 "Pipeline overlap"): the head is dispatched on frame i without
    fetching, the result consumed here on frame i+1 against that frame's
    OWN depth and pose (geometrically exact voting) while the instance
    association uses the current — at most one frame newer — predicted-id
    image.  Steps 2-5 of the step_seg pipeline (mask refine, predicted-id
    sample, IoU association + table update, Boyer-Moore voting).
    """
    assert cfg.use_instances
    mask_id = labels.refine_mask_edges(seg.mask_id, depth, intr=cfg.intrinsics)
    seg = seg._replace(mask_id=mask_id)
    pred_gid = labels.sample_nearest(
        state.votes,
        state.volume,
        state.pred.vertex_w,
        state.pred.valid,
        cfg.tsdf,
    )
    # Duplicate-row merge BEFORE matching: a mask overlapping two
    # predicted regions is the evidence that they are one object
    # (instances.find_merges — the reference's create/MERGE/confirm).
    src, dst, mok = inst.find_merges(state.table, seg, pred_gid, cfg.instances)
    table = inst.apply_merges(state.table, src, dst, mok)
    votes = labels.relabel_votes(state.votes, src, dst, mok)
    for i in range(src.shape[0]):  # remap the predicted-id image too
        pred_gid = jnp.where(mok[i] & (pred_gid == src[i]), dst[i], pred_gid)
    gid_image, table = inst.associate(table, seg, pred_gid, cfg.instances)
    votes = labels.fuse(
        votes,
        state.volume,
        gid_image,
        depth,
        T_mc,
        cfg.intrinsics,
        cfg.tsdf,
    )
    return state._replace(votes=votes, table=table)


fuse_segmentation_donated = jax.jit(
    fuse_segmentation.__wrapped__, static_argnums=(0,), donate_argnums=(1,)
)


# Donated step variants: the input state's buffers are released to XLA, so
# the payload row scatters update in place instead of forcing a defensive
# copy of the multi-hundred-MB block payload at the jit boundary.  The caller must
# not touch the passed-in state afterwards — the sequential drivers
# (bench.py, engine/pipeline.py) rebind it every frame; tests and ad-hoc
# callers keep the non-donated `step`.
#
# The pose trio (T_wc / pred_T_wc / T_prev_wc) is frequently the SAME
# traced value (e.g. T_new feeds both T_wc and pred_T_wc), which XLA
# dedups into one output buffer — and a shared buffer cannot be donated
# twice on the next call.  An optimization_barrier over the trio forces
# three distinct output buffers at zero cost.
def _make_donated(fn):
    def wrapper(cfg, state, *args):
        new_state, info = fn(cfg, state, *args)
        t_wc, t_pred, t_prev = jax.lax.optimization_barrier(
            (new_state.T_wc, new_state.pred_T_wc, new_state.T_prev_wc)
        )
        return (
            new_state._replace(T_wc=t_wc, pred_T_wc=t_pred, T_prev_wc=t_prev),
            info,
        )

    return jax.jit(wrapper, static_argnums=(0,), donate_argnums=(1,))


step_donated = _make_donated(step.__wrapped__)
step_gt_donated = _make_donated(step_gt.__wrapped__)
step_seg_donated = _make_donated(step_seg.__wrapped__)


def _update_stamps(cfg, stamp, volume, n_before, T_new, fuse_ok, frame_idx):
    """Per-slot (last_fused, gap) update for this frame's in-view blocks.

    Stamps are 1-based frame numbers (0 = never fused).  A block updated
    after going unseen for more than 2 frames records that gap — sticky
    until engine/localloop.reset_gaps — as the revisit-evidence signal for
    active/inactive local loop closure.  Freshly allocated slots are new
    geometry, not revisits: gap stays 0.
    """
    f = frame_idx + 1
    inview = (
        blocks.frustum_mask(
            volume, T_new, cfg.intrinsics, cfg.tsdf,
            cfg.raycast.near, cfg.raycast.far,
        )
        & fuse_ok
    )
    last, gap = stamp[:, 0], stamp[:, 1]
    delta = f - last
    gap_new = jnp.where(inview & (delta > 2) & (last > 0), delta, gap)
    last_new = jnp.where(inview, f, last)
    c = stamp.shape[0]
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (c, 1), 0)[:, 0]
    fresh = (slot_ids >= n_before) & (slot_ids < volume.n_active)
    last_new = jnp.where(fresh, f, last_new)
    gap_new = jnp.where(fresh, 0, gap_new)
    return jnp.stack([last_new, gap_new], axis=-1)


def _motion_seed(T_wc, T_prev_wc, vel: float,
                 cap_t: float = 0.25, cap_r: float = 0.25):
    """ICP initial pose from a damped constant-velocity motion model.

    Replays `vel` x the previous frame's camera-frame twist on top of the
    current pose: vel=0 is the reference's previous-pose seed, vel=1 full
    constant velocity.  After a lost frame (or at start) the stored
    increment is identity, so this degrades gracefully.

    A twist beyond any plausible inter-frame camera motion (cap_t
    meters, cap_r radians; the defaults are ~7 m/s / ~430 deg/s at
    30 Hz — far above real rigs, a pure outlier guard) is REJECTED
    outright (previous-pose seed), not rescaled: an oversized "twist"
    is a relocalization re-seat or a huge solver correction — a
    CORRECTION, not motion — and extrapolating any fraction of it
    points the seed at a place the camera never moved toward.  The
    finer-grained correction handling is contextual and lives in the
    pipeline: it zeroes the velocity model for the relocalization frame
    AND the first post-relocalization step (whose own solve is still a
    correction, measured 78 mm on the blackout-recovery rig).
    """
    if vel == 0.0:
        return T_wc
    from instancefusion_tpu.geometry.se3 import se3_exp, se3_log

    prec = jax.lax.Precision.HIGHEST
    delta = jnp.matmul(se3_inverse(T_prev_wc), T_wc, precision=prec)
    xi = vel * se3_log(delta)
    tn = jnp.linalg.norm(xi[:3])
    rn = jnp.linalg.norm(xi[3:])
    plausible = (tn <= cap_t) & (rn <= cap_r)
    delta = se3_exp(jnp.where(plausible, 1.0, 0.0) * xi)
    T_seed = jnp.matmul(T_wc, delta, precision=prec)
    return jnp.where(jnp.all(jnp.isfinite(T_seed)), T_seed, T_wc)


def tsdf_integrate_count(depth: jnp.ndarray) -> jnp.ndarray:
    """Proxy metric: valid depth pixels fused this frame."""
    return jnp.sum((depth > 0).astype(jnp.float32))


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def run_chunk(
    cfg: EngineConfig,
    state: SlamState,
    depths: jnp.ndarray,  # (K, H, W)
    colors: jnp.ndarray,  # (K, H, W, 3)
) -> tuple[SlamState, StepInfo]:
    """`step` over a chunk of K frames inside one jit (`lax.scan`).

    Offline-log replay driver: datasets (TUM logs, ScanNet scans) are
    processed from disk, so frames can be staged in chunks and the whole
    track->fuse->predict chain for K frames dispatched as ONE device
    program — per-frame host dispatch is paid once per chunk instead of
    once per frame.  Semantics are identical to
    K sequential `step` calls (scan threads the state); `StepInfo` leaves
    come back stacked (K,).  The input state is donated — rebind it.
    """

    def body(st, frame):
        d, c = frame
        st2, info = step.__wrapped__(cfg, st, d, c)
        return st2, info

    new_state, infos = jax.lax.scan(body, state, (depths, colors))
    t_wc, t_pred, t_prev = jax.lax.optimization_barrier(
        (new_state.T_wc, new_state.pred_T_wc, new_state.T_prev_wc)
    )
    return (
        new_state._replace(T_wc=t_wc, pred_T_wc=t_pred, T_prev_wc=t_prev),
        infos,
    )


def run_sequence(cfg: EngineConfig, frames, T_init_wc=None):
    """Host-side driver: run `step` over an iterable of (depth, color).

    Returns (poses [list of np 4x4], infos [list of StepInfo]).
    """
    state = init_state(cfg, T_init_wc)
    poses, infos = [], []
    for depth, color in frames:
        state, info = step(cfg, state, depth, color)
        poses.append(jax.device_get(state.T_wc))
        infos.append(jax.device_get(info))
    return poses, infos, state
