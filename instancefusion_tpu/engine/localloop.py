"""Active/inactive local loop closure over the block map.

The reference registers its *active* model (recently updated surfels)
against the *inactive* model (not seen for a time window) every frame and
feeds successful registrations to the deformation graph — ElasticFusion's
time-windowed local loops, listed in SURVEY.md §3 ("Local loop closure:
model-to-model registration of active vs inactive map parts", expected in
`Core/src/ElasticFusion.cpp`).

The block-map analog:

- `slam.step` keeps per-slot observation stamps (last_fused, gap) — see
  `slam._update_stamps`.  A block whose latest update streak began after
  more than `local_window` unseen frames is *revisit evidence*: the camera
  is fusing into geometry it had not observed for a long time, exactly the
  condition under which accumulated drift becomes measurable.
- `evidence_count` (jit, ~one vector pass over the slot axis) is the cheap
  per-cadence detector the host polls.
- `attempt` renders a prediction from ONLY the old/revisited blocks (the
  inactive model view — the splat predictor (ops/splat.py) takes an
  explicit slot list, so only the compaction mask differs) and runs the full coarse-to-fine ICP of the current
  frame against it.  Success yields the drift-corrected camera pose in the
  map frame.
- The host (engine/pipeline.py) re-seats the engine at the corrected pose,
  records a pose-graph loop edge against the nearest old keyframe, and
  resets the consumed evidence (`reset_gaps`).

Correction semantics: the old geometry wins (it was fused when the
trajectory estimate was younger and less drifted); the few frames fused at
the drifted pose before detection remain as low-weight smear that
subsequent weighted fusion overwrites — the same approximation class as
the rigid map re-anchor documented in engine/pipeline.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.ops.common import decimate
from instancefusion_tpu.config import EngineConfig
from instancefusion_tpu.ops import blocks, icp


class LocalLoopResult(NamedTuple):
    ok: jnp.ndarray  # () bool — converged + gates passed
    T_corr_wc: jnp.ndarray  # (4,4) drift-corrected camera pose (map frame)
    inliers: jnp.ndarray  # () f32
    pred_pixels: jnp.ndarray  # () f32 — inactive-view coverage used


def _inactive_slot_mask(cfg: EngineConfig, state) -> jnp.ndarray:
    """Slots forming the inactive/revisited model view: bool[capacity].

    Union of (a) blocks whose current update streak began after a gap
    longer than the window (the revisited old geometry), and (b) in-view
    blocks still unseen for longer than the window (old geometry the
    camera is approaching but has not re-fused yet).
    """
    pg = cfg.posegraph
    f = state.frame_idx + 1
    last, gap = state.stamp[:, 0], state.stamp[:, 1]
    inview = blocks.frustum_mask(
        state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf,
        cfg.raycast.near, cfg.raycast.far,
    )
    revisited = gap > pg.local_window
    stale = (last > 0) & (f - last > pg.local_window)
    return inview & (revisited | stale)


@functools.partial(jax.jit, static_argnums=(0,))
def evidence_count(cfg: EngineConfig, state) -> jnp.ndarray:
    """Number of in-frustum revisit-evidence blocks (cheap poll)."""
    pg = cfg.posegraph
    inview = blocks.frustum_mask(
        state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf,
        cfg.raycast.near, cfg.raycast.far,
    )
    return jnp.sum((inview & (state.stamp[:, 1] > pg.local_window)).astype(jnp.int32))


@functools.partial(jax.jit, static_argnums=(0,))
def attempt(
    cfg: EngineConfig,
    state,
    vmap_c: jnp.ndarray,  # (H,W,3) current frame camera-frame vertices
    nmap_c: jnp.ndarray,  # (H,W,3)
    valid: jnp.ndarray,  # (H,W)
) -> LocalLoopResult:
    """Register the current frame against the inactive model view."""
    pg = cfg.posegraph
    sel = _inactive_slot_mask(cfg, state)
    k = min(cfg.tsdf.touched_capacity, state.volume.sdf.shape[0])
    slots, slot_valid = blocks.compact_mask_indices(sel, k)
    pred = blocks.raycast_splat(
        state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf, slots, slot_valid,
        with_color=False,
        rmax=cfg.raycast.splat_rmax,
    )
    n_pred = jnp.sum(pred.valid.astype(jnp.float32))

    # Full coarse-to-fine ICP with widened gates (drift can exceed the
    # tracking association gate) and fresh association every step.
    icp_cfg = cfg.icp.__class__(
        iters=cfg.icp.iters, levels=cfg.icp.levels,
        dist_thresh=cfg.icp.dist_thresh * 2.0,
        angle_thresh=cfg.icp.angle_thresh,
        rgb_weight=0.0, damping=cfg.icp.damping,
        huber_delta=cfg.icp.huber_delta,
        min_valid=pg.local_min_pixels // 4,
    )
    pyr = _pyramid_from_maps(vmap_c, nmap_c, valid, cfg.icp.levels)
    result = icp.track(
        pyr, pred.vertex_w, pred.normal_w, pred.valid,
        state.T_wc, state.T_wc, cfg.intrinsics, icp_cfg,
    )
    ok = (
        result.valid
        & (n_pred >= pg.local_min_pixels)
        & (result.inliers >= pg.local_min_inlier_frac * pg.local_min_pixels)
        & (result.residual < cfg.tsdf.voxel_size)
    )
    T_corr = jnp.where(ok, result.T_wc, state.T_wc)
    return LocalLoopResult(
        ok=ok, T_corr_wc=T_corr, inliers=result.inliers, pred_pixels=n_pred
    )


def _pyramid_from_maps(vmap_c, nmap_c, valid, levels: int):
    """Nearest-subsampled source pyramid (fine -> coarse) for icp.track."""
    pyr = []
    for lvl in range(levels):
        s = 1 << lvl
        pyr.append(
            {
                "vmap": decimate(vmap_c, s),
                "nmap": decimate(nmap_c, s),
                "valid": decimate(valid, s),
            }
        )
    return pyr


@functools.partial(jax.jit, static_argnums=(1,))
def reset_gaps(stamp: jnp.ndarray, window: int) -> jnp.ndarray:
    """Consume revisit evidence after a processed (or rejected) loop."""
    gap = jnp.where(stamp[:, 1] > window, 0, stamp[:, 1])
    return jnp.stack([stamp[:, 0], gap], axis=-1)
