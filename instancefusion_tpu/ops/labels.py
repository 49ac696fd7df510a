"""Per-voxel instance-label fusion over the block map.

XLA-friendly equivalent of the reference's per-surfel instance labels with
probabilistic/voting fusion and CUDA label-update kernels (SURVEY.md §3
"Instance fusion / label map", §4.5).  Instead of a per-surfel probability
vector (O(max_instances) memory per element), each voxel keeps a
**streaming majority vote** — (label, count) updated Boyer-Moore style:

    count == 0        -> adopt the observed label, count = 1
    label == observed -> count += 1
    label != observed -> count -= 1

This converges to the majority label under repeated observation with O(1)
memory per voxel, matches the reference's "labels harden over time"
behavior, and is a pure elementwise update (VPU work, shards with the
block payloads).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from instancefusion_tpu.config import TsdfConfig
from instancefusion_tpu.geometry.camera import Intrinsics, project
from instancefusion_tpu.geometry.se3 import se3_inverse, transform_points
from instancefusion_tpu.ops import blocks as blk


class LabelVotes(NamedTuple):
    """Per-voxel instance vote state, parallel to BlockMap payload slots."""

    label: jnp.ndarray  # i32[C, B^3] — global instance id, -1 = unlabeled
    count: jnp.ndarray  # f32[C, B^3] — majority-vote counter


def allocate(cfg: TsdfConfig) -> LabelVotes:
    c = cfg.table_capacity
    b3 = cfg.block_size**3
    return LabelVotes(
        label=jnp.full((c, b3), -1, jnp.int32),
        count=jnp.zeros((c, b3), jnp.float32),
    )


def relabel_votes(
    votes: LabelVotes,
    src: jnp.ndarray,  # i32[K] merged-away instance ids
    dst: jnp.ndarray,  # i32[K] surviving ids
    ok: jnp.ndarray,  # bool[K]
) -> LabelVotes:
    """Rewrite per-voxel votes after instance merges (src -> dst).

    One elementwise pass per merge pair over the vote planes (K is the
    per-frame mask capacity, small and static); counts are preserved —
    the merged object's evidence keeps its weight.  Works unchanged on
    sharded vote planes (purely elementwise).
    """
    label = votes.label
    k = src.shape[0]
    for i in range(k):
        hit = ok[i] & (label == src[i])
        label = jnp.where(hit, dst[i], label)
    return votes._replace(label=label)


def vote_update(
    lab: jnp.ndarray,  # i32[...] current labels
    cnt: jnp.ndarray,  # f32[...] current counters
    gid: jnp.ndarray,  # i32[...] observed instance ids
    obs: jnp.ndarray,  # bool[...] voxel observed this frame
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One Boyer-Moore majority step (module docstring), elementwise."""
    adopt = obs & (cnt <= 0.0)
    same = obs & (lab == gid) & ~adopt
    other = obs & ~adopt & ~same
    lab_new = jnp.where(adopt, gid, lab)
    cnt_new = jnp.where(
        adopt, 1.0, jnp.where(same, cnt + 1.0, jnp.where(other, cnt - 1.0, cnt))
    )
    return lab_new, cnt_new


def fuse(
    votes: LabelVotes,
    bm: blk.BlockMap,
    gid_image: jnp.ndarray,  # i32[H,W] per-pixel global instance id, -1 = none
    depth: jnp.ndarray,
    T_wc: jnp.ndarray,
    intr: Intrinsics,
    cfg: TsdfConfig,
    max_touched: int = 8192,
) -> LabelVotes:
    """Vote the frame's instance ids into band voxels of touched blocks.

    Mirrors `blocks.integrate`'s projective association: each voxel of a
    touched block projects into the frame; voxels within the truncation
    band of the measured surface receive the pixel's instance id.
    """
    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)
    nb3 = blk.num_blocks_per_axis(cfg) ** 3
    slots, valid = blk.compact_touched_slots(bm, touched, cfg, min(max_touched, nb3))

    coords = bm.block_coords[slots]
    local = blk._local_offsets(cfg)
    origin = jnp.asarray(cfg.origin, jnp.float32)
    vox_idx = coords[:, None, :] * cfg.block_size + local[None, :, :]
    p_w = origin + (vox_idx.astype(jnp.float32) + 0.5) * cfg.voxel_size

    T_cw = se3_inverse(T_wc)
    p_c = transform_points(T_cw, p_w.reshape(-1, 3)).reshape(p_w.shape)
    u, v, z = project(intr, p_c)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)
    d = depth[vic, uic]
    gid = gid_image[vic, uic]
    near_surface = jnp.abs(d - z) < cfg.trunc
    obs = in_img & (z > 0.0) & (d > 0.0) & near_surface & (gid >= 0) & valid[:, None]

    lab_new, cnt_new = vote_update(
        votes.label[slots], votes.count[slots], gid, obs
    )
    out_slots = jnp.where(valid, slots, votes.label.shape[0])
    return LabelVotes(
        label=votes.label.at[out_slots].set(lab_new, mode="drop"),
        count=votes.count.at[out_slots].set(cnt_new, mode="drop"),
    )


def sample_nearest(
    votes: LabelVotes,
    bm: blk.BlockMap,
    p_w: jnp.ndarray,  # (..., 3) world points (e.g. raycast hits)
    valid_in: jnp.ndarray,  # (...) bool
    cfg: TsdfConfig,
) -> jnp.ndarray:
    """Nearest-voxel instance label at world points -> i32[...], -1 = none.

    This is the "project the instance-labeled model into the camera" step
    of the reference's 2D-3D association, realized as a lookup at raycast
    hit points instead of a GL render pass.
    """
    nb = blk.num_blocks_per_axis(cfg)
    b = cfg.block_size
    b3 = b * b * b
    n = cfg.grid_size
    g = jnp.round(
        (p_w - jnp.asarray(cfg.origin, p_w.dtype)) / cfg.voxel_size - 0.5
    ).astype(jnp.int32)
    inb = jnp.all((g >= 0) & (g < n), axis=-1) & valid_in
    gc = jnp.clip(g, 0, n - 1)
    blkc = gc // b
    loc = gc - blkc * b
    bflat = (blkc[..., 0] * nb + blkc[..., 1]) * nb + blkc[..., 2]
    slot = bm.directory.reshape(-1)[bflat]
    have = inb & (slot >= 0)
    vidx = jnp.maximum(slot, 0) * b3 + (loc[..., 0] * b + loc[..., 1]) * b + loc[..., 2]
    lab = votes.label.reshape(-1)[vidx]
    cnt = votes.count.reshape(-1)[vidx]
    return jnp.where(have & (cnt > 0.0), lab, -1)


def refine_mask_edges(
    mask_id: jnp.ndarray,  # i32[H,W]
    depth: jnp.ndarray,  # f32[H,W]
    edge_thresh: float = 0.05,
    intr: Intrinsics | None = None,
    normal_dot: float = 0.6,
) -> jnp.ndarray:
    """Invalidate mask labels on depth AND normal discontinuities.

    The reference runs CUDA mask-refinement kernels snapping Mask R-CNN's
    soft borders to depth/normal edges (SURVEY §4.5); network masks bleed
    across silhouettes, which would vote wrong labels onto background
    geometry.  Two edge classes:

    - **Depth edges** (silhouettes): a pixel whose 4-neighborhood depth
      range exceeds `edge_thresh` (or touches invalid depth) is dropped.
    - **Normal edges** (creases): tangential surfaces meeting at a
      concave corner — a box sitting on the floor, a wall/floor seam —
      have NO depth jump, so depth edges alone let labels bleed across
      the seam.  With `intr` given, the frame normal map (central
      differences of the backprojection — the same construction the
      tracking pyramid uses) marks pixels whose neighbor normals disagree
      (dot < `normal_dot`) as crease edges and drops them too.
    """
    d = depth
    neigh = [jnp.roll(d, s, a) for s, a in ((1, 0), (-1, 0), (1, 1), (-1, 1))]
    dmin = jnp.minimum(jnp.minimum(neigh[0], neigh[1]), jnp.minimum(neigh[2], neigh[3]))
    dmax = jnp.maximum(jnp.maximum(neigh[0], neigh[1]), jnp.maximum(neigh[2], neigh[3]))
    edge = (dmax - dmin > edge_thresh) | (dmin <= 0.0) | (d <= 0.0)

    if intr is not None:
        from instancefusion_tpu.geometry.camera import backproject
        from instancefusion_tpu.ops.preprocess import compute_normals

        nmap, nvalid = compute_normals(backproject(intr, d))
        dots = []
        for s, a in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
            nn = jnp.roll(nmap, s, a)
            nv = jnp.roll(nvalid, s, a)
            dot = jnp.sum(nmap * nn, axis=-1)
            # Invalid neighbors don't witness a crease (the depth term
            # already drops invalid-depth borders).
            dots.append(jnp.where(nvalid & nv, dot, 1.0))
        min_dot = jnp.minimum(
            jnp.minimum(dots[0], dots[1]), jnp.minimum(dots[2], dots[3])
        )
        edge = edge | (min_dot < normal_dot)
    return jnp.where(edge, -1, mask_id)
