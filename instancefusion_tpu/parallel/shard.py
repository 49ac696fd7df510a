"""Slab-sharded block map: distributed integrate / raycast / BA reductions.

The distributed centerpiece (SURVEY.md §3.2): the reference has no
distribution at all; BASELINE mandates the global map be partitioned into
voxel blocks sharded across devices/hosts.  Design:

- **Slab ownership**: shard s owns all blocks whose x block-coordinate
  falls in slab s (contiguous ranges, so trilinear stencils only straddle
  shards at S - 1 planar seams, healed by halo exchange — spatial-hash
  ownership would put a seam at *every* block face).
- **Global slot encoding**: slot = shard_id * C_local + local_slot.  The
  (replicated, 1 MB) directory stays globally meaningful while payload
  rows live only on their owner.
- **Allocation**: each shard prefix-sum-allocates its own slab's touched
  blocks into its local slot range; the disjoint proposals merge with one
  `pmax` — no cross-shard races by construction.
- **Integrate**: zero communication — every shard updates only rows it
  owns (the frame is replicated; the touched-set compute is identical
  everywhere).
- **Halo exchange**: before raycasting, each shard `ppermute`s its
  boundary-layer block rows to the neighbor shard (the ring/CP analog),
  so cross-seam trilinear stencils see real data.
- **Raycast compositing**: every shard marches all pixels through its own
  slab (+halo) and the shards `pmin`-composite per-pixel depth; winner
  fields are blended by masked `psum` (SURVEY §8 hard-part #4 — no
  cross-shard ray hand-off state machine).
- **BA reduction**: edge/observation sets shard over the same axis; the
  pure-sum partials from ops/ba.py `psum` into the replicated reduced
  system (the distributed Schur-complement reduction).

Everything is `shard_map` over the 1-D mesh from parallel/mesh.py; the
same code runs on a CPU test mesh (xla_force_host_platform_device_count)
and on the GPUs of one host (NCCL collectives).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from instancefusion_tpu.config import TsdfConfig
from instancefusion_tpu.geometry.camera import Intrinsics
from instancefusion_tpu.ops import ba, blocks as blk
from instancefusion_tpu.parallel.mesh import SHARD_AXIS

_PREC = jax.lax.Precision.HIGHEST


class ShardedBlockMap(NamedTuple):
    """Global view of the sharded map (payload rows sharded on axis 0)."""

    directory: jnp.ndarray  # i32[Nb,Nb,Nb] replicated; global slot encoding
    block_coords: jnp.ndarray  # i32[S*Cl, 3]
    n_active: jnp.ndarray  # i32[S] — per-shard live-slot counts
    overflow: jnp.ndarray  # i32[S]
    sdf: jnp.ndarray  # f32[S*Cl, B^3]
    weight: jnp.ndarray  # f32[S*Cl, B^3]
    color: jnp.ndarray  # f32[S*Cl, 3*B^3] packed [r|g|b] (blocks.pack_color)
    # Slab partition of the x block-axis (replicated): shard s owns block
    # x-coords in [cuts[s-1], cuts[s]) with implicit cuts[-1]=0,
    # cuts[S-1]=Nb.  Starts uniform; the reshard policy rebalances it
    # from the occupancy histogram (balanced_cuts) and one `all_to_all`
    # migrates the rows (SURVEY §3.2 "all_to_all for block re-sharding").
    cuts: jnp.ndarray = None  # i32[S-1]


def uniform_cuts(cfg: TsdfConfig, num_shards: int) -> jnp.ndarray:
    nb = blk.num_blocks_per_axis(cfg)
    return (jnp.arange(1, num_shards, dtype=jnp.int32) * nb) // num_shards


def balanced_cuts(directory, cfg: TsdfConfig, num_shards: int) -> jnp.ndarray:
    """Occupancy-balanced slab cuts from the (replicated) directory.

    Splits the x block-axis so each shard owns ~1/S of the allocated
    blocks: per-x-layer occupancy -> cumulative sum -> the first layer
    index whose prefix crosses each s/S quantile.  Cheap enough to run on
    the fetched directory at policy cadence (Nb^3 <= 64^3 int compares).
    """
    nb = blk.num_blocks_per_axis(cfg)
    occ = np.asarray(directory).reshape(nb, -1)
    occ_x = (occ >= 0).sum(axis=1).astype(np.int64)
    csum = np.cumsum(occ_x)
    total = int(csum[-1])
    targets = (np.arange(1, num_shards) * total) // num_shards
    # cut[s] = first layer index NOT owned by shards < s+1.
    cuts = np.searchsorted(csum, targets, side="left") + 1
    cuts = np.clip(cuts, 1, nb - 1)
    # Monotonicity under ties (empty slabs are allowed but keep order).
    cuts = np.maximum.accumulate(cuts)
    return jnp.asarray(cuts, jnp.int32)


def allocate(cfg: TsdfConfig, num_shards: int, with_color: bool = True) -> ShardedBlockMap:
    nb = blk.num_blocks_per_axis(cfg)
    cl = cfg.table_capacity // num_shards
    c = cl * num_shards
    b3 = cfg.block_size**3
    return ShardedBlockMap(
        directory=jnp.full((nb, nb, nb), -1, jnp.int32),
        block_coords=jnp.full((c, 3), -1, jnp.int32),
        n_active=jnp.zeros((num_shards,), jnp.int32),
        overflow=jnp.zeros((num_shards,), jnp.int32),
        sdf=jnp.full((c, b3), blk.UNOBSERVED, jnp.float32),
        weight=jnp.zeros((c, b3), jnp.float32),
        color=jnp.zeros((c, 3 * b3 if with_color else 0), jnp.float32),
        cuts=uniform_cuts(cfg, num_shards),
    )


def _slab_of(bx: jnp.ndarray, cuts: jnp.ndarray) -> jnp.ndarray:
    """Owner shard of block x-coord `bx` under the slab partition `cuts`.

    cuts is tiny (S-1 entries) and ascending, so ownership is a sum of
    elementwise compares — no gather (a searchsorted analog).
    """
    if cuts.shape[0] == 0:
        return jnp.zeros_like(bx)
    return jnp.sum(
        (bx[..., None] >= cuts[(None,) * bx.ndim]).astype(jnp.int32), axis=-1
    )


def _integrate_shard(
    directory, coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l,
    cuts, depth, color, T_wc, *, intr: Intrinsics, cfg: TsdfConfig,
    num_shards: int, max_touched: int,
):
    """Per-shard body: allocate my slab's blocks, update my rows."""
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    b3 = cfg.block_size**3
    n_active = n_active_l[0]

    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)  # replicated
    dir_flat = directory.reshape(-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb * nb * nb, 1), 0)[:, 0]
    bx = idx // (nb * nb)
    mine = _slab_of(bx, cuts) == sid

    # --- allocation (local prefix sum, pmax merge of disjoint proposals)
    need = touched & (dir_flat < 0) & mine
    order = jnp.cumsum(need.astype(jnp.int32)) - 1
    local_slot = n_active + order
    fits = need & (local_slot < cl)
    gslot = sid * cl + local_slot
    proposal = jnp.where(fits, gslot, -1)
    merged = jax.lax.pmax(proposal, SHARD_AXIS)
    dir_new = jnp.where((dir_flat < 0) & (merged >= 0), merged, dir_flat)

    n_new = jnp.sum(fits.astype(jnp.int32))
    n_drop = jnp.sum((need & ~fits).astype(jnp.int32))
    coords = jnp.stack([bx, (idx // nb) % nb, idx % nb], axis=-1)
    scat = jnp.where(fits, local_slot, cl)
    coords_l = coords_l.at[scat].set(coords, mode="drop")
    n_active_l = n_active_l + n_new
    overflow_l = overflow_l + n_drop

    # --- integrate my touched rows (zero communication)
    touched_mine = touched & mine & (dir_new >= 0)
    k = min(max_touched, nb * nb * nb)
    tidx, tvalid = blk.compact_mask_indices(touched_mine, k)
    gslots = dir_new[tidx]
    lslots = gslots - sid * cl
    valid = tvalid & (lslots >= 0) & (lslots < cl)
    lslots = jnp.where(valid, lslots, 0)

    from instancefusion_tpu.geometry.camera import project
    from instancefusion_tpu.geometry.se3 import se3_inverse, transform_points

    bcoords = coords_l[lslots]
    local = blk._local_offsets(cfg)
    origin = jnp.asarray(cfg.origin, jnp.float32)
    vox = bcoords[:, None, :] * cfg.block_size + local[None, :, :]
    p_w = origin + (vox.astype(jnp.float32) + 0.5) * cfg.voxel_size
    T_cw = se3_inverse(T_wc)
    p_c = transform_points(T_cw, p_w.reshape(-1, 3)).reshape(p_w.shape)
    u, v, z = project(intr, p_c)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)
    d = depth[vic, uic]
    sdf_obs = d - z
    ok = in_img & (z > 0.0) & (d > 0.0) & (sdf_obs > -cfg.trunc) & valid[:, None]
    psi = jnp.clip(sdf_obs / cfg.trunc, -1.0, 1.0)
    w_obs = jnp.where(ok, 1.0, 0.0)
    sdf_old = sdf_l[lslots]
    w_old = w_l[lslots]
    w_new = w_old + w_obs
    denom = jnp.maximum(w_new, 1e-6)
    # Preserve the UNOBSERVED sentinel where nothing has ever been fused
    # (0/denom would silently write 0.0 and corrupt sentinel validity).
    sdf_new = jnp.where(
        w_new > 0.0, (sdf_old * w_old + psi * w_obs) / denom, sdf_old
    )
    w_new = jnp.minimum(w_new, cfg.max_weight)
    out = jnp.where(valid, lslots, cl)
    sdf_l = sdf_l.at[out].set(sdf_new, mode="drop")
    w_l = w_l.at[out].set(w_new, mode="drop")
    if col_l.shape[1]:
        c_old = col_l[lslots]  # (K, 3*B^3) packed
        c_obs = blk.pack_color(color[vic, uic])
        w3 = jnp.tile(w_old, (1, 3))
        c_new = (c_old * w3 + c_obs * jnp.tile(w_obs, (1, 3))) / jnp.tile(
            denom, (1, 3)
        )
        col_l = col_l.at[out].set(c_new, mode="drop")

    return dir_new.reshape(directory.shape), coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l


# Jitted so that eager callers (tests, tools) compile each configuration
# once; inside the engine's jitted step this is inlined.
@functools.partial(
    jax.jit, static_argnames=("mesh", "intr", "cfg", "max_touched")
)
def integrate(
    bm: ShardedBlockMap,
    depth: jnp.ndarray,
    color: jnp.ndarray | None,
    T_wc: jnp.ndarray,
    mesh: Mesh,
    intr: Intrinsics,
    cfg: TsdfConfig,
    max_touched: int = 8192,
) -> ShardedBlockMap:
    num_shards = mesh.shape[SHARD_AXIS]
    color_in = color if color is not None else jnp.zeros(
        (intr.height, intr.width, 3), jnp.float32
    )
    fn = shard_map(
        functools.partial(
            _integrate_shard, intr=intr, cfg=cfg, num_shards=num_shards,
            max_touched=max_touched,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(), P(), P(), P(),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
        ),
        check_vma=False,
    )
    directory, coords, n_active, overflow, sdf, w, col = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, bm.cuts, depth, color_in, T_wc,
    )
    return bm._replace(
        directory=directory, block_coords=coords, n_active=n_active,
        overflow=overflow, sdf=sdf, weight=w, color=col,
    )


def _halo_exchange(
    directory, coords_l, sdf_l, w_l, col_l, cuts, *, cfg: TsdfConfig,
    num_shards: int, halo_cap: int, sid,
):
    """ppermute my slab-boundary block rows to both neighbors.

    Returns (halo_dir_flat i32[Nb^3] mapping block -> halo row or -1,
    halo_sdf, halo_w, halo_col) on each shard.
    """
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    dir_flat = directory.reshape(-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb * nb * nb, 1), 0)[:, 0]
    bx = idx // (nb * nb)
    owner = _slab_of(bx, cuts)
    # My slab is [lo, hi) on the x block-axis under the (possibly
    # rebalanced) cut partition.
    cuts_ext = jnp.concatenate([
        jnp.zeros((1,), jnp.int32), cuts, jnp.full((1,), nb, jnp.int32)
    ])
    lo = cuts_ext[sid]
    hi = cuts_ext[sid + 1]

    def boundary_rows(layer_bx):
        """Compact my allocated blocks at x-layer `layer_bx` (<= halo_cap)."""
        sel = (bx == layer_bx) & (owner == sid) & (dir_flat >= 0)
        tidx, ok = blk.compact_mask_indices(sel, halo_cap)
        gslot = dir_flat[tidx]
        lslot = jnp.clip(gslot - sid * cl, 0, cl - 1)
        rows_sdf = jnp.where(ok[:, None], sdf_l[lslot], blk.UNOBSERVED)
        rows_w = jnp.where(ok[:, None], w_l[lslot], 0.0)
        rows_col = (
            jnp.where(ok[:, None], col_l[lslot], 0.0)
            if col_l.shape[1]
            else col_l[:halo_cap] if col_l.shape[0] >= halo_cap
            else jnp.zeros((halo_cap, 0), col_l.dtype)
        )
        block_id = jnp.where(ok, tidx, -1)
        return block_id, rows_sdf, rows_w, rows_col

    # Send my last layer right, my first layer left.  (An empty slab —
    # possible after an aggressive rebalance — selects nothing; the
    # neighbor then sees an all-invalid halo, which is correct.)
    right_payload = boundary_rows(hi - 1)
    left_payload = boundary_rows(lo)
    perm_r = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    perm_l = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    from_left = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, SHARD_AXIS, perm_r), right_payload
    )
    from_right = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, SHARD_AXIS, perm_l), left_payload
    )

    # Drop wrapped-ring halos at the ends (shard 0 has no left neighbor).
    def mask_payload(payload, valid):
        bid, s, w, c = payload
        return (
            jnp.where(valid, bid, -1), s, w, c,
        )

    from_left = mask_payload(from_left, sid > 0)
    from_right = mask_payload(from_right, sid < num_shards - 1)

    halo_sdf = jnp.concatenate([from_left[1], from_right[1]], axis=0)
    halo_w = jnp.concatenate([from_left[2], from_right[2]], axis=0)
    halo_col = jnp.concatenate([from_left[3], from_right[3]], axis=0)
    halo_dir = jnp.full((nb * nb * nb,), -1, jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (halo_cap, 1), 0)[:, 0]
    bid_l = jnp.where(from_left[0] >= 0, from_left[0], nb * nb * nb)
    halo_dir = halo_dir.at[bid_l].set(rows, mode="drop")
    bid_r = jnp.where(from_right[0] >= 0, from_right[0], nb * nb * nb)
    halo_dir = halo_dir.at[bid_r].set(rows + halo_cap, mode="drop")
    return halo_dir, halo_sdf, halo_w, halo_col


def _raycast_shard(
    directory, coords_l, sdf_l, w_l, col_l, cuts, T_wc, prior,
    *, intr: Intrinsics, tsdf_cfg: TsdfConfig, rc_cfg, num_shards: int,
    halo_cap: int, with_color: bool, screen_space_normals: bool,
):
    """Per-shard raycast over (my slab + halo), then pmin composite.

    `prior` and `screen_space_normals` are `blocks.raycast`'s per-frame
    fast paths (prior None = full sweep); image-space normals are taken per
    shard, so pixels next to a surface another shard owns lose validity.
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(tsdf_cfg)
    cl = sdf_l.shape[0]
    b3 = tsdf_cfg.block_size**3

    halo_dir, halo_sdf, halo_w, halo_col = _halo_exchange(
        directory, coords_l, sdf_l, w_l, col_l, cuts, cfg=tsdf_cfg,
        num_shards=num_shards, halo_cap=halo_cap, sid=sid,
    )

    # Shard-local sampling directory: my rows at [0, cl), halo rows appended.
    dir_flat = directory.reshape(-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb * nb * nb, 1), 0)[:, 0]
    owner = _slab_of(idx // (nb * nb), cuts)
    local_slot = dir_flat - sid * cl
    ldir = jnp.where(
        (owner == sid) & (dir_flat >= 0), local_slot,
        jnp.where(halo_dir >= 0, cl + halo_dir, -1),
    ).astype(jnp.int32)

    local_bm = blk.BlockMap(
        directory=ldir.reshape(nb, nb, nb),
        block_coords=coords_l,  # unused by sampling
        n_active=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
        sdf=jnp.concatenate([sdf_l, halo_sdf], axis=0),
        weight=jnp.concatenate([w_l, halo_w], axis=0),
        color=jnp.concatenate([col_l, halo_col], axis=0)
        if col_l.shape[1]
        else col_l,
    )
    maps = blk.raycast(
        local_bm, T_wc, intr, tsdf_cfg, rc_cfg, with_color=with_color,
        depth_prior=prior, screen_space_normals=screen_space_normals,
    )

    # psum-min composite: the shard whose slab contains the first surface
    # along each ray wins the pixel.
    inf = jnp.float32(3.4e38)
    my_depth = jnp.where(maps.valid, maps.depth, inf)
    best = jax.lax.pmin(my_depth, SHARD_AXIS)
    win = maps.valid & (my_depth <= best)
    nwin = jnp.maximum(jax.lax.psum(win.astype(jnp.float32), SHARD_AXIS), 1.0)

    def blend(x, extra_dims):
        m = win.astype(jnp.float32).reshape(win.shape + (1,) * extra_dims)
        return jax.lax.psum(x * m, SHARD_AXIS) / nwin.reshape(
            nwin.shape + (1,) * extra_dims
        )

    any_valid = jax.lax.psum(win.astype(jnp.int32), SHARD_AXIS) > 0
    return type(maps)(
        vertex_w=blend(maps.vertex_w, 1),
        normal_w=blend(maps.normal_w, 1),
        depth=blend(maps.depth, 0),
        color=blend(maps.color, 1),
        valid=any_valid,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "intr", "tsdf_cfg", "rc_cfg", "halo_cap",
                     "with_color", "screen_space_normals"),
)
def raycast(
    bm: ShardedBlockMap,
    T_wc: jnp.ndarray,
    mesh: Mesh,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    rc_cfg,
    halo_cap: int = 1024,
    with_color: bool = True,
    depth_prior: jnp.ndarray | None = None,
    screen_space_normals: bool = False,
):
    """Marched prediction of the sharded map (`blocks.raycast` semantics:
    `depth_prior` and `screen_space_normals` as there)."""
    num_shards = mesh.shape[SHARD_AXIS]
    nb = blk.num_blocks_per_axis(tsdf_cfg)
    # A slab boundary layer holds at most nb^2 blocks.
    halo_cap = min(halo_cap, nb * nb)
    fn = shard_map(
        functools.partial(
            _raycast_shard, intr=intr, tsdf_cfg=tsdf_cfg, rc_cfg=rc_cfg,
            num_shards=num_shards, halo_cap=halo_cap, with_color=with_color,
            screen_space_normals=screen_space_normals,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return fn(
        bm.directory, bm.block_coords, bm.sdf, bm.weight, bm.color,
        bm.cuts, T_wc, depth_prior,
    )


# ---------------------------------------------------------------------------
# Fused fast-path step: list-based allocation + slot integrate + splat
# raycast per shard (the round-3 single-chip fast paths, sharded)
# ---------------------------------------------------------------------------


def _alloc_from_band(
    directory, coords_l, n_active_vec, overflow_vec, cuts, depth, T_wc, sid,
    *, intr: Intrinsics, cfg: TsdfConfig, num_shards: int,
    samples: int = 3, stride: int = 4, alloc_cap: int = 4096,
):
    """Replicated list-based allocation of this frame's band blocks.

    The sharded analog of `blocks.discover_allocate` with ZERO
    collectives: the band candidate list, its dedup, and every shard's
    prefix-sum slot assignment are deterministic functions of replicated
    inputs (depth, pose, directory) plus the REPLICATED per-shard
    n_active vector — so all shards compute the identical allocation plan
    and directory update locally; each shard scatters only its own
    coords rows.  This replaces `_integrate_shard`'s Nb^3 cumsum + pmax
    merge (the round-3 profile's dominant map-bookkeeping cost).
    """
    from instancefusion_tpu.geometry.camera import ray_directions
    from instancefusion_tpu.ops.common import decimate

    nb = blk.num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    cl = coords_l.shape[0]

    rays = ray_directions(intr)
    if stride > 1:
        rays = decimate(rays, stride)
        depth_s = decimate(depth, stride)
    else:
        depth_s = depth
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    dirs_w = jnp.matmul(rays.reshape(-1, 3), R.T, precision=_PREC)
    d = depth_s.reshape(-1)
    valid = d > 0.0
    band = cfg.trunc + cfg.voxel_size
    offs = jnp.linspace(-band, band, samples)
    origin = jnp.asarray(cfg.origin, jnp.float32)
    bsz = cfg.block_size * cfg.voxel_size
    ids = []
    for i in range(samples):
        p = o[None, :] + dirs_w * (d + offs[i])[:, None]
        g = jnp.floor((p - origin) / bsz).astype(jnp.int32)
        inb = jnp.all((g >= 0) & (g < nb), axis=-1) & valid
        flat = (g[:, 0] * nb + g[:, 1]) * nb + g[:, 2]
        ids.append(jnp.where(inb, flat, -1))
    flat_all = jnp.concatenate(ids)

    srt = jnp.sort(flat_all)
    prev_s = jnp.concatenate([jnp.full((1,), -2, jnp.int32), srt[:-1]])
    first = (srt >= 0) & (srt != prev_s)
    alloc_cap = min(alloc_cap, flat_all.shape[0])
    top, _ = jax.lax.top_k(jnp.where(first, srt, -1), alloc_cap)
    dir_flat = directory.reshape(-1)
    have = dir_flat[jnp.maximum(top, 0)] >= 0
    uniq = (top >= 0) & jnp.logical_not(have)
    owner = _slab_of(top // (nb * nb), cuts)
    coords_top = jnp.stack(
        [top // (nb * nb), (top // nb) % nb, top % nb], axis=-1
    ).astype(jnp.int32)

    new_dir = dir_flat
    for sh in range(num_shards):
        mine = uniq & (owner == sh)
        order = jnp.cumsum(mine.astype(jnp.int32)) - 1
        lslot = n_active_vec[sh] + order
        # Each shard's LAST group of rows stays unallocated
        # (blocks.RESERVED_SLOTS).
        fits = mine & (lslot < cl - blk.RESERVED_SLOTS)
        gslot = sh * cl + lslot
        dir_ids = jnp.where(fits, top, nb3)  # OOB -> dropped
        new_dir = new_dir.at[dir_ids].set(gslot, mode="drop")
        n_new = jnp.sum(fits.astype(jnp.int32))
        n_drop = jnp.sum(mine.astype(jnp.int32)) - n_new
        n_active_vec = n_active_vec.at[sh].add(n_new)
        overflow_vec = overflow_vec.at[sh].add(n_drop)
        # Only the owner shard writes its coords rows.
        row = jnp.where(fits & (sh == sid), lslot, cl)  # OOB -> dropped
        coords_l = coords_l.at[row].set(coords_top, mode="drop")

    return new_dir.reshape(directory.shape), coords_l, n_active_vec, overflow_vec


def _fused_step_shard(
    directory, coords_l, n_active_vec, overflow_vec, sdf_l, w_l, col_l,
    cuts, depth, color, prior, T_wc,
    *, intr: Intrinsics, cfg: TsdfConfig, rc_cfg, num_shards: int,
    k_local: int, alloc_cap: int, with_color: bool, pred_color: bool,
    color_gain: float,
):
    """Per-shard splat-path body: allocate -> integrate own rows -> splat.

    The single-chip splat path (engine/slam._splat_map_update) running
    inside the shard bodies: per-shard work is proportional to the shard's
    OWN in-frustum block count.

    Compositing is EXACT: the splat outputs are scatter-add accumulator
    planes and shards own disjoint row sets, so one psum of the raw
    planes followed by a single replicated normalization
    (finish_splat_images) reproduces the single-chip image up to f32
    summation order — no pmin depth-winner heuristic at seams.
    """
    from instancefusion_tpu.ops.splat import finish_splat_images, splat_depth

    sid = jax.lax.axis_index(SHARD_AXIS)

    directory, coords_l, n_active_vec, overflow_vec = _alloc_from_band(
        directory, coords_l, n_active_vec, overflow_vec, cuts, depth, T_wc,
        sid, intr=intr, cfg=cfg, num_shards=num_shards, alloc_cap=alloc_cap,
    )

    local_bm = blk.BlockMap(
        directory=directory,
        block_coords=coords_l,
        n_active=n_active_vec[sid],
        overflow=jnp.zeros((), jnp.int32),
        sdf=sdf_l,
        weight=w_l,
        color=col_l,
    )
    want_color = pred_color and bool(col_l.shape[1])
    inview = blk.frustum_mask(
        local_bm, T_wc, intr, cfg, rc_cfg.near, rc_cfg.far
    )
    lslots, lvalid = blk.compact_mask_indices(inview, k_local)
    local_bm = blk.integrate_slots(
        local_bm, lslots, lvalid, depth,
        color if with_color else None, T_wc, intr, cfg,
        color_gain=color_gain,
    )
    raw = splat_depth(
        lslots, lvalid, coords_l,
        local_bm.sdf, local_bm.weight, local_bm.color,
        T_wc, intr, cfg, with_color=want_color,
        rmax=rc_cfg.splat_rmax, raw=True,
    )

    # Exact composite: psum the disjoint shards' raw accumulator planes,
    # normalize once; then finish vertex/normal maps replicated —
    # image-space normals need the full composited depth.
    raw_sum = tuple(jax.lax.psum(o, SHARD_AXIS) for o in raw)
    imgs = finish_splat_images(
        raw_sum, intr, cfg, with_color=want_color, depth_prior=prior
    )
    maps = blk.splat_maps(imgs, T_wc, intr)
    return (
        directory, coords_l, n_active_vec, overflow_vec,
        local_bm.sdf, local_bm.weight, local_bm.color,
        maps.vertex_w, maps.normal_w, maps.depth, maps.color, maps.valid,
    )


def fused_step_map(
    bm: ShardedBlockMap,
    depth: jnp.ndarray,
    color: jnp.ndarray | None,
    prior: jnp.ndarray,
    T_wc: jnp.ndarray,
    mesh: Mesh,
    intr: Intrinsics,
    cfg: TsdfConfig,
    rc_cfg,
    pred_color: bool = True,
    k_local: int | None = None,
    alloc_cap: int = 4096,
    color_gain: float = 1.0,
):
    """Sharded splat-path map update: (allocate + integrate + splat predict).

    One shard_map call per frame covering all map work — the sharded
    equivalent of engine/slam.step's `use_splat` path.
    Returns (ShardedBlockMap, RaycastMaps).
    """
    from instancefusion_tpu.ops.raycast import RaycastMaps

    num_shards = mesh.shape[SHARD_AXIS]
    if k_local is None:
        k_local = max(256, cfg.touched_capacity // num_shards)
    with_color = color is not None and bm.color.shape[1] > 0
    color_in = color if with_color else jnp.zeros(
        (intr.height, intr.width, 3), jnp.float32
    )
    fn = shard_map(
        functools.partial(
            _fused_step_shard, intr=intr, cfg=cfg, rc_cfg=rc_cfg,
            num_shards=num_shards, k_local=k_local, alloc_cap=alloc_cap,
            with_color=with_color, pred_color=pred_color,
            color_gain=color_gain,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(), P(),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(), P(), P(), P(), P(),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(), P(),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(), P(), P(), P(), P(),
        ),
        check_vma=False,
    )
    (directory, coords, n_active, overflow, sdf, w, col,
     vert, norm, dep, colimg, valid) = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, bm.cuts, depth, color_in, prior, T_wc,
    )
    new_bm = bm._replace(
        directory=directory, block_coords=coords, n_active=n_active,
        overflow=overflow, sdf=sdf, weight=w, color=col,
    )
    maps = RaycastMaps(
        vertex_w=vert, normal_w=norm, depth=dep, color=colimg, valid=valid
    )
    return new_bm, maps


def allocate_votes(cfg: TsdfConfig, num_shards: int):
    """Per-voxel instance-vote planes, sharded like the block payloads."""
    from instancefusion_tpu.ops import labels

    cl = cfg.table_capacity // num_shards
    c = cl * num_shards
    b3 = cfg.block_size**3
    return labels.LabelVotes(
        label=jnp.full((c, b3), -1, jnp.int32),
        count=jnp.zeros((c, b3), jnp.float32),
    )


def _fuse_labels_shard(
    directory, coords_l, lab_l, cnt_l, cuts, gid_image, depth, T_wc,
    *, intr: Intrinsics, cfg: TsdfConfig, num_shards: int, max_touched: int,
):
    """Per-shard Boyer-Moore label voting into my touched rows (zero comm).

    The distributed half of the BASELINE mandate "instance masks ... fused
    probabilistically into the sharded volume": the frame's instance-id
    image is replicated (it is one camera's view), each shard votes into
    the band voxels of the touched blocks *it owns* — the same
    zero-communication ownership split as `_integrate_shard`.
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = lab_l.shape[0]

    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)
    dir_flat = directory.reshape(-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb * nb * nb, 1), 0)[:, 0]
    mine = _slab_of(idx // (nb * nb), cuts) == sid
    touched_mine = touched & mine & (dir_flat >= 0)
    k = min(max_touched, nb * nb * nb)
    tidx, tvalid = blk.compact_mask_indices(touched_mine, k)
    gslots = dir_flat[tidx]
    lslots = gslots - sid * cl
    valid = tvalid & (lslots >= 0) & (lslots < cl)
    lslots = jnp.where(valid, lslots, 0)

    from instancefusion_tpu.geometry.camera import project
    from instancefusion_tpu.geometry.se3 import se3_inverse, transform_points

    bcoords = coords_l[lslots]
    local = blk._local_offsets(cfg)
    origin = jnp.asarray(cfg.origin, jnp.float32)
    vox = bcoords[:, None, :] * cfg.block_size + local[None, :, :]
    p_w = origin + (vox.astype(jnp.float32) + 0.5) * cfg.voxel_size
    p_c = transform_points(se3_inverse(T_wc), p_w.reshape(-1, 3)).reshape(p_w.shape)
    u, v, z = project(intr, p_c)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)
    d = depth[vic, uic]
    gid = gid_image[vic, uic]
    obs = (
        in_img & (z > 0.0) & (d > 0.0) & (jnp.abs(d - z) < cfg.trunc)
        & (gid >= 0) & valid[:, None]
    )
    lab = lab_l[lslots]
    cnt = cnt_l[lslots]
    adopt = obs & (cnt <= 0.0)
    same = obs & (lab == gid) & ~adopt
    other = obs & ~adopt & ~same
    lab_new = jnp.where(adopt, gid, lab)
    cnt_new = jnp.where(
        adopt, 1.0, jnp.where(same, cnt + 1.0, jnp.where(other, cnt - 1.0, cnt))
    )
    out = jnp.where(valid, lslots, cl)
    return (
        lab_l.at[out].set(lab_new, mode="drop"),
        cnt_l.at[out].set(cnt_new, mode="drop"),
    )


def fuse_labels(
    votes,
    bm: ShardedBlockMap,
    gid_image: jnp.ndarray,
    depth: jnp.ndarray,
    T_wc: jnp.ndarray,
    mesh: Mesh,
    intr: Intrinsics,
    cfg: TsdfConfig,
    max_touched: int = 8192,
):
    """Distributed per-voxel label voting (ops/labels.fuse on shards)."""
    from instancefusion_tpu.ops import labels

    num_shards = mesh.shape[SHARD_AXIS]
    fn = shard_map(
        functools.partial(
            _fuse_labels_shard, intr=intr, cfg=cfg, num_shards=num_shards,
            max_touched=max_touched,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P(),
            P(),
        ),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )
    lab, cnt = fn(
        bm.directory, bm.block_coords, votes.label, votes.count, bm.cuts,
        gid_image, depth, T_wc,
    )
    return labels.LabelVotes(label=lab, count=cnt)


def sample_labels(
    votes,
    bm: ShardedBlockMap,
    p_w: jnp.ndarray,  # (H,W,3) world points (raycast hits)
    valid_in: jnp.ndarray,  # (H,W) bool
    mesh: Mesh,
    cfg: TsdfConfig,
) -> jnp.ndarray:
    """Predicted instance-id image from sharded votes: pmax composite.

    Each shard looks up labels only for pixels whose containing block it
    owns (others read -1); since ownership is exclusive, a single `pmax`
    composites the full id image on every shard — the collective analog
    of the reference's instance-index render pass.
    """
    num_shards = mesh.shape[SHARD_AXIS]

    def body(directory, lab_l, cnt_l, p_w, valid_in):
        sid = jax.lax.axis_index(SHARD_AXIS)
        nb = blk.num_blocks_per_axis(cfg)
        b = cfg.block_size
        b3 = b * b * b
        cl = lab_l.shape[0]
        n = cfg.grid_size
        g = jnp.round(
            (p_w - jnp.asarray(cfg.origin, p_w.dtype)) / cfg.voxel_size - 0.5
        ).astype(jnp.int32)
        inb = jnp.all((g >= 0) & (g < n), axis=-1) & valid_in
        gc = jnp.clip(g, 0, n - 1)
        blkc = gc // b
        loc = gc - blkc * b
        bflat = (blkc[..., 0] * nb + blkc[..., 1]) * nb + blkc[..., 2]
        slot = directory.reshape(-1)[bflat]
        lslot = slot - sid * cl
        have = inb & (slot >= 0) & (lslot >= 0) & (lslot < cl)
        lidx = jnp.clip(lslot, 0, cl - 1) * b3 + (
            (loc[..., 0] * b + loc[..., 1]) * b + loc[..., 2]
        )
        lab = lab_l.reshape(-1)[lidx]
        cnt = cnt_l.reshape(-1)[lidx]
        mine = jnp.where(have & (cnt > 0.0), lab, -1)
        return jax.lax.pmax(mine, SHARD_AXIS)

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(bm.directory, votes.label, votes.count, p_w, valid_in)


def _reshard_shard(
    directory, coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l,
    lab_l, cnt_l, cuts,
    *, cfg: TsdfConfig, num_shards: int, migrate_cap: int, with_votes: bool,
):
    """Per-shard body: migrate misplaced rows to their slab owner.

    Rows land on the wrong shard when the slab partition moves — the
    occupancy-rebalance policy writes new `cuts` (balanced_cuts) and this
    body drains the rows to their new owners via one `all_to_all` — or
    after host-side map surgery (a checkpoint written with a different
    shard count, a merged map).  Each shard packs up to `migrate_cap`
    rows per destination; receivers append the rows with the usual
    prefix-sum allocation.  Per-voxel instance votes ride along with
    their payload rows (they share the slot space).  The directory is
    rebuilt from scratch (scatter + pmax merge) so it stays consistent
    with the new row placement.
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    q = migrate_cap
    n_active = n_active_l[0]

    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0]
    allocated = (slot_ids < n_active) & (coords_l[:, 0] >= 0)
    owner = _slab_of(coords_l[:, 0], cuts)
    stay = allocated & (owner == sid)

    # --- pack per-destination send buckets [S*q, ...]
    send = {k: [] for k in ("coords", "sdf", "w", "col", "lab", "cnt", "valid")}
    sent = jnp.zeros((cl,), bool)
    for d in range(num_shards):
        mask = allocated & (owner == d) & (d != sid)
        idx, ok = blk.compact_mask_indices(mask, q)
        idx_c = jnp.where(ok, idx, 0)
        send["coords"].append(jnp.where(ok[:, None], coords_l[idx_c], -1))
        send["sdf"].append(sdf_l[idx_c])
        send["w"].append(jnp.where(ok[:, None], w_l[idx_c], 0.0))
        if col_l.shape[1]:
            send["col"].append(jnp.where(ok[:, None], col_l[idx_c], 0.0))
        if with_votes:
            send["lab"].append(jnp.where(ok[:, None], lab_l[idx_c], -1))
            send["cnt"].append(jnp.where(ok[:, None], cnt_l[idx_c], 0.0))
        send["valid"].append(ok)
        sent = sent.at[jnp.where(ok, idx, cl)].set(True, mode="drop")

    def a2a(parts):
        x = jnp.concatenate(parts, axis=0)  # [S*q, ...]
        return jax.lax.all_to_all(
            x, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True
        )

    rc_coords = a2a(send["coords"])
    rc_sdf = a2a(send["sdf"])
    rc_w = a2a(send["w"])
    rc_valid = a2a(send["valid"])
    rc_col = a2a(send["col"]) if col_l.shape[1] else None
    rc_lab = a2a(send["lab"]) if with_votes else None
    rc_cnt = a2a(send["cnt"]) if with_votes else None

    # Rows that could not be packed this round (beyond migrate_cap) stay
    # put and are counted; call reshard again to drain them.
    leftover = allocated & (owner != sid) & jnp.logical_not(sent)
    n_left = jnp.sum(leftover.astype(jnp.int32))
    n_sent = jnp.sum((allocated & (owner != sid) & sent).astype(jnp.int32))

    # --- compact keepers (stable partition, as blocks.clean)
    keep = stay | leftover
    n_keep = jnp.sum(keep.astype(jnp.int32))
    perm = jnp.argsort(jnp.logical_not(keep), stable=True)

    def take(arr, fill):
        out = arr[perm]
        ki = jax.lax.broadcasted_iota(jnp.int32, (out.shape[0], 1), 0)[:, 0] < n_keep
        shape = (out.shape[0],) + (1,) * (out.ndim - 1)
        return jnp.where(ki.reshape(shape), out, fill)

    coords_n = take(coords_l, -1)
    sdf_n = take(sdf_l, blk.UNOBSERVED)
    w_n = take(w_l, 0.0)
    col_n = take(col_l, 0.0) if col_l.shape[1] else col_l
    lab_n = take(lab_l, -1) if with_votes else lab_l
    cnt_n = take(cnt_l, 0.0) if with_votes else cnt_l

    # --- append received rows (prefix-sum slots after the keepers;
    # the last group stays reserved, blocks.RESERVED_SLOTS)
    order = jnp.cumsum(rc_valid.astype(jnp.int32)) - 1
    slot = n_keep + order
    fits = rc_valid & (slot < cl - blk.RESERVED_SLOTS)
    out = jnp.where(fits, slot, cl)
    coords_n = coords_n.at[out].set(rc_coords, mode="drop")
    sdf_n = sdf_n.at[out].set(rc_sdf, mode="drop")
    w_n = w_n.at[out].set(rc_w, mode="drop")
    if col_l.shape[1]:
        col_n = col_n.at[out].set(rc_col, mode="drop")
    if with_votes:
        lab_n = lab_n.at[out].set(rc_lab, mode="drop")
        cnt_n = cnt_n.at[out].set(rc_cnt, mode="drop")
    n_new = jnp.sum(fits.astype(jnp.int32))
    n_drop = jnp.sum(rc_valid.astype(jnp.int32)) - n_new
    n_active_n = n_keep + n_new
    overflow_n = overflow_l + n_drop

    # --- rebuild the replicated directory: scatter my rows, pmax merge
    live = jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0] < n_active_n
    live = live & (coords_n[:, 0] >= 0)
    flat = (coords_n[:, 0] * nb + coords_n[:, 1]) * nb + coords_n[:, 2]
    gslot = sid * cl + jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0]
    prop = jnp.full((nb * nb * nb,), -1, jnp.int32)
    prop = prop.at[jnp.where(live, flat, nb * nb * nb)].set(gslot, mode="drop")
    dir_new = jax.lax.pmax(prop, SHARD_AXIS)

    return (
        dir_new.reshape(directory.shape), coords_n,
        n_active_l * 0 + n_active_n, overflow_n, sdf_n, w_n, col_n,
        lab_n, cnt_n,
        jnp.full((n_active_l.shape[0],), n_left, jnp.int32),
        jnp.full((n_active_l.shape[0],), n_sent, jnp.int32),
    )


def reshard(
    bm: ShardedBlockMap,
    mesh: Mesh,
    cfg: TsdfConfig,
    votes=None,
    migrate_cap: int = 256,
):
    """Migrate every payload row to its slab owner (one all_to_all round).

    Owners come from `bm.cuts` — write rebalanced cuts (balanced_cuts)
    into the map first, then call this to drain the rows to their new
    shards.  When `votes` is given, its label/count planes migrate with
    their payload rows.

    Returns (bm_new, votes_new, migrated i32[S], leftover i32[S]):
    `migrated` counts rows each shard sent this round; `leftover` counts
    rows still misplaced because a shard had more than `migrate_cap`
    rows bound for one destination — call again until
    `leftover.sum() == 0`.
    """
    from instancefusion_tpu.ops import labels

    num_shards = mesh.shape[SHARD_AXIS]
    with_votes = votes is not None
    c = bm.sdf.shape[0]
    lab = votes.label if with_votes else jnp.zeros((c, 1), jnp.int32)
    cnt = votes.count if with_votes else jnp.zeros((c, 1), jnp.float32)
    fn = shard_map(
        functools.partial(
            _reshard_shard, cfg=cfg, num_shards=num_shards,
            migrate_cap=migrate_cap, with_votes=with_votes,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
        ),
        check_vma=False,
    )
    (directory, coords, n_active, overflow, sdf, w, col,
     lab_n, cnt_n, leftover, migrated) = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, lab, cnt, bm.cuts,
    )
    bm_new = bm._replace(
        directory=directory, block_coords=coords, n_active=n_active,
        overflow=overflow, sdf=sdf, weight=w, color=col,
    )
    votes_new = (
        labels.LabelVotes(label=lab_n, count=cnt_n) if with_votes else None
    )
    return bm_new, votes_new, migrated, leftover


# ---------------------------------------------------------------------------
# Sharded map hygiene + streaming (clean / evict / admit)
# ---------------------------------------------------------------------------


def _rebuild_directory_shard(coords_n, n_active_n, cl, nb, sid):
    """Replicated directory from per-shard rows: scatter mine, pmax merge."""
    live = jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0] < n_active_n
    live = live & (coords_n[:, 0] >= 0)
    flat = (coords_n[:, 0] * nb + coords_n[:, 1]) * nb + coords_n[:, 2]
    gslot = sid * cl + jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0]
    prop = jnp.full((nb * nb * nb,), -1, jnp.int32)
    prop = prop.at[jnp.where(live, flat, nb * nb * nb)].set(gslot, mode="drop")
    return jax.lax.pmax(prop, SHARD_AXIS)


def _take_compact(perm, n_keep):
    """Stable-partition compactor: arr -> arr[perm] with tail filled."""

    def take(arr, fill):
        out = arr[perm]
        ki = jax.lax.broadcasted_iota(jnp.int32, (out.shape[0], 1), 0)[:, 0] < n_keep
        shape = (out.shape[0],) + (1,) * (out.ndim - 1)
        return jnp.where(ki.reshape(shape), out, fill)

    return take


def _clean_shard(
    directory, coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l,
    lab_l, cnt_l,
    *, cfg: TsdfConfig, min_weight: float, with_votes: bool,
):
    """Per-shard `blocks.clean`: cull + compact my rows, rebuild directory.

    Row culling and compaction are shard-local by construction (rows
    never reference other shards); the only collective is the directory
    pmax merge — the same trick as `_reshard_shard`.
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    n_active = n_active_l[0]

    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0]
    allocated = (slot_ids < n_active) & (coords_l[:, 0] >= 0)
    best_w = jnp.max(w_l, axis=1)
    observed = jnp.where(w_l > 0.0, sdf_l, blk.UNOBSERVED)
    min_sdf = jnp.min(observed, axis=1)
    empty = min_sdf > 0.98
    live = allocated & (best_w >= min_weight) & jnp.logical_not(empty)
    n_live = jnp.sum(live.astype(jnp.int32))

    perm = jnp.argsort(jnp.logical_not(live), stable=True)
    take = _take_compact(perm, n_live)
    coords_n = take(coords_l, -1)
    sdf_n = take(sdf_l, blk.UNOBSERVED)
    w_n = take(w_l, 0.0)
    col_n = take(col_l, 0.0) if col_l.shape[1] else col_l
    lab_n = take(lab_l, -1) if with_votes else lab_l
    cnt_n = take(cnt_l, 0.0) if with_votes else cnt_l

    dir_new = _rebuild_directory_shard(coords_n, n_live, cl, nb, sid)
    return (
        dir_new.reshape(directory.shape), coords_n,
        n_active_l * 0 + n_live, overflow_l,
        sdf_n, w_n, col_n, lab_n, cnt_n,
    )


def clean(
    bm: ShardedBlockMap,
    mesh: Mesh,
    cfg: TsdfConfig,
    min_weight: float = 1.0,
    votes=None,
):
    """Sharded `blocks.clean`: cull low-confidence/empty blocks per shard.

    Returns (bm_new, votes_new) with instance-vote planes compacted
    consistently when given (they share the slot space).
    """
    from instancefusion_tpu.ops import labels

    num_shards = mesh.shape[SHARD_AXIS]
    with_votes = votes is not None
    c = bm.sdf.shape[0]
    lab = votes.label if with_votes else jnp.zeros((c, 1), jnp.int32)
    cnt = votes.count if with_votes else jnp.zeros((c, 1), jnp.float32)
    fn = shard_map(
        functools.partial(
            _clean_shard, cfg=cfg, min_weight=min_weight,
            with_votes=with_votes,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS),
        ),
        check_vma=False,
    )
    (directory, coords, n_active, overflow, sdf, w, col, lab_n, cnt_n) = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, lab, cnt,
    )
    bm_new = bm._replace(
        directory=directory, block_coords=coords, n_active=n_active,
        overflow=overflow, sdf=sdf, weight=w, color=col,
    )
    votes_new = (
        labels.LabelVotes(label=lab_n, count=cnt_n) if with_votes else None
    )
    return bm_new, votes_new


def _partition_window_shard(
    directory, coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l,
    lab_l, cnt_l, center_w,
    *, cfg: TsdfConfig, radius: float, evict_cap: int, with_votes: bool,
):
    """Per-shard `blocks.partition_window`: evict my cold rows.

    Each shard compacts up to `evict_cap` of ITS OWN cold rows into an
    eviction buffer (sharded output — the host sees [S*evict_cap] rows),
    compacts survivors, and the directory pmax-rebuilds.  Bounded
    device->host traffic per shard, exactly like the single-chip tick.
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    n_active = n_active_l[0]

    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (cl, 1), 0)[:, 0]
    allocated = (slot_ids < n_active) & (coords_l[:, 0] >= 0)
    bsz = cfg.block_size * cfg.voxel_size
    origin = jnp.asarray(cfg.origin, jnp.float32)
    centers = origin + (coords_l.astype(jnp.float32) + 0.5) * bsz
    dist = jnp.linalg.norm(centers - center_w[None, :], axis=-1)
    cold = allocated & (dist > radius)

    eidx, evalid = blk.compact_mask_indices(cold, evict_cap)
    eidx_c = jnp.where(evalid, eidx, 0)
    ev_coords = jnp.where(evalid[:, None], coords_l[eidx_c], -1)
    ev_sdf = sdf_l[eidx_c]
    ev_w = jnp.where(evalid[:, None], w_l[eidx_c], 0.0)
    ev_col = (
        jnp.where(evalid[:, None], col_l[eidx_c], 0.0)
        if col_l.shape[1] else col_l[:evict_cap]
    )
    ev_lab = jnp.where(evalid[:, None], lab_l[eidx_c], -1) if with_votes else lab_l[:evict_cap]
    ev_cnt = jnp.where(evalid[:, None], cnt_l[eidx_c], 0.0) if with_votes else cnt_l[:evict_cap]

    evict_sel = jnp.zeros((cl,), bool).at[
        jnp.where(evalid, eidx, cl)
    ].set(True, mode="drop")
    live = allocated & jnp.logical_not(evict_sel)
    n_live = jnp.sum(live.astype(jnp.int32))
    perm = jnp.argsort(jnp.logical_not(live), stable=True)
    take = _take_compact(perm, n_live)
    coords_n = take(coords_l, -1)
    sdf_n = take(sdf_l, blk.UNOBSERVED)
    w_n = take(w_l, 0.0)
    col_n = take(col_l, 0.0) if col_l.shape[1] else col_l
    lab_n = take(lab_l, -1) if with_votes else lab_l
    cnt_n = take(cnt_l, 0.0) if with_votes else cnt_l

    dir_new = _rebuild_directory_shard(coords_n, n_live, cl, nb, sid)
    return (
        dir_new.reshape(directory.shape), coords_n,
        n_active_l * 0 + n_live, overflow_l,
        sdf_n, w_n, col_n, lab_n, cnt_n,
        ev_coords, ev_sdf, ev_w, ev_col, ev_lab, ev_cnt, evalid,
    )


def partition_window(
    bm: ShardedBlockMap,
    mesh: Mesh,
    cfg: TsdfConfig,
    center_w: jnp.ndarray,
    radius: float,
    evict_cap: int,
    votes=None,
):
    """Sharded `blocks.partition_window`: evict cold rows on every shard.

    Returns (bm_new, votes_new, evicted) where evicted holds
    [S*evict_cap] rows (coords/sdf/weight[/color][/label/count]/valid)
    the host pulls into the per-run store.
    """
    from instancefusion_tpu.ops import labels

    num_shards = mesh.shape[SHARD_AXIS]
    with_votes = votes is not None
    c = bm.sdf.shape[0]
    evict_cap = min(evict_cap, c // num_shards)
    lab = votes.label if with_votes else jnp.zeros((c, 1), jnp.int32)
    cnt = votes.count if with_votes else jnp.zeros((c, 1), jnp.float32)
    fn = shard_map(
        functools.partial(
            _partition_window_shard, cfg=cfg, radius=radius,
            evict_cap=evict_cap, with_votes=with_votes,
        ),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
        ),
        check_vma=False,
    )
    (directory, coords, n_active, overflow, sdf, w, col, lab_n, cnt_n,
     ev_coords, ev_sdf, ev_w, ev_col, ev_lab, ev_cnt, ev_valid) = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, lab, cnt, center_w,
    )
    bm_new = bm._replace(
        directory=directory, block_coords=coords, n_active=n_active,
        overflow=overflow, sdf=sdf, weight=w, color=col,
    )
    votes_new = (
        labels.LabelVotes(label=lab_n, count=cnt_n) if with_votes else None
    )
    evicted = {
        "coords": ev_coords, "sdf": ev_sdf, "weight": ev_w,
        "valid": ev_valid,
    }
    if bm.color.shape[1]:
        evicted["color"] = ev_col
    if with_votes:
        evicted["label"] = ev_lab
        evicted["count"] = ev_cnt
    return bm_new, votes_new, evicted


def _admit_shard(
    directory, coords_l, n_active_l, overflow_l, sdf_l, w_l, col_l,
    lab_l, cnt_l, cuts,
    in_coords, in_sdf, in_w, in_col, in_lab, in_cnt, in_valid,
    *, cfg: TsdfConfig, with_votes: bool,
):
    """Per-shard `blocks.admit_rows`: append the rows I own.

    The admit batch is replicated; each shard prefix-sum-appends only the
    rows whose block x-coord falls in its slab (cuts ownership), skipping
    blocks already in the directory.  fits masks psum to the replicated
    admitted mask (each row has exactly one owner).
    """
    sid = jax.lax.axis_index(SHARD_AXIS)
    nb = blk.num_blocks_per_axis(cfg)
    cl = sdf_l.shape[0]
    n_active = n_active_l[0]

    inb = in_valid & jnp.all((in_coords >= 0) & (in_coords < nb), axis=-1)
    flat = (in_coords[:, 0] * nb + in_coords[:, 1]) * nb + in_coords[:, 2]
    flat_c = jnp.where(inb, flat, 0)
    already = directory.reshape(-1)[flat_c] >= 0
    mine = _slab_of(in_coords[:, 0], cuts) == sid
    need = inb & jnp.logical_not(already) & mine
    order = jnp.cumsum(need.astype(jnp.int32)) - 1
    new_slot = n_active + order
    fits = need & (new_slot < cl - blk.RESERVED_SLOTS)
    n_new = jnp.sum(fits.astype(jnp.int32))
    n_drop = jnp.sum(need.astype(jnp.int32)) - n_new

    dir_ids = jnp.where(fits, flat, nb * nb * nb)
    gslot = sid * cl + new_slot
    dir_prop = jnp.full((nb * nb * nb,), -1, jnp.int32)
    dir_prop = dir_prop.at[dir_ids].set(gslot, mode="drop")
    merged = jax.lax.pmax(dir_prop, SHARD_AXIS)
    dir_flat = directory.reshape(-1)
    dir_new = jnp.where((dir_flat < 0) & (merged >= 0), merged, dir_flat)

    out = jnp.where(fits, new_slot, cl)
    coords_n = coords_l.at[out].set(in_coords, mode="drop")
    sdf_n = sdf_l.at[out].set(in_sdf, mode="drop")
    w_n = w_l.at[out].set(in_w, mode="drop")
    col_n = (
        col_l.at[out].set(in_col, mode="drop") if col_l.shape[1] else col_l
    )
    lab_n = lab_l.at[out].set(in_lab, mode="drop") if with_votes else lab_l
    cnt_n = cnt_l.at[out].set(in_cnt, mode="drop") if with_votes else cnt_l
    admitted = jax.lax.psum(fits.astype(jnp.int32), SHARD_AXIS) > 0
    return (
        dir_new.reshape(directory.shape), coords_n,
        n_active_l + n_new, overflow_l + n_drop,
        sdf_n, w_n, col_n, lab_n, cnt_n, admitted,
    )


def admit_rows(
    bm: ShardedBlockMap,
    mesh: Mesh,
    cfg: TsdfConfig,
    coords: jnp.ndarray,
    sdf: jnp.ndarray,
    weight: jnp.ndarray,
    color: jnp.ndarray | None,
    valid: jnp.ndarray,
    votes=None,
    label: jnp.ndarray | None = None,
    count: jnp.ndarray | None = None,
):
    """Sharded `blocks.admit_rows`: streamed-out rows return to their owner.

    Returns (bm_new, votes_new, admitted bool[E] replicated).
    """
    from instancefusion_tpu.ops import labels

    num_shards = mesh.shape[SHARD_AXIS]
    with_votes = votes is not None and label is not None
    c = bm.sdf.shape[0]
    e = coords.shape[0]
    lab = votes.label if with_votes else jnp.zeros((c, 1), jnp.int32)
    cnt = votes.count if with_votes else jnp.zeros((c, 1), jnp.float32)
    in_col = (
        color if (color is not None and bm.color.shape[1])
        else jnp.zeros((e, 1), jnp.float32)
    )
    in_lab = label if with_votes else jnp.zeros((e, 1), jnp.int32)
    in_cnt = count if with_votes else jnp.zeros((e, 1), jnp.float32)
    fn = shard_map(
        functools.partial(_admit_shard, cfg=cfg, with_votes=with_votes),
        mesh=mesh,
        in_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(),
            P(), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=(
            P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
            P(SHARD_AXIS), P(SHARD_AXIS), P(),
        ),
        check_vma=False,
    )
    (directory, coords_n, n_active, overflow, sdf_n, w_n, col_n,
     lab_n, cnt_n, admitted) = fn(
        bm.directory, bm.block_coords, bm.n_active, bm.overflow,
        bm.sdf, bm.weight, bm.color, lab, cnt, bm.cuts,
        coords, sdf, weight, in_col, in_lab, in_cnt, valid,
    )
    bm_new = bm._replace(
        directory=directory, block_coords=coords_n, n_active=n_active,
        overflow=overflow, sdf=sdf_n, weight=w_n, color=col_n,
    )
    votes_new = (
        labels.LabelVotes(label=lab_n, count=cnt_n) if with_votes else votes
    )
    return bm_new, votes_new, admitted


# ---------------------------------------------------------------------------
# Distributed BA reductions (the "collective Schur BA")
# ---------------------------------------------------------------------------


def sharded_ba_partials(mesh: Mesh):
    """Returns a `partials_fn` for ops/ba.optimize_ba whose observation set
    is sharded over the mesh: shard-local JᵀJ/Jᵀr partial sums -> psum."""

    def partials(poses, points, obs: ba.BAObservations):
        def body(poses, points, obs):
            parts = ba.ba_partials(poses, points, obs)
            return jax.tree_util.tree_map(
                lambda x: jax.lax.psum(x, SHARD_AXIS), parts
            )

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(), P(SHARD_AXIS)),
            out_specs=P(),
            check_vma=False,
        )(poses, points, obs)

    return partials


def sharded_paired_terms(mesh: Mesh, damping: float = 1e-4):
    """Returns a `terms_fn` for ops/ba.optimize_hybrid_paired whose
    landmark set is sharded over the mesh.

    The distributed Schur-complement reduction of the BASELINE contract:
    each shard computes `ba.paired_terms` over its landmark slice (every
    landmark's full 3x3 Hll lives on exactly one shard, so the per-shard
    damped inverses are exact), the psum over S/rhs/cost assembles the
    replicated reduced camera system, and the landmark-aligned outputs
    (Hll_inv, Wa, Wb, bl) come back shard-sharded for the local
    back-substitution.
    """

    def terms(poses, points, obs: ba.PairedObs):
        def body(poses, points, obs):
            S, rhs, Hll_inv, Wa, Wb, bl, cost = ba.paired_terms(
                poses, points, obs, damping
            )
            return (
                jax.lax.psum(S, SHARD_AXIS),
                jax.lax.psum(rhs, SHARD_AXIS),
                Hll_inv, Wa, Wb, bl,
                jax.lax.psum(cost, SHARD_AXIS),
            )

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(SHARD_AXIS), P(SHARD_AXIS)),
            out_specs=(
                P(), P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                P(SHARD_AXIS), P(),
            ),
            check_vma=False,
        )(poses, points, obs)

    return terms


def sharded_pose_graph_normal_eqs(mesh: Mesh, poses, g: ba.PoseGraph):
    """Edge-sharded pose-graph normal equations: partial H/b psum'd."""

    def body(poses, g):
        H, b, cost = ba.pose_graph_normal_eqs(poses, g)
        return (
            jax.lax.psum(H, SHARD_AXIS),
            jax.lax.psum(b, SHARD_AXIS),
            jax.lax.psum(cost, SHARD_AXIS),
        )

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(SHARD_AXIS)),
        out_specs=P(),
        check_vma=False,
    )(poses, g)
