"""Instance table and 2D-3D data association.

XLA-friendly equivalent of the reference's instance-table management and
mask-to-model matching (SURVEY.md §4.5): the reference projects the
instance-labeled surfel model into the camera, matches each new network
mask to a predicted instance region by overlap, then votes labels onto
surfels.  Here:

- The table is a fixed-capacity struct-of-arrays (static shapes, shards
  replicated): active/class/score/age per global instance id.
- The overlap matrix between the frame's K network masks and the N table
  instances visible in the predicted-label image is ONE one-hot matmul
  (HW x K)ᵀ(HW x N) — no per-mask loops.
- Matching is greedy-by-IoU with a class-consistency gate; unmatched
  masks allocate new table rows by prefix sum (same deterministic
  allocation pattern as the block table).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import InstanceConfig
from instancefusion_tpu.models.segmentation import Segmentation


class InstanceTable(NamedTuple):
    active: jnp.ndarray  # bool[N]
    cls: jnp.ndarray  # i32[N] semantic class (0 = unset)
    score: jnp.ndarray  # f32[N] accumulated confidence
    age: jnp.ndarray  # i32[N] frames since creation
    matches: jnp.ndarray  # i32[N] times re-observed
    overflow: jnp.ndarray  # () i32 — masks dropped for lack of free rows


def allocate(cfg: InstanceConfig) -> InstanceTable:
    n = cfg.max_instances
    return InstanceTable(
        active=jnp.zeros((n,), bool),
        cls=jnp.zeros((n,), jnp.int32),
        score=jnp.zeros((n,), jnp.float32),
        age=jnp.zeros((n,), jnp.int32),
        matches=jnp.zeros((n,), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
    )


def instance_color(gid: jnp.ndarray) -> jnp.ndarray:
    """Deterministic pseudo-random color per global id (..., ) -> (..., 3).

    Arithmetic hash (golden-ratio scramble) rather than a palette table —
    constant-table gathers poison this runtime (see ops/blocks.py).
    """
    g = gid.astype(jnp.uint32)
    r = (g * jnp.uint32(2654435761)) & jnp.uint32(0xFF)
    gg = (g * jnp.uint32(2246822519)) & jnp.uint32(0xFF)
    b = (g * jnp.uint32(3266489917)) & jnp.uint32(0xFF)
    col = jnp.stack([r, gg, b], axis=-1).astype(jnp.float32) / 255.0
    return jnp.where(gid[..., None] >= 0, 0.25 + 0.75 * col, 0.0)


def associate(
    table: InstanceTable,
    seg: Segmentation,
    pred_gid: jnp.ndarray,  # i32[H,W] predicted (model) global ids, -1 = none
    cfg: InstanceConfig,
) -> tuple[jnp.ndarray, InstanceTable]:
    """Match frame masks to table instances; returns (gid_image, table').

    gid_image assigns every segmented pixel its *global* instance id
    (matched existing id, or a freshly allocated one), ready for voxel
    label voting.
    """
    n = cfg.max_instances
    k = int(seg.classes.shape[0])
    hw = seg.mask_id.size

    mask_flat = seg.mask_id.reshape(-1)
    pred_flat = pred_gid.reshape(-1)

    # One-hot overlap histogram (integer counts: exact at any precision).
    oh_mask = jax.nn.one_hot(jnp.where(mask_flat >= 0, mask_flat, k), k + 1)
    oh_pred = jax.nn.one_hot(jnp.where(pred_flat >= 0, pred_flat, n), n + 1)
    overlap = jnp.einsum("pk,pn->kn", oh_mask[:, :k], oh_pred[:, :n])  # (K,N)
    mask_px = jnp.sum(oh_mask[:, :k], axis=0)  # (K,)
    pred_px = jnp.sum(oh_pred[:, :n], axis=0)  # (N,)
    union = mask_px[:, None] + pred_px[None, :] - overlap
    iou = overlap / jnp.maximum(union, 1.0)

    # Gate: table row active, class agreement (or class unset).
    cls_ok = (table.cls[None, :] == seg.classes[:, None]) | (table.cls[None, :] == 0)
    gate = table.active[None, :] & cls_ok & (iou >= cfg.iou_match_thresh)
    iou_g = jnp.where(gate, iou, -1.0)

    # Greedy one-to-one matching, K rounds (K is small and static).
    matched_gid = jnp.full((k,), -1, jnp.int32)
    taken = jnp.zeros((n,), bool)

    def round_fn(_, carry):
        matched, taken, iou_cur = carry
        flat = jnp.argmax(iou_cur)
        ki, ni = flat // n, flat % n
        best = iou_cur[ki, ni]
        ok = best > 0.0
        matched = jnp.where(
            ok, matched.at[ki].set(ni.astype(jnp.int32)), matched
        )
        taken = jnp.where(ok, taken.at[ni].set(True), taken)
        iou_cur = jnp.where(ok, iou_cur.at[ki, :].set(-1.0), iou_cur)
        iou_cur = jnp.where(ok, iou_cur.at[:, ni].set(-1.0), iou_cur)
        return matched, taken, iou_cur

    matched_gid, taken, _ = jax.lax.fori_loop(
        0, k, round_fn, (matched_gid, taken, iou_g)
    )

    # Allocate table rows for unmatched real masks (big enough, valid).
    is_new = (
        seg.valid
        & (matched_gid < 0)
        & (mask_px >= float(cfg.min_mask_pixels))
    )
    free = ~table.active & ~taken
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # rank of each free row
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # rank of each new mask
    n_free = jnp.sum(free.astype(jnp.int32))
    fits = is_new & (new_rank < n_free)
    # row index whose free_rank == new_rank: one-hot matmul over ranks.
    rank_oh = (
        (free_rank[None, :] == new_rank[:, None]) & free[None, :] & fits[:, None]
    )
    row_ids = jnp.argmax(rank_oh, axis=1).astype(jnp.int32)
    new_gid = jnp.where(fits, row_ids, -1)
    gid_of_mask = jnp.where(matched_gid >= 0, matched_gid, new_gid)  # (K,)

    # Table update.
    upd_rows = jnp.where(gid_of_mask >= 0, gid_of_mask, n)  # OOB -> dropped
    active = table.active.at[upd_rows].set(True, mode="drop")
    cls = table.cls.at[upd_rows].set(
        jnp.where(table.cls[jnp.clip(upd_rows, 0, n - 1)] == 0,
                  seg.classes, table.cls[jnp.clip(upd_rows, 0, n - 1)]),
        mode="drop",
    )
    score = table.score.at[upd_rows].add(seg.scores, mode="drop")
    matches = table.matches.at[upd_rows].add(
        (matched_gid >= 0).astype(jnp.int32), mode="drop"
    )
    overflow = table.overflow + jnp.sum((is_new & ~fits).astype(jnp.int32))
    table = InstanceTable(
        active=active,
        cls=cls,
        score=score,
        age=jnp.where(table.active, table.age + 1, table.age),
        matches=matches,
        overflow=overflow,
    )

    # Per-pixel global-id image via one-hot matmul (no constant gather).
    gid_image = jnp.einsum(
        "pk,k->p", oh_mask[:, :k], gid_of_mask.astype(jnp.float32)
    )
    none = mask_flat < 0
    gid_image = jnp.where(none, -1, jnp.round(gid_image).astype(jnp.int32))
    # Masks that got no gid (-1 per-mask) must not leak id -1 ambiguity:
    # einsum already yields -1 for them, matching "none".
    return gid_image.reshape(seg.mask_id.shape), table


def find_merges(
    table: InstanceTable,
    seg: Segmentation,
    pred_gid: jnp.ndarray,  # i32[H,W]
    cfg: InstanceConfig,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect table rows that are one object: (src i32[K], dst i32[K], ok).

    The classic duplicate-instance failure: an object first observed from
    two disjoint viewpoints gets two table rows, and their voxel votes
    fight forever (SURVEY.md §4.5 "create / MERGE / confirm").  The
    evidence that finally exposes it is a single network mask overlapping
    BOTH predicted regions: for each mask, if the best AND second-best
    IoU against active class-compatible rows both clear
    `merge_iou_thresh`, the runner-up (src) is the same object as the
    winner (dst).  Apply with `apply_merges` + `labels.relabel_votes`.
    """
    n = cfg.max_instances
    k = int(seg.classes.shape[0])
    mask_flat = seg.mask_id.reshape(-1)
    pred_flat = pred_gid.reshape(-1)
    oh_mask = jax.nn.one_hot(jnp.where(mask_flat >= 0, mask_flat, k), k + 1)
    oh_pred = jax.nn.one_hot(jnp.where(pred_flat >= 0, pred_flat, n), n + 1)
    overlap = jnp.einsum("pk,pn->kn", oh_mask[:, :k], oh_pred[:, :n])
    mask_px = jnp.sum(oh_mask[:, :k], axis=0)
    pred_px = jnp.sum(oh_pred[:, :n], axis=0)
    union = mask_px[:, None] + pred_px[None, :] - overlap
    iou = overlap / jnp.maximum(union, 1.0)
    cls_ok = (table.cls[None, :] == seg.classes[:, None]) | (
        table.cls[None, :] == 0
    )
    gate = table.active[None, :] & cls_ok
    iou_g = jnp.where(gate, iou, -1.0)

    dst = jnp.argmax(iou_g, axis=1).astype(jnp.int32)
    best = jnp.max(iou_g, axis=1)
    iou_2 = iou_g.at[jnp.arange(k), dst].set(-1.0)
    src = jnp.argmax(iou_2, axis=1).astype(jnp.int32)
    second = jnp.max(iou_2, axis=1)
    ok = (
        seg.valid
        & (mask_px >= float(cfg.min_mask_pixels))
        & (best >= cfg.iou_match_thresh)
        & (second >= cfg.merge_iou_thresh)
    )
    return src, dst, ok


def apply_merges(
    table: InstanceTable,
    src: jnp.ndarray,  # i32[K]
    dst: jnp.ndarray,  # i32[K]
    ok: jnp.ndarray,  # bool[K]
) -> InstanceTable:
    """Fold each src row into its dst row and free the src slot."""
    n = table.active.shape[0]
    srows = jnp.where(ok, src, n)  # OOB -> dropped
    drows = jnp.where(ok, dst, n)
    src_c = jnp.clip(src, 0, n - 1)
    score = table.score.at[drows].add(
        jnp.where(ok, table.score[src_c], 0.0), mode="drop"
    )
    matches = table.matches.at[drows].add(
        jnp.where(ok, table.matches[src_c], 0), mode="drop"
    )
    # Free the src slots entirely (score/matches zeroed AFTER folding).
    active = table.active.at[srows].set(False, mode="drop")
    cls = table.cls.at[srows].set(0, mode="drop")
    score = score.at[srows].set(0.0, mode="drop")
    matches = matches.at[srows].set(0, mode="drop")
    return table._replace(
        active=active, cls=cls, score=score, matches=matches,
        age=table.age.at[srows].set(0, mode="drop"),
    )


def retire_stale(
    table: InstanceTable, cfg: InstanceConfig, min_matches: int = 2,
    probation_age: int = 30,
) -> InstanceTable:
    """Retire instances that never got re-observed (spurious masks).

    The reference's instance table drops instances whose masks stop
    matching (SURVEY.md §4.5 "instance table update: create / merge /
    confirm"); here a row older than `probation_age` frames with fewer
    than `min_matches` re-observations is freed.  Freed rows become
    allocatable again (associate() scans ~active).
    """
    stale = table.active & (table.age > probation_age) & (
        table.matches < min_matches
    )
    keep = table.active & ~stale
    return table._replace(
        active=keep,
        cls=jnp.where(keep, table.cls, 0),
        score=jnp.where(keep, table.score, 0.0),
        age=jnp.where(keep, table.age, 0),
        matches=jnp.where(keep, table.matches, 0),
    )
