"""Randomized-fern keyframe encoding for global loop-closure retrieval.

XLA-friendly equivalent of the reference's fern keyframe database
(`Ferns::addFrame/findFrame`, expected `Core/src/Ferns.cpp` — SURVEY.md §3
"Global loop closure").  The reference encodes a downsampled frame with F
random binary tests (one pixel per fern, thresholds on r, g, b, d) and
retrieves candidate keyframes by code dissimilarity.

Differences:

- Encoding is one vectorized gather from the (argument) frame at F fern
  pixel positions + a threshold compare — no per-fern loop.
- The fern positions/thresholds are drawn once from a seeded PRNG and
  carried in a `FernCoder` pytree that is *passed as an argument*.
- Retrieval against the whole keyframe database is one (F,) vs (M, F)
  broadcast compare + mean — O(M F) elementwise work, no early-out
  heuristics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class FernCoder(NamedTuple):
    """Fern test parameters (fixed at init, shared by all frames)."""

    uv: jnp.ndarray  # i32[F, 2] — (v, u) pixel per fern in the coded frame
    thresh: jnp.ndarray  # f32[F, 4] — thresholds for (r, g, b, depth)


def make_coder(
    rng: jax.Array, height: int, width: int, num_ferns: int, depth_max: float = 5.0
) -> FernCoder:
    ku, kt = jax.random.split(rng)
    v = jax.random.randint(ku, (num_ferns, 1), 0, height)
    u = jax.random.randint(jax.random.fold_in(ku, 1), (num_ferns, 1), 0, width)
    rgb_t = jax.random.uniform(kt, (num_ferns, 3))
    d_t = jax.random.uniform(jax.random.fold_in(kt, 1), (num_ferns, 1)) * depth_max
    return FernCoder(
        uv=jnp.concatenate([v, u], axis=-1).astype(jnp.int32),
        thresh=jnp.concatenate([rgb_t, d_t], axis=-1).astype(jnp.float32),
    )


def encode(
    coder: FernCoder, color: jnp.ndarray, depth: jnp.ndarray
) -> jnp.ndarray:
    """Frame -> fern code u8[F] (4 bits: r, g, b, d threshold tests)."""
    rgb = color[coder.uv[:, 0], coder.uv[:, 1]]  # (F, 3)
    d = depth[coder.uv[:, 0], coder.uv[:, 1]]  # (F,)
    vals = jnp.concatenate([rgb, d[:, None]], axis=-1)  # (F, 4)
    bits = (vals > coder.thresh).astype(jnp.uint8)
    weights = jnp.asarray([1, 2, 4, 8], jnp.uint8)
    return jnp.sum(bits * weights[None, :], axis=-1).astype(jnp.uint8)


def dissimilarity(code: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Fraction of differing fern codes vs every DB row: (M,) in [0, 1]."""
    return jnp.mean((db != code[None, :]).astype(jnp.float32), axis=-1)


def find_best(
    code: jnp.ndarray,
    db: jnp.ndarray,  # u8[M, F]
    db_valid: jnp.ndarray,  # bool[M]
    exclude_after: jnp.ndarray,  # () i32 — ignore DB rows >= this index
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best loop-closure candidate: (index, dissimilarity).

    `exclude_after` masks out recent keyframes so a frame cannot "close a
    loop" against its immediate predecessors (the reference uses a time
    window for the same reason).
    """
    m = db.shape[0]
    diss = dissimilarity(code, db)
    idx = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    ok = db_valid & (idx < exclude_after)
    diss = jnp.where(ok, diss, jnp.inf)
    best = jnp.argmin(diss).astype(jnp.int32)
    return best, diss[best]
