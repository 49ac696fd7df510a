"""Pose-graph optimization and Schur-complement bundle adjustment.

Replaces the reference's map correction (embedded deformation graph with a
CPU Gauss-Newton solve — `Core/src/Deformation.cpp`, expected layout,
SURVEY.md §3 "Map correction") with the BASELINE-mandated design: a
keyframe pose graph and loop-closure BA solved as a Schur-complement
reduction that distributes over collectives.

Structure:

- Per-edge/per-observation Jacobians come from `jax.jacfwd` vmapped over
  the edge axis — exact, branch-free, and trivially sharded (the edge
  axis is the distribution axis: each shard computes partial JᵀJ / Jᵀr
  and a `psum` reduces them; see `parallel/collectives.py`).
- Normal equations are assembled with scatter-adds into a dense
  (6M, 6M) system (M = keyframes, small by construction) and solved
  replicated on every device — the "reduced camera system" of classic
  Schur BA.
- Landmarks are eliminated analytically: Hll is 3x3 block-diagonal, so
  the Schur complement S = Hpp - Hpl Hll^-1 Hlp costs one batched 3x3
  inverse + two batched matmuls, never a big sparse solve.

Conventions: pose i is T_wc[i] (camera->world); perturbation is
right-multiplied, T <- T @ exp(xi).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.geometry.se3 import (
    orthonormalize,
    se3_exp,
    se3_inverse,
    se3_log,
)

_PREC = jax.lax.Precision.HIGHEST
_mm = lambda a, b: jnp.matmul(a, b, precision=_PREC)  # noqa: E731


class PoseGraph(NamedTuple):
    """Fixed-capacity relative-pose constraint set."""

    i: jnp.ndarray  # i32[E] — source keyframe index
    j: jnp.ndarray  # i32[E] — target keyframe index
    T_ij: jnp.ndarray  # f32[E,4,4] — measured T_i^-1 T_j (odometry / loop ICP)
    weight: jnp.ndarray  # f32[E]
    valid: jnp.ndarray  # bool[E]


def empty_graph(capacity: int) -> PoseGraph:
    return PoseGraph(
        i=jnp.zeros((capacity,), jnp.int32),
        j=jnp.zeros((capacity,), jnp.int32),
        T_ij=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (capacity, 4, 4)),
        weight=jnp.zeros((capacity,), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


def add_edge(g: PoseGraph, n_edges, i, j, T_ij, weight=1.0) -> tuple[PoseGraph, jnp.ndarray]:
    """Append an edge at slot `n_edges` (dropped if at capacity)."""
    cap = g.i.shape[0]
    slot = jnp.where(n_edges < cap, n_edges, cap)
    g = PoseGraph(
        i=g.i.at[slot].set(jnp.int32(i), mode="drop"),
        j=g.j.at[slot].set(jnp.int32(j), mode="drop"),
        T_ij=g.T_ij.at[slot].set(T_ij, mode="drop"),
        weight=g.weight.at[slot].set(weight, mode="drop"),
        valid=g.valid.at[slot].set(True, mode="drop"),
    )
    return g, jnp.minimum(n_edges + 1, cap)


def _edge_residual(xi_i, xi_j, T_i, T_j, T_meas):
    """r = log(T_meas^-1 (T_i e^xi_i)^-1 (T_j e^xi_j)) — (6,)."""
    Ti = _mm(T_i, se3_exp(xi_i))
    Tj = _mm(T_j, se3_exp(xi_j))
    return se3_log(_mm(se3_inverse(T_meas), _mm(se3_inverse(Ti), Tj)))


def pose_graph_residuals(poses: jnp.ndarray, g: PoseGraph) -> jnp.ndarray:
    zero = jnp.zeros((6,), poses.dtype)
    f = lambda i, j, Tm: _edge_residual(zero, zero, poses[i], poses[j], Tm)
    return jax.vmap(f)(g.i, g.j, g.T_ij)  # (E, 6)


def pose_graph_normal_eqs(
    poses: jnp.ndarray, g: PoseGraph
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assemble H (6M,6M), b (6M,), and the weighted residual norm.

    Pure function of (poses, edges): this is the shard-local partial when
    the edge set is sharded — partial H/b simply `psum` (the distributed
    reduction of SURVEY §3.2).
    """
    m = poses.shape[0]
    zero = jnp.zeros((6,), poses.dtype)

    def one(i, j, Tm, w, ok):
        r = _edge_residual(zero, zero, poses[i], poses[j], Tm)
        Ji = jax.jacfwd(_edge_residual, argnums=0)(zero, zero, poses[i], poses[j], Tm)
        Jj = jax.jacfwd(_edge_residual, argnums=1)(zero, zero, poses[i], poses[j], Tm)
        w = jnp.where(ok, w, 0.0)
        return r * w, Ji * w, Jj * w

    r, Ji, Jj = jax.vmap(one)(g.i, g.j, g.T_ij, g.weight, g.valid)  # (E,6),(E,6,6)x2

    H = jnp.zeros((m, m, 6, 6), poses.dtype)
    b = jnp.zeros((m, 6), poses.dtype)
    JiTJi = jnp.einsum("eab,eac->ebc", Ji, Ji, precision=_PREC)
    JjTJj = jnp.einsum("eab,eac->ebc", Jj, Jj, precision=_PREC)
    JiTJj = jnp.einsum("eab,eac->ebc", Ji, Jj, precision=_PREC)
    H = H.at[g.i, g.i].add(JiTJi)
    H = H.at[g.j, g.j].add(JjTJj)
    H = H.at[g.i, g.j].add(JiTJj)
    H = H.at[g.j, g.i].add(jnp.swapaxes(JiTJj, -1, -2))
    b = b.at[g.i].add(-jnp.einsum("eab,ea->eb", Ji, r, precision=_PREC))
    b = b.at[g.j].add(-jnp.einsum("eab,ea->eb", Jj, r, precision=_PREC))
    H = H.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m)
    cost = jnp.sum(r * r)
    return H, b.reshape(-1), cost


def solve_and_update(
    poses: jnp.ndarray,
    H: jnp.ndarray,
    b: jnp.ndarray,
    damping: float = 1e-6,
    anchor: int = 0,
) -> jnp.ndarray:
    """One damped GN step with the anchor pose gauge-fixed."""
    m = poses.shape[0]
    # Gauge fix: a huge prior on the anchor's 6 dofs instead of removing
    # rows (keeps shapes static).
    idx = jax.lax.broadcasted_iota(jnp.int32, (6 * m, 1), 0)[:, 0]
    anchor_mask = (idx >= 6 * anchor) & (idx < 6 * (anchor + 1))
    diag = damping * jnp.maximum(jnp.diagonal(H), 1.0) + jnp.where(anchor_mask, 1e12, 0.0)
    xi = jnp.linalg.solve(H + jnp.diag(diag), b)
    xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros_like(xi))
    return orthonormalize(_mm(poses, se3_exp(xi.reshape(m, 6))))


def optimize_pose_graph(
    poses: jnp.ndarray,
    g: PoseGraph,
    iters: int = 8,
    damping: float = 1e-6,
    anchor: int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton over the pose graph; returns (poses, final cost)."""

    def body(_, carry):
        poses, _ = carry
        H, b, cost = pose_graph_normal_eqs(poses, g)
        return solve_and_update(poses, H, b, damping, anchor), cost

    poses, cost = jax.lax.fori_loop(0, iters, body, (poses, jnp.inf))
    return poses, cost


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment (poses + landmarks)
# ---------------------------------------------------------------------------


class BAObservations(NamedTuple):
    """Landmark observations: camera-frame point measurements.

    Landmark l observed from keyframe k at camera-frame position z —
    the depth-sensor analog of reprojection BA (3D point-to-point), which
    is what a dense RGB-D rig actually measures.
    """

    k: jnp.ndarray  # i32[O] — keyframe index
    l: jnp.ndarray  # i32[O] — landmark index
    z: jnp.ndarray  # f32[O,3] — measured camera-frame position
    weight: jnp.ndarray  # f32[O]
    valid: jnp.ndarray  # bool[O]


def _obs_residual(xi, p_l, T_k, z):
    """r = (T_k e^xi)^-1 p_l - z — camera-frame point residual (3,)."""
    T = _mm(T_k, se3_exp(xi))
    Ti = se3_inverse(T)
    return _mm(Ti[:3, :3], p_l[:, None])[:, 0] + Ti[:3, 3] - z


def ba_partials(
    poses: jnp.ndarray,  # (M,4,4)
    points: jnp.ndarray,  # (L,3)
    obs: BAObservations,
):
    """Shard-local BA blocks: (Hpp, bp, Hll, bl, Hpl, cost).

    Hpp: (M,6,6) pose-diagonal blocks;  Hll: (L,3,3);  Hpl: (M,L,6,3).
    Every output is a plain sum over observations -> `psum`-reducible.
    """
    m, L = poses.shape[0], points.shape[0]
    zero = jnp.zeros((6,), poses.dtype)

    def one(k, l, z, w, ok):
        r = _obs_residual(zero, points[l], poses[k], z)
        Jp = jax.jacfwd(_obs_residual, argnums=0)(zero, points[l], poses[k], z)  # (3,6)
        Jl = jax.jacfwd(_obs_residual, argnums=1)(zero, points[l], poses[k], z)  # (3,3)
        w = jnp.where(ok, w, 0.0)
        return r * w, Jp * w, Jl * w

    r, Jp, Jl = jax.vmap(one)(obs.k, obs.l, obs.z, obs.weight, obs.valid)

    ein = functools.partial(jnp.einsum, precision=_PREC)
    Hpp = jnp.zeros((m, 6, 6)).at[obs.k].add(ein("oab,oac->obc", Jp, Jp))
    Hll = jnp.zeros((L, 3, 3)).at[obs.l].add(ein("oab,oac->obc", Jl, Jl))
    Hpl = jnp.zeros((m, L, 6, 3)).at[obs.k, obs.l].add(
        ein("oab,oac->obc", Jp, Jl)
    )
    bp = jnp.zeros((m, 6)).at[obs.k].add(-ein("oab,oa->ob", Jp, r))
    bl = jnp.zeros((L, 3)).at[obs.l].add(-ein("oab,oa->ob", Jl, r))
    cost = jnp.sum(r * r)
    return Hpp, bp, Hll, bl, Hpl, cost


def schur_reduce(Hpp, bp, Hll, bl, Hpl, damping: float = 1e-4):
    """Eliminate the landmark block: the reduced camera system.

    Returns (S (6M,6M), rhs (6M,), Hll_inv (L,3,3)); the classic
    S = Hpp - Hpl Hll^-1 Hlp with the Hll inverse a batched 3x3 (never
    a big sparse solve).
    """
    m = Hpp.shape[0]
    eye3 = jnp.eye(3)
    Hll_d = Hll + damping * jnp.maximum(
        jnp.diagonal(Hll, axis1=-2, axis2=-1), 1.0
    )[..., None] * eye3
    Hll_inv = jnp.linalg.inv(Hll_d)  # (L,3,3) batched

    # S = Hpp - Hpl Hll^-1 Hlp  (assembled dense over the small pose block)
    HplW = jnp.einsum("mlab,lbc->mlac", Hpl, Hll_inv, precision=_PREC)  # (M,L,6,3)
    S_off = jnp.einsum("mlac,nlbc->mnab", HplW, Hpl, precision=_PREC)  # (M,M,6,6)
    S = -S_off
    S = S.at[jnp.arange(m), jnp.arange(m)].add(Hpp)
    rhs = bp - jnp.einsum("mlac,lc->ma", HplW, bl, precision=_PREC)
    S = S.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m)
    return S, rhs.reshape(-1), Hll_inv


def _solve_reduced(S, rhs, m, damping, anchor):
    idx = jax.lax.broadcasted_iota(jnp.int32, (6 * m, 1), 0)[:, 0]
    anchor_mask = (idx >= 6 * anchor) & (idx < 6 * (anchor + 1))
    diag = damping * jnp.maximum(jnp.diagonal(S), 1.0) + jnp.where(
        anchor_mask, 1e12, 0.0
    )
    xi = jnp.linalg.solve(S + jnp.diag(diag), rhs).reshape(m, 6)
    return jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros_like(xi))


def _backsub_landmarks(Hll_inv, bl, Hpl, xi):
    """dl = Hll^-1 (bl - Hlp xi)."""
    Hlp_xi = jnp.einsum("mlab,ma->lb", Hpl, xi, precision=_PREC)
    dl = jnp.einsum("lab,lb->la", Hll_inv, bl - Hlp_xi, precision=_PREC)
    return jnp.where(jnp.all(jnp.isfinite(dl)), dl, jnp.zeros_like(dl))


def schur_solve(
    Hpp, bp, Hll, bl, Hpl, damping: float = 1e-4, anchor: int = 0
):
    """Eliminate landmarks, solve the reduced pose system, back-substitute.

    Returns (xi_poses (M,6), delta_points (L,3)).
    """
    m = Hpp.shape[0]
    S, rhs, Hll_inv = schur_reduce(Hpp, bp, Hll, bl, Hpl, damping)
    xi = _solve_reduced(S, rhs, m, damping, anchor)
    dl = _backsub_landmarks(Hll_inv, bl, Hpl, xi)
    return xi, dl


def optimize_ba(
    poses: jnp.ndarray,
    points: jnp.ndarray,
    obs: BAObservations,
    iters: int = 5,
    damping: float = 1e-4,
    anchor: int = 0,
    partials_fn=ba_partials,
):
    """Full Schur BA loop.  `partials_fn` is injectable so the distributed
    version can pass a shard_map-wrapped reducer (partials + psum) without
    duplicating the solver."""

    def body(_, carry):
        poses, points, _ = carry
        Hpp, bp, Hll, bl, Hpl, cost = partials_fn(poses, points, obs)
        xi, dl = schur_solve(Hpp, bp, Hll, bl, Hpl, damping, anchor)
        return orthonormalize(_mm(poses, se3_exp(xi))), points + dl, cost

    poses, points, cost = jax.lax.fori_loop(0, iters, body, (poses, points, jnp.inf))
    return poses, points, cost


def optimize_hybrid(
    poses: jnp.ndarray,  # (M,4,4)
    g: PoseGraph,
    points: jnp.ndarray,  # (L,3)
    obs: BAObservations,
    iters: int = 5,
    damping: float = 1e-4,
    anchor: int = 0,
    partials_fn=ba_partials,
    pg_weight: float = 1.0,
):
    """Joint pose-graph + landmark Schur BA (the live loop-closure solver).

    The full loop-closure correction mandated by BASELINE ("keyframe
    pose-graph optimization and loop-closure bundle adjustment as a
    distributed Schur-complement reduction", SURVEY.md §0.1/§4.6): one
    Gauss-Newton system per iteration combining

    - the pose-graph normal equations (odometry chain + verified loop
      edges, `pose_graph_normal_eqs`) — these anchor the whole trajectory;
    - the landmark observations' Schur complement (`schur_reduce` over
      `partials_fn`, psum-sharded when `partials_fn` comes from
      `parallel.shard.sharded_ba_partials`) — these re-estimate the
      loop-pair geometry from raw point correspondences, adding constraint
      directions a single rigid edge cannot carry.

    With zero valid observations the landmark terms vanish and this
    degrades exactly to `optimize_pose_graph`.  Returns
    (poses, points, cost = pg_cost + ba_cost).
    """
    m = poses.shape[0]

    def body(_, carry):
        poses, points, _ = carry
        Hpp, bp, Hll, bl, Hpl, ba_cost = partials_fn(poses, points, obs)
        S, rhs, Hll_inv = schur_reduce(Hpp, bp, Hll, bl, Hpl, damping)
        H_pg, b_pg, pg_cost = pose_graph_normal_eqs(poses, g)
        xi = _solve_reduced(
            S + pg_weight * H_pg, rhs + pg_weight * b_pg, m, damping, anchor
        )
        dl = _backsub_landmarks(Hll_inv, bl, Hpl, xi)
        return (
            orthonormalize(_mm(poses, se3_exp(xi))),
            points + dl,
            pg_weight * pg_cost + ba_cost,
        )

    poses, points, cost = jax.lax.fori_loop(
        0, iters, body, (poses, points, jnp.inf)
    )
    return poses, points, cost


# ---------------------------------------------------------------------------
# Paired-landmark layout: the production loop-closure path
# ---------------------------------------------------------------------------


class PairedObs(NamedTuple):
    """Landmark observations in PAIRED layout.

    Landmark l is observed by exactly two keyframes — its loop pair —
    with both rows aligned on the landmark axis.  This is what the live
    pipeline produces (each verified loop contributes L landmarks seen
    from both loop keyframes); exploiting the 2-observation structure
    keeps the Schur product O(L) scatter-adds instead of the dense
    (M, L, 6, 3) Hpl of `ba_partials` (kept as the golden/general path).
    """

    ka: jnp.ndarray  # i32[L] — first observing keyframe
    kb: jnp.ndarray  # i32[L] — second observing keyframe
    za: jnp.ndarray  # f32[L,3] — measured camera-frame position in ka
    zb: jnp.ndarray  # f32[L,3] — measured camera-frame position in kb
    weight: jnp.ndarray  # f32[L]
    valid: jnp.ndarray  # bool[L]


def empty_paired_obs(capacity: int) -> PairedObs:
    return PairedObs(
        ka=jnp.zeros((capacity,), jnp.int32),
        kb=jnp.zeros((capacity,), jnp.int32),
        za=jnp.zeros((capacity, 3), jnp.float32),
        zb=jnp.zeros((capacity, 3), jnp.float32),
        weight=jnp.zeros((capacity,), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


def paired_to_generic(obs: PairedObs) -> BAObservations:
    """Flatten a paired set to the generic layout (for goldens/tests)."""
    L = obs.ka.shape[0]
    lidx = jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0)[:, 0]
    return BAObservations(
        k=jnp.concatenate([obs.ka, obs.kb]),
        l=jnp.concatenate([lidx, lidx]),
        z=jnp.concatenate([obs.za, obs.zb]),
        weight=jnp.concatenate([obs.weight, obs.weight]),
        valid=jnp.concatenate([obs.valid, obs.valid]),
    )


def paired_terms(
    poses: jnp.ndarray,  # (M,4,4)
    points: jnp.ndarray,  # (L,3)
    obs: PairedObs,
    damping: float = 1e-4,
):
    """Schur-reduced camera terms from paired landmark observations.

    Returns (S (M,M,6,6), rhs (M,6), Hll_inv (L,3,3), Wa, Wb (L,6,3),
    bl (L,3), cost).  S, rhs, and cost are plain sums over landmarks —
    the psum-reducible partials of the distributed Schur reduction
    (`parallel.shard.sharded_paired_terms`); Hll_inv/Wa/Wb/bl stay
    landmark-aligned for the back-substitution.
    """
    m = poses.shape[0]
    zero = jnp.zeros((6,), poses.dtype)

    def one(ka, kb, za, zb, p, w, ok):
        w = jnp.where(ok, w, 0.0)
        ra = _obs_residual(zero, p, poses[ka], za)
        Jpa = jax.jacfwd(_obs_residual, argnums=0)(zero, p, poses[ka], za)
        Jla = jax.jacfwd(_obs_residual, argnums=1)(zero, p, poses[ka], za)
        rb = _obs_residual(zero, p, poses[kb], zb)
        Jpb = jax.jacfwd(_obs_residual, argnums=0)(zero, p, poses[kb], zb)
        Jlb = jax.jacfwd(_obs_residual, argnums=1)(zero, p, poses[kb], zb)
        return ra * w, Jpa * w, Jla * w, rb * w, Jpb * w, Jlb * w

    ra, Jpa, Jla, rb, Jpb, Jlb = jax.vmap(one)(
        obs.ka, obs.kb, obs.za, obs.zb, points, obs.weight, obs.valid
    )

    ein = functools.partial(jnp.einsum, precision=_PREC)
    Hll = ein("lab,lac->lbc", Jla, Jla) + ein("lab,lac->lbc", Jlb, Jlb)
    Hll_d = Hll + damping * jnp.maximum(
        jnp.diagonal(Hll, axis1=-2, axis2=-1), 1.0
    )[..., None] * jnp.eye(3, dtype=poses.dtype)
    Hll_inv = jnp.linalg.inv(Hll_d)
    Wa = ein("lab,lac->lbc", Jpa, Jla)  # (L,6,3) = Jpaᵀ Jla
    Wb = ein("lab,lac->lbc", Jpb, Jlb)
    bl = -(ein("lab,la->lb", Jla, ra) + ein("lab,la->lb", Jlb, rb))

    WaH = ein("lab,lbc->lac", Wa, Hll_inv)  # (L,6,3)
    WbH = ein("lab,lbc->lac", Wb, Hll_inv)

    S = jnp.zeros((m, m, 6, 6), poses.dtype)
    S = S.at[obs.ka, obs.ka].add(
        ein("lab,lac->lbc", Jpa, Jpa) - ein("lac,lbc->lab", WaH, Wa)
    )
    S = S.at[obs.kb, obs.kb].add(
        ein("lab,lac->lbc", Jpb, Jpb) - ein("lac,lbc->lab", WbH, Wb)
    )
    off = ein("lac,lbc->lab", WaH, Wb)  # (L,6,6): Wa Hll_inv Wbᵀ
    S = S.at[obs.ka, obs.kb].add(-off)
    S = S.at[obs.kb, obs.ka].add(-jnp.swapaxes(off, -1, -2))

    rhs = jnp.zeros((m, 6), poses.dtype)
    rhs = rhs.at[obs.ka].add(-ein("lab,la->lb", Jpa, ra))
    rhs = rhs.at[obs.kb].add(-ein("lab,la->lb", Jpb, rb))
    rhs = rhs.at[obs.ka].add(-ein("lac,lc->la", WaH, bl))
    rhs = rhs.at[obs.kb].add(-ein("lac,lc->la", WbH, bl))

    cost = jnp.sum(ra * ra) + jnp.sum(rb * rb)
    return S, rhs, Hll_inv, Wa, Wb, bl, cost


def optimize_hybrid_paired(
    poses: jnp.ndarray,
    g: PoseGraph,
    points: jnp.ndarray,
    obs: PairedObs,
    iters: int = 5,
    damping: float = 1e-4,
    anchor: int = 0,
    terms_fn=None,
    pg_weight: float = 1.0,
):
    """Joint pose-graph + paired-landmark Schur BA — the live solver.

    Same semantics as `optimize_hybrid` restricted to the paired layout,
    at O(L) Schur cost.  `terms_fn` is injectable so the distributed
    version passes a shard_map-wrapped reducer (paired_terms + psum on
    S/rhs/cost) without duplicating the solver.  With zero valid
    observations this degrades exactly to `optimize_pose_graph`.
    """
    if terms_fn is None:
        terms_fn = functools.partial(paired_terms, damping=damping)
    m = poses.shape[0]
    ein = functools.partial(jnp.einsum, precision=_PREC)

    def body(_, carry):
        poses, points, _ = carry
        S, rhs, Hll_inv, Wa, Wb, bl, ba_cost = terms_fn(poses, points, obs)
        H_pg, b_pg, pg_cost = pose_graph_normal_eqs(poses, g)
        Sm = S.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m) + pg_weight * H_pg
        xi = _solve_reduced(
            Sm, rhs.reshape(-1) + pg_weight * b_pg, m, damping, anchor
        )
        # Back-substitute: dl = Hll^-1 (bl - Waᵀ xi_ka - Wbᵀ xi_kb).
        resid = (
            bl
            - ein("lab,la->lb", Wa, xi[obs.ka])
            - ein("lab,la->lb", Wb, xi[obs.kb])
        )
        dl = ein("lab,lb->la", Hll_inv, resid)
        dl = jnp.where(jnp.all(jnp.isfinite(dl)), dl, jnp.zeros_like(dl))
        return (
            orthonormalize(_mm(poses, se3_exp(xi))),
            points + dl,
            pg_weight * pg_cost + ba_cost,
        )

    poses, points, cost = jax.lax.fori_loop(
        0, iters, body, (poses, points, jnp.inf)
    )
    return poses, points, cost
