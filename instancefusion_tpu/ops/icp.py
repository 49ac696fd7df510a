"""Frame-to-model tracking: projective point-to-plane ICP (+ photometric).

jnp reference implementation of the reference's hottest path —
`RGBDOdometry::getIncrementalTransformation` with the CUDA `icpStep` /
`rgbStep` kernels (expected `Core/src/RGBDOdometry.cpp`,
`Core/src/Cuda/icp.cu` — SURVEY.md §4.3).  Key differences:

- The per-pixel 27-term reduction (upper-tri 6x6 JᵀJ + Jᵀr + stats) is one
  (6, HW) x (HW, 6) matmul at HIGHEST precision, not a hand-rolled tree
  reduction.
- The reference round-trips the reduced system to the CPU every iteration
  to solve 6x6; here the entire level/iteration loop, including the solve
  and the `exp(xi)` update, stays on-device inside one `jit`
  (`lax.fori_loop` over iterations, Python-unrolled over pyramid levels).

Association: new-frame pixels are transformed by the current pose estimate
and projected into the *predicted* maps (raycast of the model at the
previous pose), point-to-plane residual against the predicted vertex +
normal, gated by distance and normal agreement.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import IcpConfig
from instancefusion_tpu.ops.common import decimate
from instancefusion_tpu.geometry.camera import Intrinsics, project
from instancefusion_tpu.geometry.se3 import (
    se3_exp,
    se3_inverse,
    transform_points,
    rotate_vectors,
)

_PREC = jax.lax.Precision.HIGHEST


class TrackResult(NamedTuple):
    T_wc: jnp.ndarray  # (4,4) tracked pose
    inliers: jnp.ndarray  # () f32 — associated pixel count at finest level
    residual: jnp.ndarray  # () f32 — mean |point-to-plane residual| (m)
    valid: jnp.ndarray  # () bool — tracking-health gate passed


def associate(
    vmap_src_c: jnp.ndarray,  # (H,W,3) new-frame vertices, camera frame
    valid_src: jnp.ndarray,  # (H,W)
    tgt_vertex_w: jnp.ndarray,  # (Ht,Wt,3) predicted vertices, world frame
    tgt_normal_w: jnp.ndarray,  # (Ht,Wt,3) predicted normals, world frame
    tgt_valid: jnp.ndarray,  # (Ht,Wt)
    T_est_wc: jnp.ndarray,  # (4,4) current estimate for the new frame
    T_tgt_cw: jnp.ndarray,  # (4,4) world->camera of the prediction view
    intr: Intrinsics,
    cfg: IcpConfig,
    tgt_rgb=None,  # optional (intensity, gx, gy) target planes (Ht,Wt)
):
    """Projective data association: per source pixel, the target vertex /
    normal it corresponds to under the current pose estimate.

    Returns (q_w (HW,3), n_t (HW,3), assoc_valid (HW,) bool).  `track`
    re-associates every `cfg.assoc_every` Gauss-Newton steps and reuses
    the pairs in between (the reference re-associates every iteration).

    With `tgt_rgb` the photometric targets are gathered at the same
    pixels and the return gains (i_t, gx_t, gy_t, rgb_ok), each (HW,).
    """
    p_w = transform_points(T_est_wc, vmap_src_c.reshape(-1, 3))
    p_tc = transform_points(T_tgt_cw, p_w)
    u, v, z = project(intr, p_tc)
    # ceil(x - 0.5): a projection exactly halfway between two pixel
    # centers picks the lower index (du in (-0.5, 0.5] from the center).
    ui = jnp.ceil(u - 0.5).astype(jnp.int32)
    vi = jnp.ceil(v - 0.5).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    sel_flat = valid_src.reshape(-1) & in_img & (z > 0.0)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)
    flat = vic * intr.width + uic
    q_w = tgt_vertex_w.reshape(-1, 3)[flat]
    n_t = tgt_normal_w.reshape(-1, 3)[flat]
    assoc_valid = tgt_valid.reshape(-1)[flat] & sel_flat
    if tgt_rgb is not None:
        i_t = tgt_rgb[0].reshape(-1)[flat]
        gx_t = tgt_rgb[1].reshape(-1)[flat]
        gy_t = tgt_rgb[2].reshape(-1)[flat]
        return q_w, n_t, assoc_valid, (i_t, gx_t, gy_t, assoc_valid)
    return q_w, n_t, assoc_valid


def reduce_equations(
    vmap_src_c: jnp.ndarray,  # (H,W,3)
    nmap_src_c: jnp.ndarray,  # (H,W,3)
    valid_src: jnp.ndarray,  # (H,W)
    q_w: jnp.ndarray,  # (HW,3) associated target vertices
    n_t: jnp.ndarray,  # (HW,3) associated target normals
    assoc_valid: jnp.ndarray,  # (HW,)
    T_est_wc: jnp.ndarray,
    cfg: IcpConfig,
):
    """One Gauss-Newton linearization on fixed correspondences.

    Twist convention: left-multiplied increment in the world frame,
    p' = exp(xi) @ T_est @ p, xi = [v, w] =>
    J = d(n·(p' - q))/dxi = [n, p_w x n].
    Returns (H 6x6, b 6, inliers, |r| sum).
    """
    p_w = transform_points(T_est_wc, vmap_src_c.reshape(-1, 3))
    n_w = rotate_vectors(T_est_wc, nmap_src_c.reshape(-1, 3))
    diff = p_w - q_w
    dist = jnp.linalg.norm(diff, axis=-1)
    n_dot = jnp.sum(n_w * n_t, axis=-1)
    mask = (
        valid_src.reshape(-1)
        & assoc_valid
        & (dist < cfg.dist_thresh)
        & (n_dot > cfg.angle_thresh)
    )
    m = mask.astype(jnp.float32)
    r = jnp.sum(n_t * diff, axis=-1)  # point-to-plane residual
    J = jnp.concatenate([n_t, jnp.cross(p_w, n_t)], axis=-1)  # (HW, 6)
    # IRLS: H = sum w J Jt, b = -sum w J r (w = gate x Huber weight).
    if cfg.huber_delta > 0.0:
        w = m * jnp.minimum(
            1.0, cfg.huber_delta / jnp.maximum(jnp.abs(r), 1e-9)
        )
    else:
        w = m
    Jm = J * jnp.sqrt(w)[:, None]
    # The "27-float reduction": one small f32 matmul.
    H6 = jnp.matmul(Jm.T, Jm, precision=_PREC)
    b6 = -jnp.matmul(J.T, (r * w)[:, None], precision=_PREC)[:, 0]
    inliers = jnp.sum(m)
    res_sum = jnp.sum(jnp.abs(r) * w)
    return H6, b6, inliers, res_sum


def build_normal_equations(
    vmap_src_c: jnp.ndarray,
    nmap_src_c: jnp.ndarray,
    valid_src: jnp.ndarray,
    tgt_vertex_w: jnp.ndarray,
    tgt_normal_w: jnp.ndarray,
    tgt_valid: jnp.ndarray,
    T_est_wc: jnp.ndarray,
    T_tgt_cw: jnp.ndarray,
    intr: Intrinsics,
    cfg: IcpConfig,
):
    """One ICP linearization with fresh association (associate + reduce)."""
    q_w, n_t, assoc_valid = associate(
        vmap_src_c, valid_src, tgt_vertex_w, tgt_normal_w, tgt_valid,
        T_est_wc, T_tgt_cw, intr, cfg,
    )
    return reduce_equations(
        vmap_src_c, nmap_src_c, valid_src, q_w, n_t, assoc_valid,
        T_est_wc, cfg,
    )


def intensity_gradients(tgt_intensity: jnp.ndarray):
    """Central-difference image gradients of the predicted intensity.

    Border rows/cols are zeroed (jnp.roll wraps around): a zero gradient
    makes a border correspondence contribute nothing to the photometric
    system, so no in-image margin test is needed at gather time.
    """
    h, w = tgt_intensity.shape
    gx = 0.5 * (jnp.roll(tgt_intensity, -1, 1) - jnp.roll(tgt_intensity, 1, 1))
    gy = 0.5 * (jnp.roll(tgt_intensity, -1, 0) - jnp.roll(tgt_intensity, 1, 0))
    col = jnp.arange(w)
    row = jnp.arange(h)[:, None]
    interior = (col > 0) & (col < w - 1) & (row > 0) & (row < h - 1)
    return jnp.where(interior, gx, 0.0), jnp.where(interior, gy, 0.0)


def reduce_rgb_equations(
    vmap_src_c: jnp.ndarray,  # (H,W,3)
    intensity_src: jnp.ndarray,  # (H,W)
    i_t: jnp.ndarray,  # (HW,) gathered target intensity (associate tgt_rgb)
    gx_t: jnp.ndarray,  # (HW,) gathered target gradients
    gy_t: jnp.ndarray,
    rgb_valid: jnp.ndarray,  # (HW,) bool
    T_est_wc: jnp.ndarray,
    T_tgt_cw: jnp.ndarray,
    intr: Intrinsics,
):
    """Photometric GN system on FIXED gathered targets: r = I_t - I_src.

    Jacobian chain: dI/d(u,v) x d(u,v)/dp_c x dp_c/dxi, recomputed per
    pose; everything elementwise + one f32 matmul, zero gathers.
    """
    p_w = transform_points(T_est_wc, vmap_src_c.reshape(-1, 3))
    p_tc = transform_points(T_tgt_cw, p_w)
    zsafe = jnp.maximum(p_tc[:, 2], 1e-6)
    r = i_t - intensity_src.reshape(-1)
    gpx = gx_t * intr.fx / zsafe
    gpy = gy_t * intr.fy / zsafe
    gpz = -(gpx * p_tc[:, 0] + gpy * p_tc[:, 1]) / zsafe
    grad_pc = jnp.stack([gpx, gpy, gpz], axis=-1)  # dI/dp_c (3,)
    # dp_c/dxi with left world increment: dp_c = R_cw (dv - p_w x dw)
    R_cw = T_tgt_cw[:3, :3]
    gw = jnp.matmul(grad_pc, R_cw, precision=_PREC)  # dI/dp_w
    J = jnp.concatenate([gw, jnp.cross(p_w, gw)], axis=-1)
    m = rgb_valid.astype(jnp.float32) * jnp.where(p_tc[:, 2] > 0.0, 1.0, 0.0)
    Jm = J * m[:, None]
    H6 = jnp.matmul(Jm.T, Jm, precision=_PREC)
    b6 = -jnp.matmul(Jm.T, (r * m)[:, None], precision=_PREC)[:, 0]
    return H6, b6, jnp.sum(m), jnp.sum(jnp.abs(r) * m)


def solve_increment(H6: jnp.ndarray, b6: jnp.ndarray, cfg: IcpConfig) -> jnp.ndarray:
    """Damped 6x6 solve; returns xi (6,). NaN-safe (falls back to zero)."""
    damp = cfg.damping * jnp.maximum(jnp.diag(H6), 1.0)
    xi = jnp.linalg.solve(H6 + jnp.diag(damp), b6)
    return jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6, H6.dtype))


def _subsample_maps(vertex_w, normal_w, valid, lvl):
    """Nearest-subsample prediction maps to pyramid level `lvl`."""
    if lvl == 0:
        return vertex_w, normal_w, valid
    s = 1 << lvl
    return decimate(vertex_w, s), decimate(normal_w, s), decimate(valid, s)


def track(
    src_pyramid,  # list over levels (fine->coarse) of preprocess dicts
    pred_vertex_w: jnp.ndarray,  # full-res prediction maps (world frame)
    pred_normal_w: jnp.ndarray,
    pred_valid: jnp.ndarray,
    T_init_wc: jnp.ndarray,
    T_pred_wc: jnp.ndarray,  # pose the prediction was rendered from
    intr: Intrinsics,
    cfg: IcpConfig,
    pred_intensity: jnp.ndarray | None = None,
) -> TrackResult:
    """Coarse-to-fine projective ICP against the predicted model view."""
    T_pred_cw = se3_inverse(T_pred_wc)
    T = T_init_wc
    use_rgb = cfg.rgb_weight > 0.0 and pred_intensity is not None

    inliers = jnp.zeros(())
    res_mean = jnp.zeros(())
    for lvl in range(cfg.levels - 1, -1, -1):  # coarse -> fine
        src = src_pyramid[lvl]
        intr_l = intr.level(lvl)
        tv, tn, tval = _subsample_maps(pred_vertex_w, pred_normal_w, pred_valid, lvl)
        s_l = 1 << lvl
        if use_rgb:
            ti = decimate(pred_intensity, s_l)
            ti_gx, ti_gy = intensity_gradients(ti)

        def inner_body(_, carry):
            T, _, _, q_w, n_t, a_ok, rgb_fix = carry
            H6, b6, nin, rsum = reduce_equations(
                src["vmap"], src["nmap"], src["valid"],
                q_w, n_t, a_ok, T, cfg,
            )
            if use_rgb:
                Hr, br, _, _ = reduce_rgb_equations(
                    src["vmap"], src["intensity"], *rgb_fix,
                    T, T_pred_cw, intr_l,
                )
                # Trust-fraction combine: the raw photometric JtJ scales
                # with fx^2 (intensity gradients x fx/z) and would bury
                # the geometric system ~10^3:1 at VGA; normalizing by the
                # trace ratio makes rgb_weight the resolution-independent
                # FRACTION of the joint information the photometric term
                # carries.
                wr = cfg.rgb_weight * jnp.trace(H6) / jnp.maximum(
                    jnp.trace(Hr), 1e-20
                )
                H6 = H6 + wr * Hr
                b6 = b6 + wr * br
            xi = solve_increment(H6, b6, cfg)
            ok = nin >= cfg.min_valid
            xi = jnp.where(ok, xi, jnp.zeros_like(xi))
            T_new = jnp.matmul(se3_exp(xi), T, precision=_PREC)
            return T_new, nin, rsum, q_w, n_t, a_ok, rgb_fix

        def outer_body(_, carry):
            T, nin, rsum = carry
            if use_rgb:
                # One association pass gathers the geometric AND
                # photometric targets.
                q_w, n_t, a_ok, rgb_fix = associate(
                    src["vmap"], src["valid"], tv, tn, tval,
                    T, T_pred_cw, intr_l, cfg,
                    tgt_rgb=(ti, ti_gx, ti_gy),
                )
            else:
                q_w, n_t, a_ok = associate(
                    src["vmap"], src["valid"], tv, tn, tval,
                    T, T_pred_cw, intr_l, cfg,
                )
                rgb_fix = None
            T, nin, rsum, _, _, _, _ = jax.lax.fori_loop(
                0, inner_n,
                inner_body,
                (T, nin, rsum, q_w, n_t, a_ok, rgb_fix),
            )
            return T, nin, rsum

        # cfg.iters is coarse->fine (reference schedule: ~10 at the coarsest
        # level, ~4 at full resolution); lvl counts fine->coarse, so flip.
        # Association (the gather) runs every `assoc_every` GN steps; the
        # steps in between reuse the correspondences (see `associate`).
        idx = max(0, min(cfg.levels - 1 - lvl, len(cfg.iters) - 1))
        n_it = cfg.iters[idx]
        ae = cfg.assoc_every
        if isinstance(ae, tuple):
            ae = ae[min(idx, len(ae) - 1)]
        inner_n = max(1, min(ae, n_it))
        outer_n = -(-n_it // inner_n)
        carry = (T, jnp.zeros(()), jnp.zeros(()))
        if outer_n <= 8:
            # Unroll short static outer loops: a While op pays a carry
            # copy + loop bookkeeping per step that straight-line code
            # does not.
            for _ in range(outer_n):
                carry = outer_body(0, carry)
            T, inliers, res_sum = carry
        else:
            T, inliers, res_sum = jax.lax.fori_loop(
                0, outer_n, outer_body, carry
            )
        res_mean = res_sum / jnp.maximum(inliers, 1.0)

    ok = (inliers >= cfg.min_valid) & jnp.all(jnp.isfinite(T))
    T_out = jnp.where(ok, T, T_init_wc)
    return TrackResult(T_wc=T_out, inliers=inliers, residual=res_mean, valid=ok)
