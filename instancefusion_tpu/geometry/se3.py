"""SE(3)/SO(3) Lie-group utilities, pure jnp.

Replaces the Sophus/Eigen pose algebra used throughout the reference's
tracking stack (expected ``Core/src/RGBDOdometry.cpp`` — SURVEY.md §3; the
reference solves its 6x6 normal equations on the CPU and applies
``exp(xi)`` updates per ICP iteration).  Here everything is traced jnp so
the full ICP iteration loop stays on-device inside one ``jit``.

Conventions:
- Poses are 4x4 float32 row-major matrices ``T`` mapping points from the
  "source" frame to the "destination" frame: ``p_dst = T @ [p_src, 1]``.
- Camera poses are camera-to-world ``T_wc`` unless suffixed otherwise.
- Twists are 6-vectors ``xi = [v, w]`` — translation part first, rotation
  (so(3)) part second.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Pose algebra operates on 3x3/4x4 matrices — negligible FLOPs, but the
# default f32 matmul precision may run in TF32 on GPUs (~3 decimal digits),
# far too coarse for mm-level tracking.  Force full f32 for every matmul in
# this module.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _skew(w: jnp.ndarray) -> jnp.ndarray:
    """[w]_x such that [w]_x @ p = w x p.  w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula. w: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Branch-free small-angle handling (Taylor series blended via where) so it
    is safe under jit/grad.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks near 0.
    small = theta2 < 1e-4
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    half_sin = jnp.sin(0.5 * theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 2.0 * half_sin * half_sin / theta2)
    K = _skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (_mm(K, K))


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse of so3_exp. R: (..., 3, 3) -> (..., 3) axis-angle.

    Three regimes, all `where`-NaN-safe (each dangerous formula only ever
    sees sanitized inputs, because NaN * 0 = NaN in gradients and jacfwd
    differentiates through this in pose-graph BA — ops/ba.py):

    - theta ~ 0: series  theta/(2 sin t) = 1/2 + (1 - cos t)/6 + O(t^4),
      smooth in the matrix entries (d(arccos) -> inf at cos t = 1).
    - mid:       w = theta/(2 sin t) * vee.
    - theta ~ pi: vee -> 0 and sin t -> 0; recover the axis from the rank-1
      structure (R + I)/2 = a a^T + O(pi - t) via its largest column
      (selected with a one-hot matmul, not a dynamic gather).  Loop
      closures between opposite-heading keyframes land exactly here.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # theta < ~0.01 rad: arccos near 1 is ill-conditioned in f32 (1 - cos t
    # underflows relative precision); the series is exact to O(theta^4).
    small = cos_t > 1.0 - 5e-5
    near_pi = cos_t < -1.0 + 1e-4
    mid = jnp.logical_not(small | near_pi)

    safe_cos = jnp.where(mid, cos_t, jnp.zeros_like(cos_t))
    theta_mid = jnp.arccos(safe_cos)
    scale_big = theta_mid / (2.0 * jnp.sin(theta_mid) + _EPS)
    scale_small = 0.5 + (1.0 - cos_t) / 6.0
    w_regular = jnp.where(small, scale_small, scale_big)[..., None] * vee

    # theta ~ pi branch: B = (R + I)/2 ~= a a^T; pick the largest column.
    B = 0.5 * (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape))
    diagB = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    kbest = jnp.argmax(diagB, axis=-1)
    oh = jax.nn.one_hot(kbest, 3, dtype=R.dtype)
    col = _mm(B, oh[..., None])[..., 0]
    axis = col / jnp.maximum(
        jnp.linalg.norm(col, axis=-1, keepdims=True), _EPS
    )
    # Orient the axis consistently with vee (vee = 2 sin(t) * axis >= 0
    # component along axis away from exactly pi).
    sgn = jnp.sign(jnp.sum(vee * axis, axis=-1, keepdims=True))
    axis = jnp.where(sgn < 0.0, -axis, axis)
    # Sanitize for the untaken-branch gradient: |vee| is non-smooth at 0
    # (eps-regularized sqrt) and d(arcsin) -> inf at 1 (cap away from 1;
    # mid-range rotations can hit sin t = 1 exactly and would poison the
    # jacobian through where's NaN * 0).
    sin_t = jnp.sqrt(jnp.sum(vee * vee, axis=-1) + _EPS * _EPS) * 0.5
    theta_pi = jnp.pi - jnp.arcsin(jnp.clip(sin_t, 0.0, 1.0 - 1e-6))
    w_pi = theta_pi[..., None] * axis

    return jnp.where(near_pi[..., None], w_pi, w_regular)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """xi = [v, w] (..., 6) -> (..., 4, 4) rigid transform.

    T = [[exp([w]x), V v], [0, 1]] with the standard left-Jacobian V.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-4
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    half_sin = jnp.sin(0.5 * theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 2.0 * half_sin * half_sin / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    K = _skew(w)
    K2 = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * K2
    V = eye + b[..., None, None] * K + c[..., None, None] * K2
    t = (_mm(V, v[..., None]))[..., 0]
    batch = xi.shape[:-1]
    T = jnp.zeros(batch + (4, 4), dtype=xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) twist [v, w]. Inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-4
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    half_sin = jnp.sin(0.5 * theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 2.0 * half_sin * half_sin / theta2)
    K = _skew(w)
    K2 = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape)
    # V^-1 = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2
    vinv_c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / jnp.maximum(theta2, _EPS),
    )
    Vinv = eye - 0.5 * K + vinv_c[..., None, None] * K2
    v = (_mm(Vinv, t[..., None]))[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form rigid-transform inverse: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -(_mm(Rt, t[..., None]))[..., 0]
    Ti = jnp.zeros_like(T)
    Ti = Ti.at[..., :3, :3].set(Rt)
    Ti = Ti.at[..., :3, 3].set(ti)
    Ti = Ti.at[..., 3, 3].set(1.0)
    return Ti


def orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation part back onto SO(3) (Gram-Schmidt).

    Long products of exp-updates drift off the manifold in f32; drifted
    rotations push trace(R) past 3 and destabilize so3_log's branch
    boundaries (pose-graph GN iterates through exactly that path).
    """
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / jnp.maximum(jnp.linalg.norm(c0, axis=-1, keepdims=True), _EPS)
    c1 = R[..., :, 1]
    c1 = c1 - jnp.sum(c0 * c1, axis=-1, keepdims=True) * c0
    c1 = c1 / jnp.maximum(jnp.linalg.norm(c1, axis=-1, keepdims=True), _EPS)
    c2 = jnp.cross(c0, c1)
    Rn = jnp.stack([c0, c1, c2], axis=-1)
    return T.at[..., :3, :3].set(Rn)


def transform_points(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply (4,4) T to points (..., 3)."""
    return _mm(p, T[:3, :3].T) + T[:3, 3]


def rotate_vectors(T: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotation of (4,4) T to vectors (..., 3)."""
    return _mm(n, T[:3, :3].T)
