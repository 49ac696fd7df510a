"""Keyframe store, fern loop detection, ICP verification, graph correction.

The backend layer of the engine (SURVEY.md §4.6): the reference detects
global loops with a fern keyframe database, verifies them by registration,
and corrects the map with an embedded deformation graph; here the map
correction is the BASELINE-mandated keyframe pose graph optimized by
Gauss-Newton (ops/ba.py), with loop edges produced by re-running the
tracking ICP between the current frame and the retrieved keyframe's
stored maps.

All state is fixed-capacity pytrees; the host driver (cli / pipeline)
decides *when* to call each piece (keyframe cadence, optimization
trigger), the pieces themselves are jit-able.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.ops.common import decimate
from instancefusion_tpu.config import EngineConfig, PoseGraphConfig
from instancefusion_tpu.geometry.camera import Intrinsics
from instancefusion_tpu.geometry.se3 import se3_inverse, transform_points, rotate_vectors
from instancefusion_tpu.ops import ba, ferns, icp


class KeyframeStore(NamedTuple):
    poses: jnp.ndarray  # f32[M,4,4] — T_wc at insertion (updated by BA)
    codes: jnp.ndarray  # u8[M,F] — fern codes
    vertex_c: jnp.ndarray  # f32[M,h,w,3] — decimated camera-frame vertices
    normal_c: jnp.ndarray  # f32[M,h,w,3]
    valid: jnp.ndarray  # bool[M,h,w]
    frame_idx: jnp.ndarray  # i32[M]
    count: jnp.ndarray  # () i32


class BackendState(NamedTuple):
    kf: KeyframeStore
    graph: ba.PoseGraph
    n_edges: jnp.ndarray  # () i32
    coder: ferns.FernCoder
    n_loops: jnp.ndarray  # () i32
    # Landmark bank for loop-closure BA (PoseGraphConfig.use_landmark_ba):
    # fixed-capacity paired observations (ops/ba.PairedObs) + world points,
    # appended per verified loop, consumed by `optimize_landmark`.
    points: jnp.ndarray = None  # f32[Lcap, 3]
    lm: ba.PairedObs = None
    n_points: jnp.ndarray = None  # () i32
    lm_dropped: jnp.ndarray = None  # () i32 — landmarks beyond capacity


def allocate(cfg: EngineConfig, decim: int = 4, seed: int = 0) -> BackendState:
    pg = cfg.posegraph
    intr = cfg.intrinsics
    h, w = intr.height // decim, intr.width // decim
    m = pg.max_keyframes
    coder = ferns.make_coder(jax.random.PRNGKey(seed), intr.height, intr.width,
                             pg.fern_count)
    return BackendState(
        kf=KeyframeStore(
            poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (m, 4, 4)),
            codes=jnp.zeros((m, pg.fern_count), jnp.uint8),
            vertex_c=jnp.zeros((m, h, w, 3), jnp.float32),
            normal_c=jnp.zeros((m, h, w, 3), jnp.float32),
            valid=jnp.zeros((m, h, w), bool),
            frame_idx=jnp.zeros((m,), jnp.int32),
            count=jnp.zeros((), jnp.int32),
        ),
        graph=ba.empty_graph(pg.max_edges),
        n_edges=jnp.zeros((), jnp.int32),
        coder=coder,
        n_loops=jnp.zeros((), jnp.int32),
        points=jnp.zeros((pg.max_landmarks, 3), jnp.float32),
        lm=ba.empty_paired_obs(pg.max_landmarks),
        n_points=jnp.zeros((), jnp.int32),
        lm_dropped=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnums=(6,))
def add_keyframe(
    bs: BackendState,
    T_wc: jnp.ndarray,
    color: jnp.ndarray,
    depth: jnp.ndarray,
    vertex_c: jnp.ndarray,  # full-res camera-frame vertex map (preprocess)
    normal_c: jnp.ndarray,
    decim: int = 4,
) -> BackendState:
    """Insert a keyframe: fern code + decimated geometry + odometry edge.

    The odometry edge links the previous keyframe to this one with the
    tracked relative pose (weight 1); loop edges added later carry higher
    weight after ICP verification.
    """
    code = ferns.encode(bs.coder, color, depth)
    v = decimate(vertex_c, decim)
    n = decimate(normal_c, decim)
    val = (decimate(depth, decim) > 0.0) & (
        jnp.linalg.norm(n, axis=-1) > 1e-6
    )
    i = jnp.minimum(bs.kf.count, bs.kf.poses.shape[0] - 1)
    kf = KeyframeStore(
        poses=bs.kf.poses.at[i].set(T_wc),
        codes=bs.kf.codes.at[i].set(code),
        vertex_c=bs.kf.vertex_c.at[i].set(v),
        normal_c=bs.kf.normal_c.at[i].set(n),
        valid=bs.kf.valid.at[i].set(val),
        frame_idx=bs.kf.frame_idx.at[i].set(bs.kf.count),
        count=jnp.minimum(bs.kf.count + 1, bs.kf.poses.shape[0]),
    )
    # Odometry edge (i-1 -> i) from the tracked poses.
    prev = jnp.maximum(i - 1, 0)
    T_rel = jnp.matmul(
        se3_inverse(kf.poses[prev]), T_wc, precision=jax.lax.Precision.HIGHEST
    )
    graph, n_edges = ba.add_edge(bs.graph, bs.n_edges, prev, i, T_rel, 1.0)
    has_prev = i > 0
    graph = jax.tree_util.tree_map(
        lambda new, old: jnp.where(has_prev, new, old), graph, bs.graph
    )
    n_edges = jnp.where(has_prev, n_edges, bs.n_edges)
    return bs._replace(kf=kf, graph=graph, n_edges=n_edges)


@functools.partial(jax.jit, static_argnums=(3,))
def detect_loop(
    bs: BackendState,
    color: jnp.ndarray,
    depth: jnp.ndarray,
    min_gap: int = 3,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fern retrieval for the current frame: (best_kf_index, dissimilarity).

    Excludes the `min_gap` most recent keyframes (a frame always resembles
    its immediate past).
    """
    code = ferns.encode(bs.coder, color, depth)
    return ferns.find_best(
        code, bs.kf.codes,
        jax.lax.broadcasted_iota(jnp.int32, (bs.kf.codes.shape[0], 1), 0)[:, 0]
        < bs.kf.count,
        bs.kf.count - min_gap,
    )


def decimated_min_valid(min_valid: int, decim: int) -> int:
    """Tracking-health pixel gate rescaled to a decimated resolution.

    A decimated map has 1/decim^2 of the full-resolution pixels, so the
    proportional gate would be min_valid/decim^2; loop verification
    deliberately keeps DOUBLE that (divide by decim^2/2, i.e. gate at
    2x the proportional count) because a loop edge feeds the pose graph
    at 10x odometry weight — a marginal-overlap "verification" there is
    far more damaging than a conservatively rejected loop.  Pinned by
    tests/test_posegraph.py::test_decimated_min_valid.
    """
    return max(1, min_valid // max(decim * decim // 2, 1))


@functools.partial(jax.jit, static_argnums=(4, 5))
def verify_loop(
    bs: BackendState,
    cand: jnp.ndarray,  # () i32 keyframe index
    vertex_c: jnp.ndarray,  # current frame camera-frame vertex map (full res)
    normal_c: jnp.ndarray,
    intr: Intrinsics,
    cfg: EngineConfig,
    T_cur_wc: jnp.ndarray = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """ICP the current frame against the candidate keyframe's stored maps.

    Returns (T_rel (4,4): T_kf^-1 T_cur, inliers, ok).  Runs the same
    point-to-plane machinery as tracking (icp.build_normal_equations) at
    the keyframe's decimated resolution — the reference reuses its
    RGBDOdometry for exactly this (SURVEY §4.6).
    """
    decim = vertex_c.shape[0] // bs.kf.vertex_c.shape[1]
    kf_pose = bs.kf.poses[cand]
    # Target maps: keyframe geometry in world frame.
    tv = transform_points(
        kf_pose, bs.kf.vertex_c[cand].reshape(-1, 3)
    ).reshape(bs.kf.vertex_c[cand].shape)
    tn = rotate_vectors(kf_pose, bs.kf.normal_c[cand].reshape(-1, 3)).reshape(tv.shape)
    tval = bs.kf.valid[cand]

    intr_d = Intrinsics(
        fx=intr.fx / decim, fy=intr.fy / decim,
        cx=(intr.cx + 0.5) / decim - 0.5, cy=(intr.cy + 0.5) / decim - 0.5,
        width=intr.width // decim, height=intr.height // decim,
    )
    src_v = decimate(vertex_c, decim)
    src_n = decimate(normal_c, decim)
    src_val = (src_v[..., 2] > 0.0) & (jnp.linalg.norm(src_n, axis=-1) > 1e-6)

    # Initialize at the tracked pose if given, else at the keyframe pose.
    T0 = kf_pose if T_cur_wc is None else T_cur_wc
    pyr = [{"vmap": src_v, "nmap": src_n, "valid": src_val}]
    icp_cfg = cfg.icp.__class__(
        iters=(cfg.posegraph.ba_iters,), levels=1,
        dist_thresh=cfg.icp.dist_thresh * 2.0,
        angle_thresh=cfg.icp.angle_thresh,
        rgb_weight=0.0, damping=cfg.icp.damping,
        min_valid=decimated_min_valid(cfg.icp.min_valid, decim),
    )
    result = icp.track(
        pyr, tv, tn, tval, T0, kf_pose, intr_d, icp_cfg
    )
    T_rel = jnp.matmul(
        se3_inverse(kf_pose), result.T_wc, precision=jax.lax.Precision.HIGHEST
    )
    min_inl = (intr_d.width * intr_d.height) * 0.2
    ok = result.valid & (result.inliers > min_inl) & (
        result.residual < cfg.tsdf.voxel_size
    )
    return T_rel, result.inliers, ok


def add_loop_edge(
    bs: BackendState, kf_i: jnp.ndarray, kf_j: jnp.ndarray, T_rel: jnp.ndarray,
    weight: float = 10.0,
) -> BackendState:
    graph, n_edges = ba.add_edge(bs.graph, bs.n_edges, kf_i, kf_j, T_rel, weight)
    return bs._replace(graph=graph, n_edges=n_edges, n_loops=bs.n_loops + 1)


@functools.partial(jax.jit, static_argnums=(4, 5))
def build_loop_landmarks(
    bs: BackendState,
    kf_i: jnp.ndarray,  # () i32 — loop candidate (older keyframe)
    kf_j: jnp.ndarray,  # () i32 — current keyframe
    T_rel: jnp.ndarray,  # (4,4) verified T_i^-1 T_j from verify_loop
    intr: Intrinsics,
    cfg: EngineConfig,
) -> tuple[jnp.ndarray, ba.PairedObs]:
    """Sample paired landmark observations across a verified loop pair.

    The BAObservations producer (SURVEY.md §4.6): up to
    `cfg.posegraph.landmarks_per_loop` pixels are sampled on a stride
    grid from keyframe i's stored decimated vertex map, lifted to world
    landmarks at i's current pose, and projectively associated into
    keyframe j's stored maps through the ICP-verified relative pose (so
    association quality is independent of accumulated global drift).
    Measurements stay raw camera-frame vertices; validity requires
    in-image projection, a 3D distance gate (icp.dist_thresh) and normal
    agreement across the pair.  Returns (points (L,3) world, PairedObs).
    """
    pgc = cfg.posegraph
    L = pgc.landmarks_per_loop
    from instancefusion_tpu.ops.blocks import compact_mask_indices

    v_i = bs.kf.vertex_c[kf_i]  # (h,w,3) camera-frame
    n_i = bs.kf.normal_c[kf_i]
    val_i = bs.kf.valid[kf_i]
    v_j = bs.kf.vertex_c[kf_j]
    n_j = bs.kf.normal_c[kf_j]
    val_j = bs.kf.valid[kf_j]
    h, w = val_i.shape
    decim = intr.height // h
    intr_d = Intrinsics(
        fx=intr.fx / decim, fy=intr.fy / decim,
        cx=(intr.cx + 0.5) / decim - 0.5, cy=(intr.cy + 0.5) / decim - 0.5,
        width=w, height=h,
    )

    # Even-spread sampling: compact ALL valid pixels (scan order), then
    # take every (hw/L)-th of the compacted list — the L samples spread
    # uniformly over the whole valid set instead of clustering at the top
    # rows of the image.
    flat_val = val_i.reshape(-1)
    hw = h * w
    per = max(1, hw // max(L, 1))
    cidx, cok = compact_mask_indices(flat_val, per * L)
    pix = cidx.reshape(L, per)[:, 0]
    ok = cok.reshape(L, per)[:, 0]

    za = v_i.reshape(-1, 3)[pix]  # measured camera-frame position in i
    na = n_i.reshape(-1, 3)[pix]
    # Associate into j through the verified relative pose.
    T_ji = se3_inverse(T_rel)  # j <- i
    p_cj = transform_points(T_ji, za)
    nb_in_j = rotate_vectors(T_ji, na)
    z = jnp.maximum(p_cj[:, 2], 1e-6)
    u = intr_d.fx * p_cj[:, 0] / z + intr_d.cx
    v = intr_d.fy * p_cj[:, 1] / z + intr_d.cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (p_cj[:, 2] > 0)
    uic = jnp.clip(ui, 0, w - 1)
    vic = jnp.clip(vi, 0, h - 1)
    zb = v_j[vic, uic]  # measured camera-frame position in j
    nb = n_j[vic, uic]
    dist_ok = jnp.linalg.norm(p_cj - zb, axis=-1) < cfg.icp.dist_thresh
    norm_ok = jnp.sum(nb_in_j * nb, axis=-1) > 0.6
    valid = ok & in_img & val_j[vic, uic] & dist_ok & norm_ok

    points = transform_points(bs.kf.poses[kf_i], za)  # world init at i's pose
    obs = ba.PairedObs(
        ka=jnp.full((L,), kf_i, jnp.int32),
        kb=jnp.full((L,), kf_j, jnp.int32),
        za=za,
        zb=zb,
        weight=jnp.full((L,), pgc.landmark_weight, jnp.float32),
        valid=valid,
    )
    return points, obs


def add_loop_landmarks(
    bs: BackendState, points: jnp.ndarray, obs: ba.PairedObs
) -> BackendState:
    """Append a loop's landmarks into the fixed-capacity bank.

    Valid landmarks are compacted to the front of the new rows; rows
    beyond `max_landmarks` are dropped and counted in `lm_dropped`.
    """
    cap = bs.points.shape[0]
    L = points.shape[0]
    order = jnp.cumsum(obs.valid.astype(jnp.int32)) - 1
    slot = bs.n_points + order
    fits = obs.valid & (slot < cap)
    out = jnp.where(fits, slot, cap)  # OOB -> dropped
    n_new = jnp.sum(fits.astype(jnp.int32))
    n_drop = jnp.sum(obs.valid.astype(jnp.int32)) - n_new
    lm = ba.PairedObs(
        ka=bs.lm.ka.at[out].set(obs.ka, mode="drop"),
        kb=bs.lm.kb.at[out].set(obs.kb, mode="drop"),
        za=bs.lm.za.at[out].set(obs.za, mode="drop"),
        zb=bs.lm.zb.at[out].set(obs.zb, mode="drop"),
        weight=bs.lm.weight.at[out].set(obs.weight, mode="drop"),
        valid=bs.lm.valid.at[out].set(True, mode="drop"),
    )
    return bs._replace(
        points=bs.points.at[out].set(points, mode="drop"),
        lm=lm,
        n_points=bs.n_points + n_new,
        lm_dropped=bs.lm_dropped + n_drop,
    )


@functools.partial(jax.jit, static_argnums=(1,))
def optimize(bs: BackendState, cfg: PoseGraphConfig) -> tuple[BackendState, jnp.ndarray]:
    """Gauss-Newton over all keyframe poses; returns (state, final cost)."""
    poses, cost = ba.optimize_pose_graph(
        bs.kf.poses, bs.graph, iters=cfg.ba_iters
    )
    # Untouched (unused) rows keep identity; BA only moves rows referenced
    # by valid edges, but guard anyway so count stays authoritative.
    m = poses.shape[0]
    used = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0] < bs.kf.count
    poses = jnp.where(used[:, None, None], poses, bs.kf.poses)
    return bs._replace(kf=bs.kf._replace(poses=poses)), cost


@functools.partial(jax.jit, static_argnums=(1, 2))
def optimize_landmark(
    bs: BackendState, cfg: PoseGraphConfig, terms_fn=None
) -> tuple[BackendState, jnp.ndarray]:
    """Joint pose-graph + landmark Schur BA over the whole backend.

    The live loop-closure solver (BASELINE "loop-closure bundle
    adjustment ... distributed Schur-complement reduction"): pose-graph
    edges anchor the odometry chain while the landmark bank's paired
    observations re-estimate the loop-pair geometry.  `terms_fn` injects
    the psum-sharded reducer (parallel.shard.sharded_paired_terms) on a
    mesh; None runs single-device.  With an empty bank this degrades to
    `optimize`.
    """
    poses, points, cost = ba.optimize_hybrid_paired(
        bs.kf.poses, bs.graph, bs.points, bs.lm,
        iters=cfg.ba_iters, terms_fn=terms_fn,
    )
    m = poses.shape[0]
    used = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0] < bs.kf.count
    poses = jnp.where(used[:, None, None], poses, bs.kf.poses)
    return bs._replace(kf=bs.kf._replace(poses=poses), points=points), cost
