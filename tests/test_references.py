"""Plain ops vs independent float64 numpy references.

These are the CPU-side correctness anchors of the per-frame path that runs
on the GPU (chip_smoke.py compares the same ops across devices): ICP
normal equations and association, block integration, the label vote and
the level-0 preprocessing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.config import IcpConfig, PreprocessConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.geometry.camera import Intrinsics
from instancefusion_tpu.ops import blocks, icp, labels, preprocess
from tests.helpers import SMALL_INTR, SMALL_TSDF

RNG = np.random.default_rng(3)


def _pose(rng, scale=0.1):
    """A random rigid (4,4) float64 transform."""
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3) * scale
    return T


# --- ICP normal equations --------------------------------------------------


def _reduce_ref(vs, ns, val, q, nt, aok, T, cfg):
    p = vs.reshape(-1, 3) @ T[:3, :3].T + T[:3, 3]
    n = ns.reshape(-1, 3) @ T[:3, :3].T
    diff = p - q
    m = (val.reshape(-1) & aok & (np.linalg.norm(diff, axis=-1) < cfg.dist_thresh)
         & (np.sum(n * nt, -1) > cfg.angle_thresh)).astype(np.float64)
    r = np.sum(nt * diff, -1)
    J = np.concatenate([nt, np.cross(p, nt)], -1)
    w = m
    if cfg.huber_delta > 0:
        w = m * np.minimum(1.0, cfg.huber_delta / np.maximum(np.abs(r), 1e-9))
    H = (J * w[:, None]).T @ J
    b = -(J * (w * r)[:, None]).sum(0)
    return H, b, m.sum(), np.sum(np.abs(r) * w)


@pytest.mark.parametrize("huber", [0.0, 0.01], ids=["gate", "huber"])
def test_reduce_equations_matches_float64(huber):
    h, w = 48, 64
    vs = np.concatenate([RNG.uniform(-1, 1, (h, w, 2)),
                         RNG.uniform(1, 3, (h, w, 1))], -1)
    ns = RNG.normal(size=(h, w, 3))
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    ns[..., 2] = -np.abs(ns[..., 2])
    val = RNG.uniform(size=(h, w)) > 0.1
    T = _pose(RNG)
    p = vs.reshape(-1, 3) @ T[:3, :3].T + T[:3, 3]
    q = p + RNG.normal(size=p.shape) * 0.02
    nt = ns.reshape(-1, 3) @ T[:3, :3].T + RNG.normal(size=p.shape) * 0.05
    nt /= np.linalg.norm(nt, axis=-1, keepdims=True)
    aok = RNG.uniform(size=h * w) > 0.1
    cfg = IcpConfig(huber_delta=huber)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    H, b, nin, rs = icp.reduce_equations(
        f32(vs), f32(ns), jnp.asarray(val), f32(q), f32(nt), jnp.asarray(aok),
        f32(T), cfg)
    Hr, br, nr, rr = _reduce_ref(vs, ns, val, q, nt, aok, T, cfg)
    assert 1000 < nr < h * w
    assert abs(float(nin) - nr) <= 2  # gate ties at f32 vs f64
    np.testing.assert_allclose(np.asarray(H), Hr, rtol=0,
                               atol=2e-3 * np.abs(Hr).max())
    np.testing.assert_allclose(np.asarray(b), br, rtol=0,
                               atol=2e-3 * np.abs(br).max())
    assert abs(float(rs) - rr) <= 2e-3 * rr


# --- projective association (incl. the tie convention) --------------------


def test_associate_matches_float64_with_half_pixel_ties():
    # Power-of-two focal lengths and integer principal point: projections
    # on the quarter-pixel grid are exact in f32, half of them exactly
    # halfway between two pixel centers.
    intr = Intrinsics(fx=8.0, fy=8.0, cx=7.0, cy=5.0, width=16, height=12)
    h, w = 10, 12
    uq = RNG.integers(-4, 4 * 16 + 4, size=(h, w)) / 4.0
    vq = RNG.integers(-4, 4 * 12 + 4, size=(h, w)) / 4.0
    z = 2.0 ** RNG.integers(0, 3, size=(h, w))
    vs = np.stack([(uq - intr.cx) / intr.fx * z, (vq - intr.cy) / intr.fy * z, z], -1)
    val = RNG.uniform(size=(h, w)) > 0.05
    # Target maps encode their own pixel index.
    tu, tv = np.meshgrid(np.arange(16.0), np.arange(12.0))
    tgt_v = np.stack([tu, tv, np.ones_like(tu)], -1)
    tgt_n = np.stack([tv, tu, -np.ones_like(tu)], -1)
    tgt_ok = RNG.uniform(size=(12, 16)) > 0.2
    eye = jnp.eye(4)
    q, n, ok = icp.associate(
        jnp.asarray(vs, jnp.float32), jnp.asarray(val), jnp.asarray(tgt_v, jnp.float32),
        jnp.asarray(tgt_n, jnp.float32), jnp.asarray(tgt_ok), eye, eye, intr,
        IcpConfig())
    # float64 reference: ties go to the lower index (ceil(u - 0.5)).
    ui = np.ceil(uq - 0.5).astype(int).reshape(-1)
    vi = np.ceil(vq - 0.5).astype(int).reshape(-1)
    inb = (ui >= 0) & (ui < 16) & (vi >= 0) & (vi < 12)
    uc, vc = np.clip(ui, 0, 15), np.clip(vi, 0, 11)
    ties = (uq.reshape(-1) % 1 == 0.5)
    assert ties.sum() > 10
    np.testing.assert_array_equal(np.asarray(q)[:, 0], uc)
    np.testing.assert_array_equal(np.asarray(q)[:, 1], vc)
    np.testing.assert_array_equal(np.asarray(n)[:, 0], vc)
    np.testing.assert_array_equal(
        np.asarray(ok), tgt_ok[vc, uc] & inb & val.reshape(-1))


# --- block integration ----------------------------------------------------

BTSDF = dataclasses.replace(SMALL_TSDF, block_size=8, table_capacity=1728,
                            touched_capacity=512)


def _integrate_ref(coords, sdf, wgt, col, valid, depth, color, T, intr, cfg,
                   gain):
    b = cfg.block_size
    i = np.arange(b ** 3)
    local = np.stack([i // (b * b), (i // b) % b, i % b], -1)
    p_w = (np.asarray(cfg.origin) + (coords[:, None] * b + local[None] + 0.5)
           * cfg.voxel_size)
    Tcw = np.linalg.inv(T)
    p = p_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = p[..., 2]
    u = intr.fx * p[..., 0] / z + intr.cx
    v = intr.fy * p[..., 1] / z + intr.cy
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    inimg = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    uc, vc = np.clip(ui, 0, intr.width - 1), np.clip(vi, 0, intr.height - 1)
    d = depth[vc, uc]
    sd = d - z
    ok = inimg & (z > 0) & (d > 0) & (sd > -cfg.trunc) & valid[:, None]
    psi = np.clip(sd / cfg.trunc, -1, 1)
    wo = ok.astype(np.float64)
    wn = wgt + wo
    sdf_n = np.where(wn > 0, (sdf * wgt + psi * wo) / np.maximum(wn, 1e-6), sdf)
    c_obs = np.concatenate([color[vc, uc, c] for c in range(3)], -1)
    w3, wc3 = np.tile(wgt, 3), np.tile(gain * wo, 3)
    col_n = (col * w3 + c_obs * wc3) / np.maximum(w3 + wc3, 1e-6)
    return sdf_n, np.minimum(wn, cfg.max_weight), col_n


@pytest.mark.parametrize("gain", [1.0, 4.0], ids=["gain1", "gain4"])
def test_integrate_slots_matches_float64(gain):
    poses = synthetic.orbit_trajectory(3)
    f = synthetic.render_frame(poses[1], SMALL_INTR)
    bm = blocks.discover_allocate(blocks.allocate(BTSDF), f.depth, poses[1],
                                  SMALL_INTR, BTSDF)
    slots, valid = blocks.frustum_slots(bm, poses[1], SMALL_INTR, BTSDF,
                                        0.2, 4.0, 512)
    # Non-trivial previous payload so the running averages are exercised.
    c = bm.sdf.shape[0]
    bm = bm._replace(
        sdf=jnp.asarray(RNG.uniform(-1, 1, bm.sdf.shape), jnp.float32),
        weight=jnp.asarray(RNG.integers(0, 5, bm.weight.shape), jnp.float32),
        color=jnp.asarray(RNG.uniform(0, 1, (c, 3 * 512)), jnp.float32),
    )
    out = blocks.integrate_slots(bm, slots, valid, f.depth, f.color, poses[1],
                                 SMALL_INTR, BTSDF, color_gain=gain)
    s, v = np.asarray(slots), np.asarray(valid)
    assert v.sum() > 50
    s = s[v]
    ref = _integrate_ref(
        np.asarray(bm.block_coords)[s], np.asarray(bm.sdf, np.float64)[s],
        np.asarray(bm.weight, np.float64)[s], np.asarray(bm.color, np.float64)[s],
        np.ones(len(s), bool), np.asarray(f.depth, np.float64),
        np.asarray(f.color, np.float64), np.asarray(poses[1], np.float64),
        SMALL_INTR, BTSDF, gain)
    for got, want in zip((out.sdf, out.weight, out.color), ref):
        d = np.abs(np.asarray(got)[s] - want)
        # Voxels whose projection rounds to another pixel in f32: rare.
        assert np.mean(d > 1e-4) < 1e-3
        assert np.max(d[d <= 1e-4], initial=0.0) < 2e-5
    # Rows outside the list are untouched.
    rest = np.setdiff1d(np.arange(c), s)
    np.testing.assert_array_equal(np.asarray(out.sdf)[rest],
                                  np.asarray(bm.sdf)[rest])


# --- label vote -----------------------------------------------------------


def test_vote_update_matches_reference():
    n = 4096
    lab = RNG.integers(-1, 5, n).astype(np.int32)
    cnt = RNG.integers(0, 4, n).astype(np.float32)
    gid = RNG.integers(0, 5, n).astype(np.int32)
    obs = RNG.uniform(size=n) > 0.3
    got_l, got_c = labels.vote_update(jnp.asarray(lab), jnp.asarray(cnt),
                                      jnp.asarray(gid), jnp.asarray(obs))
    want_l, want_c = lab.copy(), cnt.copy()
    for i in range(n):  # Boyer-Moore, one voxel at a time
        if not obs[i]:
            continue
        if cnt[i] <= 0:
            want_l[i], want_c[i] = gid[i], 1.0
        elif lab[i] == gid[i]:
            want_c[i] += 1.0
        else:
            want_c[i] -= 1.0
    np.testing.assert_array_equal(np.asarray(got_l), want_l)
    np.testing.assert_array_equal(np.asarray(got_c), want_c)


# --- level-0 preprocessing --------------------------------------------------


def _pyramid0_ref(depth, intr, cfg):
    d = np.where((depth >= cfg.depth_min) & (depth <= cfg.depth_max), depth, 0.0)
    h, w = d.shape
    r = cfg.bilateral_radius
    pad = np.pad(d, r)
    acc = np.zeros_like(d)
    wacc = np.zeros_like(d)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            s = pad[r - dy:r - dy + h, r - dx:r - dx + w]
            wt = np.exp(-(dy * dy + dx * dx) / (2 * cfg.bilateral_sigma_space ** 2)
                        - (s - d) ** 2 / (2 * cfg.bilateral_sigma_depth ** 2))
            wt = np.where((s > 0) & (d > 0), wt, 0.0)
            acc += wt * s
            wacc += wt
    df = np.where((d > 0) & (wacc > 1e-8), acc / np.maximum(wacc, 1e-8), 0.0)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    vm = np.stack([(uu - intr.cx) / intr.fx * df, (vv - intr.cy) / intr.fy * df, df], -1)
    vp = np.pad(vm, ((1, 1), (1, 1), (0, 0)))
    nrm = np.cross(vp[1:-1, 2:] - vp[1:-1, :-2], vp[2:, 1:-1] - vp[:-2, 1:-1])
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-12)
    nrm = np.where(nrm[..., 2:] > 0, -nrm, nrm)
    z = np.pad(vm[..., 2] > 0, 1)
    ok = (z[1:-1, 1:-1] & z[1:-1, 2:] & z[1:-1, :-2] & z[2:, 1:-1] & z[:-2, 1:-1]
          & (ln[..., 0] > 1e-12))
    ok[0, :] = ok[-1, :] = False
    ok[:, 0] = ok[:, -1] = False
    return df, vm, nrm, ok


def test_pyramid_level0_matches_float64():
    f = synthetic.render_frame(synthetic.orbit_trajectory(3)[1], SMALL_INTR)
    depth = np.asarray(f.depth, np.float64)
    depth += RNG.normal(size=depth.shape) * 0.003 * (depth > 0)
    cfg = PreprocessConfig()
    got = preprocess.build_frame_pyramid(
        jnp.asarray(depth, jnp.float32), SMALL_INTR, cfg, 3)[0]
    df, vm, nm, ok = _pyramid0_ref(depth, SMALL_INTR, cfg)
    gv = np.asarray(got["valid"])
    assert ok.sum() > 5000
    assert np.mean(gv != ok) < 1e-3
    both = gv & ok
    np.testing.assert_allclose(np.asarray(got["depth"]), df, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got["vmap"])[both], vm[both], atol=2e-5)
    np.testing.assert_allclose(np.asarray(got["nmap"])[both], nm[both], atol=2e-3)
