"""Pose accuracy of the 512^3 bench configuration (synthetic orbit).

Needs a GPU; PLATFORM=cpu runs on the CPU instead.
"""
import os
import numpy as np

from instancefusion_tpu.utils.runtime import setup

setup(os.environ.get("PLATFORM"))

from instancefusion_tpu.config import (  # noqa: E402
    EngineConfig, IcpConfig, RaycastConfig, TsdfConfig,
)
from instancefusion_tpu.datasets import synthetic  # noqa: E402
from instancefusion_tpu.engine import slam  # noqa: E402
from instancefusion_tpu.geometry.camera import TUM_FR1  # noqa: E402

grid = 512
extent = grid * 0.0075
cfg = EngineConfig(
    intrinsics=TUM_FR1,
    tsdf=TsdfConfig(
        voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
        grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
        block_size=8, table_capacity=65536, touched_capacity=2048,
    ),
    icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0,
                  assoc_every=(2, 2, 4)),
    raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                          screen_space_normals=True,
                          predict_color=False),
    map_kind="blocks", use_color=True,
)

n = int(os.environ.get("N", "40"))
# NOISY=1: Kinect noise model + fr1-calibrated handheld motion (r3
# VERDICT item 4); default stays the clean orbit for parity with
# earlier rounds' numbers.
#
# Calibration note: the rig below matches TUM
# fr1_desk's MEAN velocities (23 deg/s, 0.41 m/s -> ~0.8 deg / ~13 mm
# per 30 Hz frame) with ~2x peaks — errors stay <10 mm through the
# noise.  SWEEP/SHAKE env knobs raise it; at ~3x fr1-mean rotation
# SUSTAINED for the whole run (sweep 1.6 + shake 0.02, i.e. fr1's
# worst seconds held continuously) frame-to-model tracking at VGA
# accumulates 50-100 mm map-feedback drift with no tracking-health
# trip — a known open robustness limit (frames fuse slightly
# misaligned, the map drags the next solve); knob bisects
# (assoc_every=1, vel_seed=0, more iters) do not rescue it.
noisy = os.environ.get("NOISY", "0") == "1"
if noisy:
    import dataclasses

    import jax

    ae = int(os.environ.get("ASSOC", "0"))
    assoc = (ae, ae, ae) if ae else (2, 2, 4)
    vel = float(os.environ.get("VEL", "0.8"))
    # RGB=w enables the photometric term at weight w; TEXTURE=1 renders
    # the world-anchored procedural texture so it has signal to use
    # (VERDICT r4 Weak #3: measure the term on the noisy textured rig).
    rgb_w = float(os.environ.get("RGB", "0.0"))
    cfg = dataclasses.replace(
        cfg,
        icp=IcpConfig(iters=(10, 5, 4), rgb_weight=rgb_w,
                      assoc_every=assoc, vel_seed=vel),
    )
    textured = os.environ.get("TEXTURE", "0") == "1"
    poses = synthetic.handheld_trajectory(
        n,
        sweep=float(os.environ.get("SWEEP", "0.8")),
        shake_rot=float(os.environ.get("SHAKE", "0.012")),
        shake_trans=0.008,
    )
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    frames = [
        synthetic.add_sensor_noise(
            synthetic.render_frame(poses[i], cfg.intrinsics, texture=textured),
            keys[i],
        )
        for i in range(n)
    ]
else:
    poses = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n)]
# CONSISTENCY=1: run the map-consistency sentinel (frame-to-frame vs
# frame-to-model disagreement EWMA — the drift alarm the health gate
# lacks; see EngineConfig.consistency_check) and report whether it fires.
if os.environ.get("CONSISTENCY", "0") == "1":
    import dataclasses as _dc

    cfg = _dc.replace(cfg, consistency_check=True)

state = slam.init_state(cfg, poses[0])
errs, ewmas, alarms = [], [], []
for i in range(n):
    state, info = slam.step_donated(cfg, state, frames[i].depth, frames[i].color)
    T = np.asarray(state.T_wc)
    errs.append(float(np.linalg.norm(T[:3, 3] - np.asarray(poses[i])[:3, 3])))
    if info.drift_alarm is not None:
        ewmas.append(float(info.drift_ewma) * 1000)
        alarms.append(bool(info.drift_alarm))
errs = np.array(errs)
print(f"noisy={noisy} trans err: mean {errs.mean()*1000:.2f} mm  max {errs.max()*1000:.2f} mm"
      f"  n_active {int(state.volume.n_active)} overflow {int(state.volume.overflow)}")
if ewmas:
    first_alarm = alarms.index(True) if any(alarms) else -1
    print(f"sentinel: ewma mean {np.mean(ewmas):.3f} mm  max {np.max(ewmas):.3f} mm"
          f"  alarm_frames {sum(alarms)}/{len(alarms)}  first_alarm {first_alarm}")
if os.environ.get("NO_ATE_GATE", "0") != "1":
    assert errs.max() < (0.03 if noisy else 0.02), "tracking drifted"
print("OK")
