"""FULL pipeline on the sustained-drift rig (VERDICT r4 Weak #2 / ask #5).

`_check_ate512.py` showed the bare engine accumulating 50-100 mm
map-feedback drift at ~3x fr1-mean rotation held continuously
(SWEEP=1.6 SHAKE=0.02) with no health-gate trip.  This script runs the
SAME rig through the full pipeline — keyframes, fern loop closure,
landmark Schur BA, relocalization, and the map-consistency sentinel
(EngineConfig.consistency_check) whose persistent alarm forces
out-of-cadence keyframe/loop-closure attempts — and reports whether
closure arrests the drift.

A rejected policy, hard fern relocalization on a persistent alarm, re-
seats against a low-overlap retrieved keyframe mid-sweep and does worse
than the drift it fights; the pipeline forces loop-closure keyframes
instead.

Needs a GPU; PLATFORM=cpu runs on the CPU instead.  Env: N (frames,
default 120), SWEEP (1.6), SHAKE (0.02), GRID (512), KF_EVERY (8),
SENTINEL (1).  Prints per-phase stats + final ATE.
"""
import json
import os

import numpy as np

import jax

from instancefusion_tpu.utils.runtime import setup

setup(os.environ.get("PLATFORM"))

from instancefusion_tpu.config import (  # noqa: E402
    EngineConfig, IcpConfig, PoseGraphConfig, RaycastConfig, TsdfConfig,
)
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.engine import pipeline
from instancefusion_tpu.geometry.camera import TUM_FR1
from instancefusion_tpu.utils.ate import ate_rmse
from instancefusion_tpu.utils.metrics import MetricsWriter

grid = int(os.environ.get("GRID", "512"))
n = int(os.environ.get("N", "120"))
extent = grid * 0.0075
cfg = EngineConfig(
    intrinsics=TUM_FR1,
    tsdf=TsdfConfig(
        voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
        grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
        block_size=8, table_capacity=65536, touched_capacity=2048,
    ),
    icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0,
                  assoc_every=(2, 2, 4), vel_seed=0.8),
    raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                          screen_space_normals=True,
                          predict_color=False),
    posegraph=PoseGraphConfig(
        keyframe_every=int(os.environ.get("KF_EVERY", "8")),
        loop_dist_thresh=float(os.environ.get("LOOP_THRESH", "0.12")),
    ),
    map_kind="blocks", use_color=True,
    consistency_check=os.environ.get("SENTINEL", "1") == "1",
    consistency_thresh=float(os.environ.get("SENT_THRESH", "0.0012")),
)

poses = synthetic.handheld_trajectory(
    n,
    sweep=float(os.environ.get("SWEEP", "1.6")),
    shake_rot=float(os.environ.get("SHAKE", "0.02")),
    shake_trans=0.008,
)
keys = jax.random.split(jax.random.PRNGKey(0), n)
frames = [
    synthetic.add_sensor_noise(
        synthetic.render_frame(poses[i], cfg.intrinsics), keys[i]
    )
    for i in range(n)
]

mpath = "/tmp/_drift_pipeline_metrics.jsonl"
metrics = MetricsWriter(mpath, echo=False)
res = pipeline.run(
    cfg, frames, T_init_wc=np.asarray(poses[0]), metrics=metrics,
    enable_loops=True, relocalize_after=5,
)
metrics.close()

rows = [json.loads(l) for l in open(mpath)]
alarms = [r.get("drift_alarm", False) for r in rows]
ewmas = [r.get("drift_ewma_mm", 0.0) for r in rows]
relocs = sum(1 for r in rows if r.get("relocalized"))
per_frame = np.linalg.norm(
    res.poses[:, :3, 3] - np.asarray(poses)[: len(res.poses), :3, 3], axis=-1
)
print(
    f"frames {len(res.poses)}  keyframes {res.n_keyframes}  "
    f"loops {res.n_loops}  relocalizations {relocs}"
)
if any(e > 0 for e in ewmas):
    first = alarms.index(True) if any(alarms) else -1
    print(
        f"sentinel: ewma max {max(ewmas):.3f} mm  alarm_frames "
        f"{sum(alarms)}/{len(alarms)}  first_alarm {first}"
    )
print(
    f"trans err: mean {per_frame.mean()*1000:.1f} mm  "
    f"max {per_frame.max()*1000:.1f} mm  final {per_frame[-1]*1000:.1f} mm"
)
print(f"ate_rmse {ate_rmse(res.poses, np.asarray(poses)[:len(res.poses)])*1000:.1f} mm")
