"""Pose-BA sharp-recovery validation at reference scale on the GPU.

Injects a known rotation+translation error into one sensor of a 4-sensor
512x424 rig at 1 cm voxels, runs the leave-one-out Gauss-Newton refinement,
and reports parameter-space recovery — the resolution regime where the
objective is identifiable (the CPU unit test runs the same check at a
coarse scale where only the residual floor is observable)."""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from rgbd_recon.core.cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.camera import RGBDSensor, SensorRig
from rgbd_recon.core.config import PipelineConfig
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.recon import TsdfPipeline
from rgbd_recon.refine import (
    leave_one_out_volumes, pose_residual_stats, refine_poses,
)
from rgbd_recon.refine.pose_ba import _rodrigues, apply_pose_corrections
from rgbd_recon.sensors.synthetic import (
    SyntheticScene, default_test_rig, render_rig_frames,
)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
rig = default_test_rig(num_sensors=4, depth_size=(512, 424),
                       color_size=(640, 540), bbox=BBOX)

import os
DRIFT_DEG = float(os.environ.get("BA_DRIFT_DEG", "1.0"))
DRIFT_T = [float(v) for v in os.environ.get("BA_DRIFT_T", "0.018,0,0.008").split(",")]
th = np.radians(DRIFT_DEG)
E_rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
E_t = np.array(DRIFT_T, np.float32)
s1 = rig.sensors[1]
bad_depth = dataclasses.replace(
    s1.depth,
    r_cw=tuple(map(tuple, (E_rot @ np.asarray(s1.depth.R)).tolist())),
    t_cw=tuple((E_rot @ np.asarray(s1.depth.t_cw) + E_t).tolist()),
)
bad_rig = SensorRig(sensors=(
    rig.sensors[0],
    RGBDSensor(depth=bad_depth, color=s1.color, serial=s1.serial),
    rig.sensors[2], rig.sensors[3],
))
scene = SyntheticScene(spheres=[((0.0, 1.25, 0.0), 0.45),
                                ((0.45, 0.55, 0.25), 0.28),
                                ((-0.5, 0.75, -0.2), 0.22)])
frames = render_rig_frames(scene, rig)
print("baking calibration...", flush=True)
calib = build_synthetic_calibration(bad_rig, BBOX, cv_res=(64, 128, 64),
                                    inv_res=(200, 220, 200))
cfg = PipelineConfig(voxel_size=0.01, brick_size=0.1, tsdf_limit=0.01)
pipe = TsdfPipeline(calib, cfg, BBOX)

# ground truth: the TRUE rig's forward volumes
calib_true = build_synthetic_calibration(rig, BBOX, cv_res=(64, 128, 64),
                                         inv_res=(8, 8, 8))


def calib_error_mm(calib_cur):
    """Mean lookup displacement |cv_xyz - cv_xyz_true| per sensor (mm),
    over mid-frustum depths."""
    a = np.asarray(calib_cur.cv_xyz[:, 16:112])
    b = np.asarray(calib_true.cv_xyz[:, 16:112])
    return np.linalg.norm(a - b, axis=-1).mean(axis=(1, 2, 3)) * 1000


volume, maps, counts = pipe.fuse(frames)
err0 = calib_error_mm(pipe.calib)
print("calib error before (mm/sensor):", np.round(err0, 1), flush=True)
ROUNDS = 4
print(f"refining ({ROUNDS} alternating rounds)...", flush=True)
err_rounds = []
# ONE call, ROUNDS alternating refine->apply->refuse rounds at the NOMINAL
# band with 24 LM iterations each. Measured design points: the rotation
# valley is shallow when the dominant object sits near the drift's
# rotation axis — 8 iterations stall in an equal-cost wrong-axis
# sidelobe, 24 reach truth; WIDE-band rounds were tried and rejected —
# at 4x band the solver can snap the drifted surface onto a wrong but
# band-consistent association that passes the in-band residual check
# while worsening the true pose. The apply gate pairs the noise-floor
# margin (with continuity for the sensor corrected last round) with a
# mandatory residual-improvement check, so runaway estimates degrade to
# no-correction instead of corrupting the rig.
poses, hist = pipe.refine_sensor_poses(maps, counts, iters=24, rounds=ROUNDS,
                                       frames=frames,
                                       band_schedule=(1.0,))
err_rounds.append(calib_error_mm(pipe.calib))
print(f"after rounds: calib error (mm/sensor) "
      f"{np.round(err_rounds[-1], 1)}", flush=True)
err = err_rounds[-1]
inj_mm = float(np.linalg.norm(E_t)) * 1000
print(f"injected: {inj_mm:.1f} mm / {DRIFT_DEG} deg on sensor 1; residual lookup error "
      f"{err[1]:.1f} mm (others {err[[0, 2, 3]].round(1)})")

lines = [
    "# Pose-BA validation at reference scale",
    "",
    "4 sensors, 512x424 depth, 1 cm voxels / 10 cm bricks, tsdf_limit",
    f"0.01. Sensor 1 injected with a COMBINED drift: {DRIFT_DEG} deg",
    f"rotation about y plus {[float(v) for v in np.round(np.array(DRIFT_T)*1000,1)]} mm "
    f"translation ({inj_mm:.1f} mm net). Recovery via",
    "leave-one-out consensus Gauss-Newton with soft observer-count",
    f"weighting (24 LM iterations per round; {ROUNDS} alternating",
    "refine->apply->refuse rounds at the nominal band;",
    "worst-sensor-only apply behind a noise-margin + continuity +",
    "mandatory residual-improvement gate).",
    "",
    "Mean calibration-lookup displacement vs ground truth (mm/sensor):",
    "",
    "| stage | s0 | s1 (drifted) | s2 | s3 |",
    "|---|---|---|---|---|",
    "| before | " + " | ".join(f"{v:.1f}" for v in err0) + " |",
]
for r, e in enumerate(err_rounds):
    lines.append(
        "| after rounds | " + " | ".join(f"{v:.1f}" for v in e) + " |"
    )
lines += [
    "",
    f"Sensor 1 recovered from {err0[1]:.1f} mm to {err[1]:.1f} mm mean",
    "lookup error; the undrifted sensors stay at their baseline (the",
    "gated worst-only apply never moves them). The apply gate's",
    "mandatory residual-improvement check rejects runaway estimates whose",
    "residual does not improve; it does not catch every band-consistent",
    "wrong correction. Round-5 changes that enabled this:",
    "soft per-voxel observer-count weighting of the leave-one-out",
    "residuals (contamination-aware consensus), the zero-correction",
    "prior projected onto near-null directions only (the isotropic",
    "prior halved weakly-witnessed rotations), and 24 LM iterations",
    "(8 stalled in an equal-cost wrong-axis sidelobe).",
    f"Run on {jax.devices()[0].device_kind} ({jax.devices()[0].platform}).",
]
with open("pose_ba_validation.md", "w") as f:
    f.write("\n".join(lines) + "\n")
print("wrote pose_ba_validation.md")
