"""Calibration layer tests: baking, IO round-trip, frustums, inversion."""

import numpy as np
import jax.numpy as jnp

from rgbd_recon.calib.bake import bake_cv_xyz, bake_cv_uv, bake_cv_xyz_inv_analytic
from rgbd_recon.calib.frustum import frustum_from_cv_xyz
from rgbd_recon.calib.inverter import (
    invert_calibration_knn,
    invert_calibration_bruteforce_jax,
)
from rgbd_recon.calib.volume_io import (
    read_calibration_volume,
    write_calibration_volume,
)
from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.ops.sampling import trilinear_3d
from rgbd_recon.sensors.synthetic import default_test_rig

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def _rig():
    return default_test_rig(num_sensors=2, bbox=BBOX)


def test_volume_io_roundtrip(tmp_path, rng):
    vol = rng.standard_normal((4, 5, 6, 3)).astype(np.float32)
    path = tmp_path / "test.cv_xyz"
    write_calibration_volume(path, vol, (0.5, 4.5))
    got, limits = read_calibration_volume(path)
    np.testing.assert_array_equal(got, vol)
    assert limits == (0.5, 4.5)


def test_volume_io_reference_header_layout(tmp_path):
    """Byte-level header check vs calibration_volume.hpp:30-39."""
    vol = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    path = tmp_path / "t.cv_uv"
    write_calibration_volume(path, vol, (0.25, 3.0))
    raw = path.read_bytes()
    rx, ry, rz = np.frombuffer(raw[:12], np.uint32)
    assert (rx, ry, rz) == (4, 3, 2)
    near, far = np.frombuffer(raw[12:20], np.float32)
    assert near == 0.25 and far == 3.0
    # payload flat order: z-major, x fastest
    payload = np.frombuffer(raw[20:], np.float32)
    np.testing.assert_array_equal(payload, vol.ravel())


def test_bake_cv_xyz_unproject_consistency():
    """cv_xyz sampled trilinearly at (u,v,d) must reproduce the analytic
    unprojection (this is the invariant every runtime kernel relies on)."""
    rig = _rig()
    sensor = rig.sensors[0]
    cv = bake_cv_xyz(sensor, res=(48, 48, 48))
    pts = np.random.default_rng(0).uniform(0.15, 0.85, (40, 3)).astype(np.float32)
    sampled = np.asarray(trilinear_3d(jnp.asarray(cv), jnp.asarray(pts)))
    depth_m = sensor.depth.denormalize_depth(pts[..., 2])
    exact = sensor.depth.unproject(pts[..., :2], depth_m)
    err = np.linalg.norm(sampled - exact, axis=-1)
    assert err.max() < 5e-3  # sub-voxel interpolation error


def test_analytic_inverse_roundtrip():
    """world -> (u,v,d) -> world via cv_xyz must be identity within interp
    tolerance (valid voxels only)."""
    rig = _rig()
    sensor = rig.sensors[0]
    cv_xyz = bake_cv_xyz(sensor, res=(64, 64, 64))
    inv = bake_cv_xyz_inv_analytic(sensor, BBOX, res=(24, 26, 24))
    rz, ry, rx, _ = inv.shape
    valid = inv[..., 3] > 0
    uvd = inv[valid][:, :3]
    world_back = np.asarray(
        trilinear_3d(jnp.asarray(cv_xyz), jnp.asarray(uvd))
    )
    # expected world = voxel centers of valid cells
    xs = (np.arange(rx) + 0.5) / rx
    ys = (np.arange(ry) + 0.5) / ry
    zs = (np.arange(rz) + 0.5) / rz
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    centers = BBOX.denormalize(np.stack([xx, yy, zz], axis=-1).astype(np.float32))
    want = centers[valid]
    err = np.linalg.norm(world_back - want, axis=-1)
    assert np.median(err) < 0.02
    assert err.max() < 0.08


def test_frustum_camera_position():
    rig = _rig()
    sensor = rig.sensors[0]
    cv_xyz = bake_cv_xyz(sensor, res=(32, 32, 32))
    fr = frustum_from_cv_xyz(cv_xyz)
    pos = fr.camera_position()
    np.testing.assert_allclose(pos, sensor.depth.position, atol=2e-2)


def test_frustum_inside():
    rig = _rig()
    sensor = rig.sensors[0]
    cv_xyz = bake_cv_xyz(sensor, res=(32, 32, 32))
    fr = frustum_from_cv_xyz(cv_xyz)
    # center of the view at mid depth is inside
    mid = sensor.depth.unproject(np.array([0.5, 0.5], np.float32), np.array(2.0))
    assert fr.inside(mid[None])[0]
    # far behind the camera is outside
    behind = sensor.depth.position - (mid - sensor.depth.position)
    assert not fr.inside(behind[None])[0]


def test_knn_inversion_matches_analytic():
    """The kNN+IDW parity path must agree with the analytic inverse inside
    the frustum (reference algorithm: calibration_inverter.cpp:99-155)."""
    rig = _rig()
    sensor = rig.sensors[0]
    cv_xyz = bake_cv_xyz(sensor, res=(40, 48, 40))
    res = (16, 18, 16)
    inv_knn = invert_calibration_knn(cv_xyz, BBOX, res, k=8)
    inv_ana = bake_cv_xyz_inv_analytic(sensor, BBOX, res)
    both_valid = (inv_knn[..., 3] > 0) & (inv_ana[..., 3] > 0)
    assert both_valid.sum() > 50
    diff = np.abs(inv_knn[..., :3] - inv_ana[..., :3])[both_valid]
    # kNN+IDW over a 40^3-ish grid is approximate: ~1 texel accuracy
    assert np.median(diff) < 0.03
    assert diff.max() < 0.2


def test_bruteforce_jax_inversion_matches_knn():
    rig = _rig()
    sensor = rig.sensors[0]
    cv_xyz = bake_cv_xyz(sensor, res=(12, 14, 12))
    res = (6, 6, 6)
    a = invert_calibration_knn(cv_xyz, BBOX, res, k=8)
    b = invert_calibration_bruteforce_jax(cv_xyz, BBOX, res, k=8)
    np.testing.assert_array_equal(a[..., 3] > 0, b[..., 3] > 0)
    valid = a[..., 3] > 0
    if valid.any():
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-3, atol=1e-4)


def test_build_synthetic_calibration_shapes():
    rig = default_test_rig(num_sensors=3, bbox=BBOX)
    cs = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16), inv_res=(20, 22, 20))
    assert cs.num_sensors == 3
    assert cs.cv_xyz.shape == (3, 16, 24, 16, 3)
    assert cs.cv_uv.shape == (3, 16, 24, 16, 2)
    assert cs.cv_xyz_inv.shape == (3, 20, 22, 20, 4)
    assert cs.camera_positions.shape == (3, 3)
    for i, sensor in enumerate(rig.sensors):
        np.testing.assert_allclose(
            np.asarray(cs.camera_positions[i]), sensor.depth.position, atol=3e-2
        )


# ---------------------------------------------------------------------------
# scattered-data interpolation (the NaturalNeighbourInterpolator role)
# ---------------------------------------------------------------------------

def test_idw_interpolate_exact_at_samples():
    from rgbd_recon.calib import idw_interpolate

    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (60, 3))
    val = rng.uniform(-1, 1, (60, 2))
    out = idw_interpolate(pos, val, pos, k=4)
    np.testing.assert_allclose(out, val, atol=1e-4)


def test_mls_reproduces_linear_field():
    """Linear precision: the property Sibson natural-neighbour interpolation
    guarantees and IDW does not."""
    from rgbd_recon.calib import mls_interpolate

    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 1, (200, 3))
    A = np.array([[1.0, -2.0, 0.5], [0.0, 3.0, 1.0]])
    val = pos @ A.T + np.array([0.3, -0.1])
    q = rng.uniform(0.2, 0.8, (50, 3))
    out = mls_interpolate(pos, val, q, k=16)
    expected = q @ A.T + np.array([0.3, -0.1])
    np.testing.assert_allclose(out, expected, atol=1e-3)


def test_build_lookup_volume_shape_and_values():
    from rgbd_recon.calib import build_lookup_volume

    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 1, (300, 3))
    val = pos[:, :1] * 2.0  # linear field
    vol = build_lookup_volume(
        pos, val, res=(8, 6, 4), space_min=np.zeros(3), space_max=np.ones(3)
    )
    assert vol.shape == (4, 6, 8, 1)
    # texel at x-center ~0.5+ should carry ~2*x
    assert abs(vol[2, 3, 4, 0] - 2.0 * (4.5 / 8)) < 0.1


def test_sidecar_ext2_ext3_local(tmp_path):
    """.ext2/.ext3 secondary poses and .local transform sidecars parse like
    the reference (KinectCalibrationFile.cpp:416-520, 779-795)."""
    from rgbd_recon.calib.kinect_yml import parse_kinect_yml

    yml = tmp_path / "k.yml"
    yml.write_text(
        "rgb_intrinsics: 500 0 320 0 500 240 0 0 1\n"
        "depth_intrinsics: 400 0 256 0 400 212 0 0 1\n"
        "near_far: 0.5 4.5\n"
    )
    (tmp_path / "k.ext2").write_text(
        "1 2 3  1 0 0 0 1 0 0 0 1")
    (tmp_path / "k.ext3").write_text(
        "4 5 6  0 1 0 1 0 0 0 0 1")
    (tmp_path / "k.local").write_text("0.1 0.2 0.3 10 20 30")
    cal = parse_kinect_yml(yml)
    np.testing.assert_allclose(cal.world_translation2, [1, 2, 3])
    np.testing.assert_allclose(cal.world_rotation2, np.eye(3))
    np.testing.assert_allclose(cal.world_translation3, [4, 5, 6])
    np.testing.assert_allclose(cal.local_translation, [0.1, 0.2, 0.3])
    np.testing.assert_allclose(cal.local_rotation_deg, [10, 20, 30])


def test_distortion_applied_at_bake():
    """Brown-Conrady distortion enters through project/unproject and hence
    the baked volumes (round-2 verdict #6): project o unproject is identity
    to sub-pixel, and a distorted bake differs from the undistorted one."""
    from rgbd_recon.calib.bake import bake_cv_xyz
    from rgbd_recon.core.camera import PinholeCamera, RGBDSensor

    base = dict(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0,
                t_cw=(0.0, 1.0, 2.0), near=0.5, far=4.5)
    cam0 = PinholeCamera(**base)
    cam1 = PinholeCamera(**base, distortion=(-0.2, 0.05, 0.001, -0.002, 0.0))

    rng = np.random.default_rng(3)
    uv = rng.uniform(0.15, 0.85, (500, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, (500,)).astype(np.float32)
    for cam in (cam0, cam1):
        world = cam.unproject(uv, depth)
        uv2, z2 = cam.project(world)
        np.testing.assert_allclose(uv2, uv, atol=2e-4)
        np.testing.assert_allclose(z2, depth, rtol=1e-5)

    v0 = np.asarray(bake_cv_xyz(RGBDSensor(depth=cam0, color=cam0), (16, 16, 8)))
    v1 = np.asarray(bake_cv_xyz(RGBDSensor(depth=cam1, color=cam1), (16, 16, 8)))
    assert np.abs(v0 - v1).max() > 0.01  # distortion visibly shifts rays
