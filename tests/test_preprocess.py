"""Preprocessing chain kernel tests against small NumPy oracles and
behavioral invariants from the reference shaders."""

import jax.numpy as jnp
import pytest
import numpy as np

from rgbd_recon.calib.bake import bake_cv_uv, bake_cv_xyz
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.ops.color import rgb_to_lab
from rgbd_recon.ops.preprocess import (
    bilateral_lab,
    boundary,
    morph_dilate,
    normals,
    quality,
)
from rgbd_recon.sensors.synthetic import default_test_rig

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def test_rgb_to_lab_reference_values():
    """Oracle: hand-computed through inc_color.glsl math (incl. /255 quirk)."""

    def oracle(rgb):
        def pivot_rgb(n):
            return (np.power((n + 0.055) / 1.055, 2.4) if n > 0.04045 else n / 12.92) * 100.0

        n = [pivot_rgb(c / 255.0) for c in rgb]
        x = n[0] * 0.4124 + n[1] * 0.3576 + n[2] * 0.1805
        y = n[0] * 0.2126 + n[1] * 0.7152 + n[2] * 0.0722
        z = n[0] * 0.0193 + n[1] * 0.1192 + n[2] * 0.9505
        wr = (95.047, 100.0, 108.883)

        def pivot_xyz(v):
            return v ** (1 / 3) if v > 0.008856 else (903.3 * v + 16) / 116

        px, py, pz = (pivot_xyz(x / wr[0]), pivot_xyz(y / wr[1]), pivot_xyz(z / wr[2]))
        return np.array([max(0.0, 116 * py - 16), 500 * (px - py), 200 * (py - pz)])

    for rgb in [(0.5, 0.2, 0.9), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (0.1, 0.8, 0.3)]:
        got = np.asarray(rgb_to_lab(jnp.asarray(rgb, jnp.float32)))
        np.testing.assert_allclose(got, oracle(rgb), rtol=1e-4, atol=1e-5)


def test_morph_dilate_fills_holes():
    """A single invalid pixel surrounded by valid depth gets the neighbor
    mean; valid pixels pass through unchanged (pre_morph.fs:73-112)."""
    d = np.full((8, 8), 2.0, np.float32)
    d[4, 4] = 0.0  # hole
    out = np.asarray(morph_dilate(jnp.asarray(d)))
    assert out[4, 4] == 2.0
    np.testing.assert_array_equal(out[d > 0], d[d > 0])


def test_morph_dilate_outlier_rejection():
    """Second pass rejects neighbors >0.2 m from the local average."""
    d = np.full((8, 8), 2.0, np.float32)
    d[4, 4] = 0.0
    d[4, 5] = 4.4  # valid but outlier vs 3x3 average
    out = np.asarray(morph_dilate(jnp.asarray(d)))
    # average of 8 neighbors = (7*2.0 + 4.4)/8 = 2.3; 2.0 within 0.2? |2.3-2.0|=0.3>0.2
    # -> only 4.4 is within 0.2 of 2.3? |2.3-4.4|=2.1>0.2 -> no valid sample -> 0
    assert out[4, 4] == 0.0


def test_morph_dilate_isolated_invalid_stays():
    d = np.zeros((6, 6), np.float32)
    out = np.asarray(morph_dilate(jnp.asarray(d)))
    np.testing.assert_array_equal(out, 0.0)


def _sensor_setup():
    rig = default_test_rig(num_sensors=1, bbox=BBOX)
    sensor = rig.sensors[0]
    cv_xyz = jnp.asarray(bake_cv_xyz(sensor, res=(24, 32, 24)))
    cv_uv = jnp.asarray(bake_cv_uv(sensor, res=(24, 32, 24)))
    return sensor, cv_xyz, cv_uv


def test_bilateral_nofilter_passthrough():
    """filter_textures=false path: (normalized depth, 1) with bbox cull
    (pre_depth.fs:148-150)."""
    sensor, cv_xyz, cv_uv = _sensor_setup()
    H, W = sensor.depth.height, sensor.depth.width
    d = np.full((H, W), 1.9, np.float32)  # inside the box for center pixels
    color = np.full((sensor.color.height, sensor.color.width, 3), 0.5, np.float32)
    depth2, lab = bilateral_lab(
        jnp.asarray(d), jnp.asarray(color), cv_xyz, cv_uv,
        jnp.asarray(BBOX.min), jnp.asarray(BBOX.max),
        jnp.asarray([0.5, 4.5], jnp.float32), filter_on=False,
    )
    depth2 = np.asarray(depth2)
    dnorm = (1.9 - 0.5) / 4.0
    center = depth2[H // 2, W // 2]
    np.testing.assert_allclose(center, [dnorm, 1.0], rtol=1e-5)
    assert lab.shape == (H, W, 3)


def test_bilateral_flat_region_identity():
    """On constant depth the bilateral filter returns the same depth with
    full confidence (all weights valid)."""
    sensor, cv_xyz, cv_uv = _sensor_setup()
    H, W = sensor.depth.height, sensor.depth.width
    d = np.full((H, W), 1.9, np.float32)
    color = np.full((sensor.color.height, sensor.color.width, 3), 0.5, np.float32)
    depth2, _ = bilateral_lab(
        jnp.asarray(d), jnp.asarray(color), cv_xyz, cv_uv,
        jnp.asarray(BBOX.min), jnp.asarray(BBOX.max),
        jnp.asarray([0.5, 4.5], jnp.float32), filter_on=True,
    )
    depth2 = np.asarray(depth2)
    center = depth2[H // 2, W // 2]
    np.testing.assert_allclose(center[0], (1.9 - 0.5) / 4.0, atol=1e-5)
    np.testing.assert_allclose(center[1], 1.0, atol=1e-5)  # w_range/num = 1


def test_bilateral_edge_preserving():
    """A depth step must not blur across (range-term rejects the far side)."""
    sensor, cv_xyz, cv_uv = _sensor_setup()
    H, W = sensor.depth.height, sensor.depth.width
    d = np.full((H, W), 1.6, np.float32)
    d[:, W // 2:] = 2.4  # step >> 0.35*d/4.5 threshold
    color = np.full((sensor.color.height, sensor.color.width, 3), 0.5, np.float32)
    depth2, _ = bilateral_lab(
        jnp.asarray(d), jnp.asarray(color), cv_xyz, cv_uv,
        jnp.asarray(BBOX.min), jnp.asarray(BBOX.max),
        jnp.asarray([0.5, 4.5], jnp.float32), filter_on=True,
    )
    depth2 = np.asarray(depth2)
    # probe two pixels adjacent to the step, away from image border
    left = depth2[H // 2, W // 2 - 1, 0] * 4.0 + 0.5
    right = depth2[H // 2, W // 2 + 1, 0] * 4.0 + 0.5
    np.testing.assert_allclose(left, 1.6, atol=1e-3)
    np.testing.assert_allclose(right, 2.4, atol=1e-3)


def test_boundary_invalidates_unreliable():
    """Pixels with low bilateral confidence and inconsistent color get
    depth=-1/flag 0.1 and silhouette 0 (pre_boundary.fs:102-113)."""
    H, W = 12, 12
    depth2 = np.zeros((H, W, 2), np.float32)
    depth2[..., 0] = 0.4
    depth2[..., 1] = 0.9  # reliable
    depth2[5, 5, 1] = 0.3  # unreliable
    lab = np.zeros((H, W, 3), np.float32)
    lab[5, 5] = 100.0  # color-inconsistent
    out, sil = boundary(jnp.asarray(depth2), jnp.asarray(lab), refine=True)
    out, sil = np.asarray(out), np.asarray(sil)
    assert out[5, 5, 0] == -1.0
    np.testing.assert_allclose(out[5, 5, 1], 0.1)
    assert sil[5, 5] == 0.0
    assert sil[3, 3] == 1.0
    assert out[3, 3, 1] == 0.0


def test_boundary_refine_keeps_consistent():
    """Color-consistent unreliable pixels survive with flag 1.0."""
    H, W = 12, 12
    depth2 = np.zeros((H, W, 2), np.float32)
    depth2[..., 0] = 0.4
    depth2[..., 1] = 0.9
    depth2[5, 5, 1] = 0.3
    lab = np.zeros((H, W, 3), np.float32)  # perfectly consistent colors
    out, sil = boundary(jnp.asarray(depth2), jnp.asarray(lab), refine=True)
    out = np.asarray(out)
    assert out[5, 5, 0] == 0.4
    np.testing.assert_allclose(out[5, 5, 1], 1.0)
    # without refine it is invalidated
    out2, _ = boundary(jnp.asarray(depth2), jnp.asarray(lab), refine=False)
    assert np.asarray(out2)[5, 5, 0] == -1.0


def test_boundary_outside_bbox():
    depth2 = np.zeros((8, 8, 2), np.float32)
    out, sil = boundary(jnp.asarray(depth2), jnp.asarray(np.zeros((8, 8, 3), np.float32)))
    assert np.all(np.asarray(sil) == 0.0)
    assert np.all(np.asarray(out)[..., 1] == 0.0)


def test_normals_flat_wall_points_at_camera():
    """A fronto-parallel wall's normals point back toward the sensor."""
    sensor, cv_xyz, _ = _sensor_setup()
    H, W = sensor.depth.height, sensor.depth.width
    dnorm = (1.9 - 0.5) / 4.0
    depth2 = np.zeros((H, W, 2), np.float32)
    depth2[..., 0] = dnorm
    n = np.asarray(normals(jnp.asarray(depth2), cv_xyz))
    center = n[H // 2, W // 2]
    cam_pos = sensor.depth.position
    world_center = sensor.depth.unproject(
        np.array([0.5, 0.5], np.float32), np.array(1.9, np.float32)
    )
    to_cam = cam_pos - world_center
    to_cam = to_cam / np.linalg.norm(to_cam)
    assert np.dot(center, to_cam) > 0.99


def test_quality_flat_wall_positive_and_depth_scaled():
    sensor, cv_xyz, _ = _sensor_setup()
    H, W = sensor.depth.height, sensor.depth.width
    depth2 = np.zeros((H, W, 2), np.float32)
    depth2[..., 0] = (1.9 - 0.5) / 4.0
    n = normals(jnp.asarray(depth2), cv_xyz)
    q = np.asarray(
        quality(jnp.asarray(depth2), n, cv_xyz, jnp.asarray(sensor.depth.position))
    )
    center = q[H // 2, W // 2]
    assert center > 0.0
    # reference formula at interior of flat wall: lateral=1, w_range/num=1
    # -> q = 1 / (d*6.5) * angle^2
    d = (1.9 - 0.5) / 4.0
    world_center = sensor.depth.unproject(
        np.array([0.5, 0.5], np.float32), np.array(1.9, np.float32)
    )
    to_cam = sensor.depth.position - world_center
    to_cam /= np.linalg.norm(to_cam)
    nrm = np.asarray(n)[H // 2, W // 2]
    expect = 1.0 / (d * 6.5) * np.dot(to_cam, nrm) ** 2
    np.testing.assert_allclose(center, expect, rtol=0.05)
    # invalid pixels have zero quality
    assert q[0, 0] == 0.0 or depth2[0, 0, 0] > 0


def test_pixel_ray_model_matches_volume_lookups():
    """PixelModels closed forms must reproduce the cv_xyz/cv_uv trilinear
    lookups (exactly, for the pinhole synthetic rig) through the whole
    preprocess chain."""
    import jax

    from rgbd_recon.calib.sensors import (
        build_synthetic_calibration,
        derive_pixel_models,
    )
    from rgbd_recon.core.grid import BoundingBox
    from rgbd_recon.ops.preprocess import preprocess_frames
    from rgbd_recon.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(24, 28, 24))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )

    models, residual = derive_pixel_models(calib.cv_xyz, calib.cv_uv, (40, 48))
    assert residual < 2e-3, residual

    kw = dict(
        cv_xyz=calib.cv_xyz, cv_uv=calib.cv_uv, bbox_min=calib.bbox_min,
        bbox_max=calib.bbox_max, depth_limits=calib.depth_limits,
        camera_positions=calib.camera_positions,
    )
    m_vol = jax.jit(
        lambda d, c: preprocess_frames(d, c, **kw)
    )(frames.depths, frames.colors)
    m_fit = jax.jit(
        lambda d, c: preprocess_frames(d, c, **kw, pixel_models=models)
    )(frames.depths, frames.colors)

    np.testing.assert_allclose(
        np.asarray(m_fit.depth), np.asarray(m_vol.depth), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(m_fit.silhouette), np.asarray(m_vol.silhouette), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(m_fit.lab), np.asarray(m_vol.lab), atol=5e-2
    )
    # normals: compare only where both valid (unit vectors)
    nv, nf = np.asarray(m_vol.normal), np.asarray(m_fit.normal)
    both = (np.linalg.norm(nv, axis=-1) > 0.5) & (np.linalg.norm(nf, axis=-1) > 0.5)
    dots = (nv[both] * nf[both]).sum(-1)
    assert np.quantile(dots, 0.05) > 0.99
    np.testing.assert_allclose(
        np.asarray(m_fit.quality), np.asarray(m_vol.quality), atol=1e-3
    )


def test_pallas_stencils_parity_interpret():
    """The Triton-route Pallas bilateral/quality kernels
    (ops/stencil_triton.py), run in the Pallas interpreter on the CPU, must
    reproduce the jnp folds tap-for-tap on a preprocessed 2-sensor frame."""
    import jax

    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.ops import stencil_triton
    from rgbd_recon.ops.preprocess import (
        bilateral_sums,
        preprocess_frames,
        quality_sums,
    )
    from rgbd_recon.sensors import SyntheticScene, render_rig_frames

    bbox = BBOX
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(24, 28, 24))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    maps = preprocess_frames(
        frames.depths, frames.colors, calib.cv_xyz, calib.cv_uv,
        calib.bbox_min, calib.bbox_max, calib.depth_limits,
        calib.camera_positions,
    )
    lim = calib.depth_limits
    d_m, d_n = maps.raw_depth, maps.depth[..., 0]
    got_b = stencil_triton.bilateral13(d_m, lim, interpret=True)
    want_b = jax.vmap(bilateral_sums)(d_m, lim[:, 0], lim[:, 1])
    got_q = stencil_triton.quality13(d_n, interpret=True)
    want_q = jax.vmap(quality_sums)(d_n)
    for g, w in zip(got_b + got_q, want_b + want_q):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_window_sums_pick_kernel_by_lowering_platform(platform):
    """preprocess_frames lowers the 13x13 window sums to the Triton kernels
    for CUDA and to the jnp fold elsewhere — decided at lowering, so a CPU
    program never contains a Triton call (and never runs it interpreted)."""
    import jax

    from rgbd_recon.ops.preprocess import preprocess_frames

    N, H, W = 2, 40, 48
    f32 = jax.numpy.float32
    args = (
        jax.ShapeDtypeStruct((N, H, W), f32),
        jax.ShapeDtypeStruct((N, 48, 64, 3), f32),
        jax.ShapeDtypeStruct((N, 8, 12, 8, 3), f32),
        jax.ShapeDtypeStruct((N, 8, 12, 8, 2), f32),
        jax.ShapeDtypeStruct((3,), f32),
        jax.ShapeDtypeStruct((3,), f32),
        jax.ShapeDtypeStruct((N, 2), f32),
        jax.ShapeDtypeStruct((N, 3), f32),
    )
    text = jax.jit(preprocess_frames).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()
    n_triton = text.count("triton")
    if platform == "cuda":
        assert n_triton >= 2, "bilateral + quality kernels expected"
    else:
        assert n_triton == 0


def _window(a, y, x, ks=6):
    """The (2ks+1)^2 clamp-to-edge neighbourhood of pixel (y, x) and the
    (dy, dx) offsets of its taps."""
    H, W = a.shape
    dy, dx = np.meshgrid(np.arange(-ks, ks + 1), np.arange(-ks, ks + 1),
                         indexing="ij")
    yy = np.clip(y + dy, 0, H - 1)
    xx = np.clip(x + dx, 0, W - 1)
    return a[yy, xx], dy.astype(np.float32), dx.astype(np.float32)


def _np_bilateral_sums(d, near, far, ks=6):
    out = np.zeros((3,) + d.shape, np.float64)
    for y in range(d.shape[0]):
        for x in range(d.shape[1]):
            s, dy, dx = _window(d, y, x, ks)
            c = d[y, x]
            drm = 0.35 * c / 4.5
            rng_ = np.abs(s - c)
            border = (s < near) | (s > far) | (rng_ > drm)
            gr = 1.0 - np.minimum(rng_, drm) / max(drm, 1e-20)
            ws = np.where(border, 0.0, (1.0 - np.sqrt(dx**2 + dy**2) / ks) * gr)
            out[:, y, x] = (np.sum(ws * s), np.sum(ws),
                            np.sum(np.where(border, 0.0, gr)))
    return out


def _np_quality_sums(d, ks=6):
    out = np.zeros((2,) + d.shape, np.float64)
    for y in range(d.shape[0]):
        for x in range(d.shape[1]):
            s, _, _ = _window(d, y, x, ks)
            c = d[y, x]
            drm = 0.35 * c
            rng_ = np.abs(s - c)
            border = (s <= 0.0) | (s >= 1.0) | (rng_ > drm)
            gr = 1.0 - np.minimum(rng_, drm) / max(drm, 1e-20)
            out[:, y, x] = (np.sum(border), np.sum(np.where(border, 0.0, gr)))
    return out


@pytest.mark.parametrize("kind", ["bilateral", "quality"])
def test_stencil_fold_matches_numpy_loop(kind):
    """The unrolled 13x13 jnp folds (bilateral_sums, quality_sums), vmapped
    over 2 sensors at 48x40, against a per-pixel NumPy loop over
    clamp-to-edge windows (pre_depth.fs:85-127, pre_quality.fs:65-119)."""
    import jax

    from rgbd_recon.ops.preprocess import bilateral_sums, quality_sums

    rng = np.random.default_rng(11)
    N, H, W = 2, 40, 48
    if kind == "bilateral":
        d = rng.uniform(0.3, 5.0, (N, H, W)).astype(np.float32)
        d[:, 10:20, 10:30] = rng.uniform(1.9, 2.1, (N, 10, 20))  # smooth patch
        d[rng.random((N, H, W)) < 0.1] = 0.0                     # holes
        near = np.array([0.5, 0.6], np.float32)
        far = np.array([4.5, 4.0], np.float32)
        got = jax.jit(jax.vmap(bilateral_sums))(d, near, far)
        want = [_np_bilateral_sums(d[i], near[i], far[i]) for i in range(N)]
    else:
        d = rng.uniform(0.05, 0.95, (N, H, W)).astype(np.float32)
        d[:, 5:25, 5:40] = rng.uniform(0.45, 0.5, (N, 20, 35))
        d[rng.random((N, H, W)) < 0.1] = -1.0                    # invalidated
        d[rng.random((N, H, W)) < 0.1] = 0.0                     # culled
        got = jax.jit(jax.vmap(quality_sums))(d)
        want = [_np_quality_sums(d[i]) for i in range(N)]
    want = np.stack(want, axis=1)                                # (k, N, H, W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-4)
