"""Raymarch kernel tests: analytic-sphere accuracy, secant refinement,
space skipping, shading."""

import jax.numpy as jnp
import pytest
import numpy as np

from rgbd_recon.core.grid import BoundingBox, VolumeGrid
from rgbd_recon.ops import raymarch
from rgbd_recon.ops.holefill import fill_colors

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def _sphere_volume(grid: VolumeGrid, center, radius, limit):
    """Analytic truncated SDF volume. Sign convention matches the
    integration kernel: negative outside/behind-carved, positive... the
    reference marches until density > 0 means *inside* — build -sdf."""
    centers = BBOX.denormalize(grid.voxel_centers_normalized())
    sdf = np.linalg.norm(centers - np.asarray(center, np.float32), axis=-1) - radius
    return jnp.asarray(np.clip(-sdf, -limit, limit).astype(np.float32))


def test_march_hits_sphere_accurately():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.02)
    limit = 0.02
    vol = _sphere_volume(grid, (0.0, 1.1, 0.0), 0.5, limit)

    cam = raymarch.ViewCamera(width=48, height=40, eye=(0.0, 1.1, 2.5),
                              target=(0.0, 1.1, 0.0))
    eye_vol = jnp.asarray(BBOX.normalize(np.asarray(cam.eye, np.float32)))
    dirs = jnp.asarray(cam.ray_directions_world() / BBOX.size)

    hit, hit_pos, num = raymarch.march(vol, eye_vol, dirs, limit, max_steps=300)
    hit = np.asarray(hit)
    assert hit.sum() > 100

    world = BBOX.denormalize(np.asarray(hit_pos))
    d_err = np.abs(
        np.linalg.norm(world[hit] - np.array([0.0, 1.1, 0.0]), axis=-1) - 0.5
    )
    # secant refinement should land well within a voxel of the surface
    assert np.median(d_err) < 0.01
    assert d_err.max() < 0.05


def test_march_misses_empty_volume():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.1)
    vol = jnp.full(grid.shape, -0.02, jnp.float32)
    cam = raymarch.ViewCamera(width=16, height=12, eye=(0.0, 1.1, 2.5))
    eye_vol = jnp.asarray(BBOX.normalize(np.asarray(cam.eye, np.float32)))
    dirs = jnp.asarray(cam.ray_directions_world() / BBOX.size)
    hit, _, num = raymarch.march(vol, eye_vol, dirs, 0.02, max_steps=200)
    assert not np.asarray(hit).any()
    assert np.asarray(num).max() > 0  # rays did march through the box


def test_march_ray_outside_box_samples_zero():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.1)
    vol = jnp.full(grid.shape, 0.02, jnp.float32)  # everything "inside"
    cam = raymarch.ViewCamera(width=8, height=8, eye=(0.0, 1.1, 5.0),
                              target=(0.0, 1.1, 10.0))  # looking away
    eye_vol = jnp.asarray(BBOX.normalize(np.asarray(cam.eye, np.float32)))
    dirs = jnp.asarray(cam.ray_directions_world() / BBOX.size)
    hit, _, num = raymarch.march(vol, eye_vol, dirs, 0.02, max_steps=100)
    assert not np.asarray(hit).any()


def test_gradient_normal_sphere():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.02)
    limit = 0.02
    vol = _sphere_volume(grid, (0.0, 1.1, 0.0), 0.5, limit)
    # points on the +z surface of the sphere, in volume coords
    p_world = np.array([[0.0, 1.1, 0.5]], np.float32)
    p_vol = jnp.asarray(BBOX.normalize(p_world))
    g = np.asarray(raymarch.gradient_normal(vol, p_vol, limit))[0]
    # gradient is in volume space; world normal ~ g / bbox_size normalized
    n_world = g / BBOX.size
    n_world /= np.linalg.norm(n_world)
    np.testing.assert_allclose(n_world, [0.0, 0.0, 1.0], atol=0.05)


def test_shade_modes():
    view_pos = jnp.asarray(np.array([[0.0, 0.0, -2.0]], np.float32))
    view_normal = jnp.asarray(np.array([[0.0, 0.0, 1.0]], np.float32))
    diffuse = jnp.asarray(np.array([[0.3, 0.6, 0.9]], np.float32))
    # mode 0: textured passthrough
    np.testing.assert_allclose(
        np.asarray(raymarch.shade(view_pos, view_normal, diffuse, 0)), [[0.3, 0.6, 0.9]]
    )
    # mode 1: lit Blinn-Phong is positive and bounded
    lit = np.asarray(raymarch.shade(view_pos, view_normal, diffuse, 1))
    assert (lit > 0).all() and (lit < 2.0).all()
    # unlit face gets ambient only
    away = jnp.asarray(np.array([[0.0, 0.0, -1.0]], np.float32))
    amb = np.asarray(raymarch.shade(view_pos, away, diffuse, 1))
    np.testing.assert_allclose(
        amb, np.asarray([[1.0, 0.9, 0.7]]) * 0.2 * 0.5, rtol=1e-5
    )


def test_blend_colors_fallback_alpha():
    """When no sensor is depth-consistent at the sample, alpha = -1 and the
    inverse-distance fallback is used (tsdf_raymarch.fs:329-337)."""
    inv = np.zeros((1, 2, 2, 2, 4), np.float32)
    inv[..., 0] = 0.5
    inv[..., 1] = 0.5
    inv[..., 2] = 0.9  # voxel projects far from measured depth
    inv[..., 3] = 1.0  # in-frustum (validity channel)
    cv_uv = np.full((1, 2, 2, 2, 2), 0.5, np.float32)
    colors = np.full((1, 4, 4, 3), 0.7, np.float32)
    depths = np.full((1, 4, 4), 0.2, np.float32)
    quals = np.ones((1, 4, 4), np.float32)
    pos = jnp.asarray(np.full((5, 3), 0.5, np.float32))
    out = np.asarray(
        raymarch.blend_colors(
            pos, jnp.asarray(inv), jnp.asarray(cv_uv), jnp.asarray(colors),
            jnp.asarray(depths), jnp.asarray(quals), 0.01,
        )
    )
    np.testing.assert_allclose(out[:, 3], -1.0)
    np.testing.assert_allclose(out[:, :3], 0.7, rtol=1e-5)

    # depth-consistent case: alpha = +1
    inv2 = inv.copy()
    inv2[..., 2] = 0.2
    out2 = np.asarray(
        raymarch.blend_colors(
            pos, jnp.asarray(inv2), jnp.asarray(cv_uv), jnp.asarray(colors),
            jnp.asarray(depths), jnp.asarray(quals), 0.01,
        )
    )
    np.testing.assert_allclose(out2[:, 3], 1.0)


def test_holefill_fills_small_hole():
    """A hole in an otherwise valid image gets plausible colors from the
    pyramid; valid pixels keep their LOD0 value after push."""
    H, W = 32, 32
    rgba = np.zeros((H, W, 4), np.float32)
    rgba[..., 0] = 0.8
    rgba[..., 1] = 0.4
    rgba[..., 3] = 1.0
    depth = np.full((H, W), 0.5, np.float32)
    # punch a hole (failed rays: alpha 0, depth 1... but surface behind ->
    # reference semantics: raymarch discard leaves clear depth 1.0)
    rgba[14:18, 14:18] = 0.0
    depth[14:18, 14:18] = 1.0
    out, d = fill_colors(jnp.asarray(rgba), jnp.asarray(depth), num_lods=5)
    out = np.asarray(out)
    # valid pixels unchanged
    np.testing.assert_allclose(out[4, 4, :3], [0.8, 0.4, 0.0], atol=1e-5)
    # hole pixels pulled from surrounding color
    hole = out[15, 15, :3]
    assert abs(hole[0] - 0.8) < 0.3 and abs(hole[1] - 0.4) < 0.3


def test_holefill_respects_far_side_rule():
    """Pull keeps only samples at/behind the window average depth
    (tsdf_inpaint.fs:77)."""
    H, W = 8, 8
    rgba = np.zeros((H, W, 4), np.float32)
    depth = np.full((H, W), 1.0, np.float32)
    # two valid pixels in one pull window: near (0.2, red) and far (0.8, blue)
    rgba[0, 0] = [1.0, 0.0, 0.0, 1.0]
    depth[0, 0] = 0.2
    rgba[0, 1] = [0.0, 0.0, 1.0, 1.0]
    depth[0, 1] = 0.8
    from rgbd_recon.ops.holefill import pull

    c1, d1 = pull(jnp.asarray(rgba), jnp.asarray(depth))
    c1, d1 = np.asarray(c1), np.asarray(d1)
    # avg = 0.5 -> only the far (blue) sample survives
    np.testing.assert_allclose(c1[0, 0, :3], [0.0, 0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(d1[0, 0], 0.8, atol=1e-6)


def test_alternative_blend_modes():
    """blendColors2 variants (tsdf_raymarch.fs:266-301): both produce
    finite colors at hits; best_two must only mix two sensors' colors."""
    import dataclasses

    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.core import PipelineConfig
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors import (
        SyntheticScene, default_test_rig, render_rig_frames,
    )

    bbox = BBOX
    rig = default_test_rig(num_sensors=3, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    cfg = PipelineConfig(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02,
                         num_lods=4)
    pipe = TsdfPipeline(calib, cfg, bbox)
    volume, maps, counts = pipe.fuse(frames)
    cam = raymarch.ViewCamera(width=64, height=48, eye=(0.0, 1.3, 2.6),
                              target=(0.0, 1.1, 0.0))
    base = pipe.make_renderer(cam)(volume, maps, counts)
    assert np.asarray(base.hit).sum() > 50

    for mode in ("normal_deviation", "best_two"):
        p2 = TsdfPipeline(calib, dataclasses.replace(cfg, blend_mode=mode),
                          bbox)
        out = p2.make_renderer(cam)(volume, maps, counts)
        img = np.asarray(out.color)
        assert np.isfinite(img).all(), mode
        # same surface, different colors than the quality blend
        np.testing.assert_array_equal(np.asarray(out.hit),
                                      np.asarray(base.hit))


def test_parity_mode_matches_fast_defaults():
    """The reference-exact toggles (trilinear march, uniform stepping,
    bilinear integrate taps, phantom_hull, full-res marking) must produce
    the same surface as the fast defaults to sub-voxel depth RMSE — the
    documented parity claim as a tested invariant (round-2 verdict #10)."""
    import dataclasses

    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.core import PipelineConfig
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors import (
        SyntheticScene, default_test_rig, render_rig_frames,
    )

    bbox = BBOX
    rig = default_test_rig(num_sensors=3, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(24, 32, 24),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    fast = PipelineConfig(voxel_size=0.025, brick_size=0.125,
                          tsdf_limit=0.015, num_lods=4)
    # phantom_hull stays False on both sides: the parity toggle re-creates
    # the reference's phantom hull WALLS (extra surfaces by design), which
    # would dominate a fast-vs-exact comparison of the *measured* surface
    parity = dataclasses.replace(
        fast, march_mode="trilinear", march_empty_skip=False,
        integrate_taps="bilinear", mark_stride=1,
        projection_model=False, surface_skip=False,
    )
    cam = raymarch.ViewCamera(width=96, height=80, eye=(0.0, 1.3, 2.6),
                              target=(0.0, 1.1, 0.0))

    pipe_f = TsdfPipeline(calib, fast, bbox)
    vf, mf, cf = pipe_f.fuse(frames)
    of = pipe_f.make_renderer(cam)(vf, mf, cf)

    pipe_p = TsdfPipeline(calib, parity, bbox)
    vp, mp, cp = pipe_p.fuse(frames)
    op = pipe_p.make_renderer(cam)(vp, mp, cp)

    hf_, hp_ = np.asarray(of.hit), np.asarray(op.hit)
    assert hf_.sum() > 100 and hp_.sum() > 100
    # surfaces agree: strong hit-mask overlap (differences are confined to
    # the silhouette rim where nearest vs trilinear fields genuinely
    # disagree at sub-voxel scale) and sub-voxel depth RMSE on common hits
    both = hf_ & hp_
    agree = both.sum() / max(hf_.sum(), hp_.sum())
    assert agree > 0.85, agree
    from scipy import ndimage

    rim = ndimage.binary_dilation(
        hf_ ^ ndimage.binary_erosion(hf_, iterations=2), iterations=2
    )
    off_rim = (hf_ ^ hp_) & ~rim
    assert off_rim.sum() <= 0.02 * both.sum(), off_rim.sum()
    df, dp = np.asarray(of.depth), np.asarray(op.depth)
    diff = np.abs(df[both] - dp[both])
    # window depth spans [0,1] over [0.1, 20] m; ~0.004 window units at the
    # surface distance ~ one voxel at this test scale. A few hull-edge
    # pixels cross at genuinely different bricks — bound the bulk.
    assert np.quantile(diff, 0.9) < 0.004, np.quantile(diff, 0.9)


def test_half_pair_layout_matches_full():
    """half=True PackedVolume must sample identically to half=False
    (nearest AND trilinear) — the fast march table layout."""
    import jax
    import jax.numpy as jnp

    from rgbd_recon.ops.raymarch import PackedVolume

    key = jax.random.PRNGKey(3)
    vol = jax.random.normal(key, (12, 10, 16), jnp.float32)
    pf = PackedVolume.from_volume(vol)
    ph = PackedVolume.from_volume(vol, half=True)
    pos = jax.random.uniform(jax.random.PRNGKey(4), (500, 3), jnp.float32,
                             -0.1, 1.1)
    nf = np.asarray(pf.sample_nearest(pos))
    nh = np.asarray(ph.sample_nearest(pos))
    np.testing.assert_array_equal(nf, nh)
    tf = np.asarray(pf.sample_trilinear(pos))
    th = np.asarray(ph.sample_trilinear(pos))
    np.testing.assert_allclose(tf, th, rtol=0, atol=1e-6)


def test_oct_volume_matches_trilinear_and_gradient():
    """OctVolume.sample_p == GL trilinear over covered bricks (fill
    elsewhere); gradient_p == analytic trilinear-cell slope, checked
    against finite differences of the trilinear field."""
    import jax
    import jax.numpy as jnp

    from rgbd_recon.ops.raymarch import (
        PackedVolume,
        build_oct_bricks,
    )

    v = 4
    Z, Y, X = 12, 8, 16
    key = jax.random.PRNGKey(7)
    vol = jax.random.normal(key, (Z, Y, X), jnp.float32)
    occ = jax.random.uniform(jax.random.PRNGKey(8),
                             (Z // v, Y // v, X // v)) < 0.5
    limit = 0.5
    oct = build_oct_bricks(vol, occ, v, capacity=16, limit=limit,
                           dtype=jnp.float32)
    packed = PackedVolume.from_volume(vol)

    # positions inside covered bricks -> exact trilinear parity
    pos = jax.random.uniform(jax.random.PRNGKey(9), (800, 3), jnp.float32,
                             0.02, 0.98)
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    # anchor cell brick (same math as OctVolume._cells)
    import numpy as onp
    x0 = onp.clip(onp.floor(onp.asarray(px) * X - 0.5).astype(int), 0, X - 1)
    y0 = onp.clip(onp.floor(onp.asarray(py) * Y - 0.5).astype(int), 0, Y - 1)
    z0 = onp.clip(onp.floor(onp.asarray(pz) * Z - 0.5).astype(int), 0, Z - 1)
    occ_np = onp.asarray(occ)
    covered = occ_np[z0 // v, y0 // v, x0 // v]

    got = onp.asarray(oct.sample_p(px, py, pz, fill=-limit))
    want = onp.asarray(packed.sample_trilinear(pos))
    onp.testing.assert_allclose(got[covered], want[covered],
                                rtol=0, atol=1e-5)
    onp.testing.assert_allclose(got[~covered], -limit, rtol=0, atol=0)

    # analytic gradient vs central differences of the trilinear field,
    # at cell-interior positions (finite differences must not cross cell
    # boundaries where the trilinear slope is discontinuous)
    grid = (onp.stack(onp.meshgrid(
        onp.linspace(0.3, 0.7, 5), onp.linspace(0.3, 0.7, 5),
        onp.linspace(0.3, 0.7, 5), indexing="ij"), -1)
        .reshape(-1, 3).astype(onp.float32))
    # nudge to cell centers: (i + 0.5 + 0.5)/R keeps +-eps inside the cell
    for j, R in enumerate((X, Y, Z)):
        grid[:, j] = (onp.floor(grid[:, j] * R - 0.5) + 1.0) / R
    gp = jnp.asarray(grid)
    g, valid = oct.gradient_p(gp[:, 0], gp[:, 1], gp[:, 2])
    g = onp.asarray(g)
    valid = onp.asarray(valid)
    eps = 1e-3 / max(Z, Y, X)
    for ax, R in ((0, X), (1, Y), (2, Z)):
        hi = grid.copy()
        hi[:, ax] += eps
        lo = grid.copy()
        lo[:, ax] -= eps
        fd = (onp.asarray(packed.sample_trilinear(jnp.asarray(hi)))
              - onp.asarray(packed.sample_trilinear(jnp.asarray(lo)))) / (
                  2 * eps)
        onp.testing.assert_allclose(g[valid, ax], fd[valid], rtol=2e-3,
                                    atol=2e-2)


def test_widened_refine_recovers_trilinear_crossing():
    """oct_refine_crossing(widen_steps>0) must land on the TRILINEAR
    field's zero crossing even when the nearest-march bracket is offset
    by up to half a voxel (the fast-mode accuracy penalty, ABLATION.md).
    Field: smooth linear-in-z TSDF whose trilinear crossing is known in
    closed form; the fed-in bracket is deliberately shifted."""
    import jax.numpy as jnp

    from rgbd_recon.ops.raymarch import build_oct_bricks

    v = 4
    Z, Y, X = 16, 8, 8
    limit = 0.5
    # f(z) = (z_norm - 0.53) * 4: zero at z_norm = 0.53, |f| within
    # +-limit near the crossing; voxel centers at (k + 0.5)/Z
    zc = (jnp.arange(Z, dtype=jnp.float32) + 0.5) / Z
    vol = jnp.broadcast_to(
        ((zc - 0.53) * 4.0)[:, None, None], (Z, Y, X)
    )
    occ = jnp.ones((Z // v, Y // v, X // v), bool)
    oct = build_oct_bricks(vol, occ, v, capacity=16, limit=limit,
                           dtype=jnp.float32)

    R = 64
    # rays straight down +z through random (x, y)
    px = jnp.linspace(0.2, 0.8, R)
    py = jnp.full((R,), 0.5)
    pz = jnp.zeros((R,))
    pos0 = (px, py, pz)
    dn = (jnp.zeros((R,)), jnp.zeros((R,)), jnp.ones((R,)))
    sd = limit * 0.5
    # nearest-march bracket shifted half a voxel PAST the true crossing
    t_true = 0.53
    lo_t = jnp.full((R,), t_true + 0.2 / Z)
    hi_t = lo_t + sd
    hit = jnp.ones((R,), bool)
    hit_pos = jnp.stack([px, py, lo_t], axis=-1)

    from rgbd_recon.ops import raymarch

    hp = raymarch.oct_refine_crossing(
        oct, pos0, dn, lo_t, hi_t, hit, hit_pos, limit,
        widen_steps=1.5, widen_samples=8,
    )
    # refined z must be the trilinear crossing to sub-0.1-voxel accuracy
    np.testing.assert_allclose(
        np.asarray(hp[:, 2]), t_true, rtol=0, atol=0.1 / Z
    )
    # widen_steps=0 keeps the old endpoint-confirm behavior: the shifted
    # bracket has f>0 at BOTH ends, so the refine must fall back to
    # hit_pos unchanged
    hp0 = raymarch.oct_refine_crossing(
        oct, pos0, dn, lo_t, hi_t, hit, hit_pos, limit, widen_steps=0.0,
    )
    np.testing.assert_array_equal(np.asarray(hp0), np.asarray(hit_pos))


def test_fill_colors_planar_matches_numpy_reference():
    """The planar pull-push fill (the render's form) against the
    independent NumPy fill of tests/golden_np.py on a random image with
    scattered and one large hole; both pyramids stay in f32, so the
    selection/interpolation matmuls must not lose precision."""
    import os
    import sys

    import jax

    from rgbd_recon.ops.holefill import fill_colors_planar

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import golden_np

    H, W = 40, 72
    rng = np.random.default_rng(3)
    valid = rng.random((H, W)) < 0.5
    valid[10:25, 20:50] = False
    rgba = rng.random((H, W, 4)).astype(np.float32)
    rgba[..., 3] = 1.0
    rgba[~valid] = 0.0
    depth = np.where(valid, rng.uniform(0.2, 0.9, (H, W)), 1.0)
    depth = depth.astype(np.float32)
    planes, _ = jax.jit(lambda p, d: fill_colors_planar(p, d, 5))(
        [jnp.asarray(rgba[..., i]) for i in range(4)], jnp.asarray(depth))
    got = np.stack([np.asarray(p) for p in planes], axis=-1)
    want, _ = golden_np.fill_colors(rgba, depth, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _np_chebyshev(mask):
    """Brute-force Chebyshev (L-inf) distance to the nearest True cell;
    inf when there is none. Cells outside the array are never True."""
    grid = np.indices(mask.shape).reshape(mask.ndim, -1).T
    pts = np.argwhere(mask)
    dist = np.full(len(grid), np.inf)
    for i in range(0, len(pts), 256):
        d = np.abs(grid[:, None, :] - pts[None, i:i + 256]).max(-1).min(1)
        dist = np.minimum(dist, d)
    return dist.reshape(mask.shape)


@pytest.mark.parametrize("scene", ["sphere", "corner_voxel"])
def test_bake_matches_numpy_reference(scene):
    """The single-device march-volume bake (1-voxel dilation -> surface
    bricks, brick and voxel Chebyshev clearance, sentinel encode, half-pair
    pack) against a brute-force NumPy distance transform on a
    brick-aligned 20^3 volume with 5-voxel bricks."""
    import jax

    from rgbd_recon.calib.sensors import build_synthetic_calibration
    from rgbd_recon.core.config import PipelineConfig
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors.synthetic import default_test_rig

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.0, 1.0))
    rig = default_test_rig(num_sensors=1, depth_size=(16, 12),
                           color_size=(16, 12), bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(8, 12, 8),
                                        inv_res=(20, 20, 20))
    cfg = PipelineConfig(voxel_size=0.1, brick_size=0.5, tsdf_limit=0.05,
                         march_dtype="float32")
    pipe = TsdfPipeline(calib, cfg, bbox)
    cam = raymarch.ViewCamera(width=32, height=24, eye=(0.0, 1.0, 2.6),
                              target=(0.0, 1.0, 0.0))
    render_fn, _ = pipe.make_render_fn(cam)
    limit = cfg.tsdf_limit
    v, K, Kb = pipe.brick_vox, cfg.skip_fine_rounds, cfg.skip_brick_rounds
    assert v == 5 and pipe.volume_grid.shape == (20, 20, 20)

    if scene == "sphere":
        grid = VolumeGrid(bbox=bbox, voxel_size=0.1)
        centers = bbox.denormalize(grid.voxel_centers_normalized())
        sdf = np.linalg.norm(centers - np.float32([0.3, 1.2, -0.2]), axis=-1)
        vol = np.clip(0.45 - sdf, -limit, limit).astype(np.float32)
    else:
        vol = np.full((20, 20, 20), -limit, np.float32)
        vol[19, 0, 7] = limit  # on three faces: no wraparound allowed

    packed, _, occ, bsafe, _ = jax.jit(
        lambda x: render_fn.bake(x, None, jnp.float32(limit)))(vol)

    dist = _np_chebyshev(vol > 0.0)
    occ_ref = (dist <= 1).reshape(4, v, 4, v, 4, v).any(axis=(1, 3, 5))
    bsafe_ref = np.clip(_np_chebyshev(occ_ref) - 1, 0, Kb)
    fine_ref = np.clip(dist - 1, 0, K)
    bs_vox = np.repeat(np.repeat(np.repeat(bsafe_ref, v, 0), v, 1), v, 2)
    field = np.maximum(fine_ref, bs_vox * v)
    baked_ref = np.where(field > 0, -(2.0 + field), vol)

    np.testing.assert_array_equal(np.asarray(occ), occ_ref)
    np.testing.assert_array_equal(np.asarray(bsafe), bsafe_ref)
    assert packed.half
    np.testing.assert_array_equal(
        np.asarray(packed.pairs).reshape(20, 20, 20), baked_ref)

