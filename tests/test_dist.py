"""Distribution tests on the virtual 8-device CPU mesh: sharded pipeline
parity with single-device, halo exchange correctness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.config import PipelineConfig
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.dist import halo_exchange_z, make_mesh, shard_pipeline_step
from rgbd_recon.dist.halo import crop_halo_z
from rgbd_recon.ops.raymarch import ViewCamera
from rgbd_recon.recon import TsdfPipeline
from rgbd_recon.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)


def test_halo_exchange_z():
    mesh = make_mesh(4)
    # global Z = 16 -> 4 per shard
    vol = jnp.arange(16 * 2 * 2, dtype=jnp.float32).reshape(16, 2, 2)
    out = halo_exchange_z(vol, mesh, halo=1)
    out = np.asarray(out)
    # each shard gained 2 slabs -> global 24
    assert out.shape == (24, 2, 2)
    v = np.asarray(vol)
    # shard 1 (global rows 4..7) has ghost = row 3 before and row 8 after
    shard1 = out[6:12]
    np.testing.assert_array_equal(shard1[0], v[3])
    np.testing.assert_array_equal(shard1[1:5], v[4:8])
    np.testing.assert_array_equal(shard1[5], v[8])
    # shard 0's left ghost is edge-clamped to its own first slab
    np.testing.assert_array_equal(out[0], v[0])
    # shard 3's right ghost is edge-clamped
    np.testing.assert_array_equal(out[-1], v[15])
    # crop inverts
    back = crop_halo_z(out, mesh, halo=1)
    np.testing.assert_array_equal(np.asarray(back), v)


@pytest.fixture(scope="module")
def small_setup():
    rig = default_test_rig(
        num_sensors=2, depth_size=(48, 40), color_size=(64, 48), bbox=BBOX
    )
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32))
    frames = render_rig_frames(SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig)
    cfg = PipelineConfig(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02,
                         integrate_taps="bilinear",  # dense sharded path is bilinear
                         # ghost width < the 4-voxel local slab at 8 shards
                         # -> the sharded bake takes the HALO-EXCHANGE path
                         skip_fine_rounds=3,
                         num_lods=4)
    pipe = TsdfPipeline(calib, cfg, BBOX)
    return pipe, frames


def test_sharded_step_matches_single_device(small_setup):
    pipe, frames = small_setup
    camera = ViewCamera(width=48, height=32, eye=(0.0, 1.3, 2.6),
                        target=(0.0, 1.1, 0.0))

    # single-device path
    volume_ref, maps_ref, counts_ref = pipe.fuse(frames)
    out_ref = pipe.make_renderer(camera)(volume_ref, maps_ref, counts_ref)

    # sharded path over 8 virtual devices
    mesh = make_mesh(8)
    step = shard_pipeline_step(pipe, camera, mesh)
    volume_sh, out_sh = step(frames)

    np.testing.assert_allclose(
        np.asarray(volume_sh), np.asarray(volume_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out_sh.color), np.asarray(out_ref.color), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(out_sh.hit), np.asarray(out_ref.hit))


def test_sharded_volume_actually_sharded(small_setup):
    pipe, frames = small_setup
    camera = ViewCamera(width=48, height=32, eye=(0.0, 1.3, 2.6))
    mesh = make_mesh(8)
    step = shard_pipeline_step(pipe, camera, mesh)
    volume_sh, _ = step(frames)
    # the volume's sharding must partition axis 0 over the mesh
    shardings = {s.device for s in volume_sh.addressable_shards}
    assert len(shardings) == 8


def test_refine_poses_psum_matches_single(small_setup):
    """The psum-reduced normal equations under the mesh produce the same
    pose corrections as the single-device solver."""
    from rgbd_recon.refine import pose_ba

    pipe, frames = small_setup
    volume, maps, counts = pipe.fuse(frames)
    poses_s, _ = pose_ba.refine_poses(
        pipe.calib, maps, volume, pipe.config.tsdf_limit, iters=2
    )
    mesh = make_mesh(8)
    poses_m, _ = pose_ba.refine_poses(
        pipe.calib, maps, volume, pipe.config.tsdf_limit, iters=2, mesh=mesh
    )
    # atol 3e-4: the null-projected prior eigendecomposes JtWJ, and the
    # psum'd normal equations differ from the single-device sum by f32
    # reassociation — eigenvectors of near-degenerate directions amplify
    # that into slightly different (equally valid) prior projectors
    np.testing.assert_allclose(
        np.asarray(poses_m), np.asarray(poses_s), atol=3e-4
    )


def test_sensor_sharded_preprocess_matches_replicated():
    """SURVEY §2.10 per-host sensor shards: the preprocess chain sharded
    over the sensor axis must reproduce the replicated chain (maps AND
    brick counters) exactly."""
    from rgbd_recon.dist import shard_preprocess

    rig = default_test_rig(
        num_sensors=8, depth_size=(32, 24), color_size=(40, 32), bbox=BBOX
    )
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(12, 16, 12),
                                        inv_res=(16, 18, 16))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    cfg = PipelineConfig(voxel_size=0.125, brick_size=0.25, tsdf_limit=0.04)
    pipe = TsdfPipeline(calib, cfg, BBOX)

    maps_ref, counts_ref = pipe.preprocess(frames)

    mesh = make_mesh(8)
    maps_sh, counts_sh = shard_preprocess(pipe, mesh)(frames)

    np.testing.assert_array_equal(
        np.asarray(counts_sh), np.asarray(counts_ref)
    )
    for name, atol in (("depth", 1e-6), ("quality", 1e-6),
                       ("silhouette", 1e-6), ("normal", 1e-5),
                       # LAB: XLA fuses the colorspace chain differently
                       # per sharding -> f32 reassociation at ~1e-4
                       ("lab", 2e-4)):
        np.testing.assert_allclose(
            np.asarray(getattr(maps_sh, name)),
            np.asarray(getattr(maps_ref, name)),
            rtol=1e-4, atol=atol, err_msg=name,
        )
