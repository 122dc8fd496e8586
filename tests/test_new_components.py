"""Tests for round-2 components: stereo output, calib-vis mode, MVT mode,
checkpointing, DXT codecs, and orbit navigation."""

import numpy as np
import pytest

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.config import PipelineConfig
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.ops.raymarch import ViewCamera
from rgbd_recon.recon import CalibVisPipeline, MvtPipeline, TsdfPipeline
from rgbd_recon.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


@pytest.fixture(scope="module")
def setup():
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                          color_size=(64, 48), bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32))
    scene = SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)])
    frames = render_rig_frames(scene, rig)
    cfg = PipelineConfig(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02,
                         num_lods=4)
    pipe = TsdfPipeline(calib, cfg, BBOX)
    volume, maps, counts = pipe.fuse(frames)
    cam = ViewCamera(width=48, height=40, eye=(0.0, 1.2, 2.5),
                     target=(0.0, 1.1, 0.0))
    return calib, cfg, pipe, volume, maps, counts, cam


# ---------------------------------------------------------------------------
# stereo
# ---------------------------------------------------------------------------

def test_stereo_cameras_separated(setup):
    from rgbd_recon.viz import StereoCamera

    *_, cam = setup
    st = StereoCamera(cyclops=cam, eye_separation=0.065)
    le, re = np.asarray(st.left.eye), np.asarray(st.right.eye)
    assert np.isclose(np.linalg.norm(le - re), 0.065, atol=1e-5)
    # both eyes look parallel to the cyclops direction (shifted targets)
    assert np.allclose(st.left.rotation(), cam.rotation(), atol=1e-5)


def test_anaglyph_composition_channels(setup):
    from rgbd_recon.viz import StereoCamera, make_stereo_renderer

    calib, cfg, pipe, volume, maps, counts, cam = setup
    st = StereoCamera(cyclops=cam)
    render = make_stereo_renderer(pipe.make_renderer, st, mode="anaglyph")
    img = np.asarray(render(volume, maps, counts))
    assert img.shape == (cam.height, cam.width, 3)
    # left/right differ -> red channel comes from a different view than blue
    render_l = pipe.make_renderer(st.left)
    out_l = np.asarray(render_l(volume, maps, counts).color)
    assert np.allclose(img[..., 0], out_l[..., 0], atol=1e-5)


def test_side_by_side_width(setup):
    from rgbd_recon.viz import StereoCamera, make_stereo_renderer

    calib, cfg, pipe, volume, maps, counts, cam = setup
    st = StereoCamera(cyclops=cam)
    render = make_stereo_renderer(pipe.make_renderer, st, mode="side-by-side")
    img = np.asarray(render(volume, maps, counts))
    assert img.shape == (cam.height, cam.width * 2, 3)


# ---------------------------------------------------------------------------
# calib vis (mode 4)
# ---------------------------------------------------------------------------

def test_calib_vis_renders_surface_band(setup):
    calib, cfg, pipe, volume, maps, counts, cam = setup
    vis = CalibVisPipeline(pipe.volume_grid, tsdf_limit=cfg.tsdf_limit)
    img, depth, covered = vis.make_renderer(cam)(volume)
    img, covered = np.asarray(img), np.asarray(covered)
    assert covered.sum() > 20
    # with the default phantom_hull=False volume, unobserved voxels sit at
    # -limit (green class, zero brightness) and the written band provides
    # bright green (just-inside) and red (just-outside) voxels; the blue
    # class (tsd >= +limit) exists only in phantom_hull=True parity volumes
    assert img[..., 0].max() > 0.2  # red: written just-outside band
    assert img[..., 1].max() > 0.2  # green: written just-inside band


# ---------------------------------------------------------------------------
# mvt (mode 3)
# ---------------------------------------------------------------------------

def test_mvt_renderer(setup):
    calib, cfg, pipe, volume, maps, counts, cam = setup
    mvt = MvtPipeline(calib, cfg, min_length=0.15)
    img, depth, covered = mvt.make_renderer(cam)(maps)
    img, covered = np.asarray(img), np.asarray(covered)
    # the in-kernel bilateral on raw depth keeps fewer fragments than the
    # full preprocessed chain at this tiny test resolution
    assert covered.sum() > 20
    assert np.isfinite(img).all()


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, setup):
    from rgbd_recon.io import CheckpointManager, ReconCheckpoint, config_to_json

    calib, cfg, pipe, volume, maps, counts, cam = setup
    ck = ReconCheckpoint(
        volume=np.asarray(volume),
        brick_counts=np.asarray(counts),
        poses=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        frame_index=7,
        timestamp=0.233,
        config_json=config_to_json(cfg),
    )
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(ck)
    loaded = mgr.latest()
    assert loaded.frame_index == 7
    np.testing.assert_array_equal(loaded.volume, np.asarray(volume))
    np.testing.assert_array_equal(loaded.brick_counts, np.asarray(counts))
    assert loaded.config_json == config_to_json(cfg)


def test_checkpoint_rotation(tmp_path):
    from rgbd_recon.io import CheckpointManager, ReconCheckpoint

    mgr = CheckpointManager(tmp_path, keep=2)
    for i in range(4):
        mgr.save(ReconCheckpoint(volume=np.zeros((2, 2, 2), np.float32),
                                 frame_index=i))
    files = sorted(tmp_path.glob("ckpt_*.npz"))
    assert len(files) == 2
    assert mgr.latest().frame_index == 3


def test_volume_binary_format(tmp_path):
    from rgbd_recon.calib.volume_io import read_calibration_volume
    from rgbd_recon.io import save_volume_binary

    vol = np.random.default_rng(0).normal(size=(4, 5, 6)).astype(np.float32)
    p = save_volume_binary(tmp_path / "v.bin", vol, limits=(0.5, 4.5))
    # readable through the calibration-volume reader (same binary layout)
    back, limits = read_calibration_volume(p, channels=1)
    np.testing.assert_allclose(np.asarray(back)[..., 0], vol)
    assert tuple(np.asarray(limits)) == (0.5, 4.5)


# ---------------------------------------------------------------------------
# DXT codecs + depth compression
# ---------------------------------------------------------------------------

def test_dxt1_roundtrip_flat_blocks():
    from rgbd_recon.io import dxt

    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = [255, 0, 0]
    img[:4, 4:] = [0, 255, 0]
    img[4:, :4] = [0, 0, 255]
    img[4:, 4:] = [128, 128, 128]
    data = dxt.encode_dxt1(img)
    assert len(data) == dxt.dxt1_storage_size(8, 8)
    out = dxt.decode_dxt1(data, 8, 8)
    # flat blocks survive 565 quantization within ~8 levels
    assert np.abs(out.astype(int) - img.astype(int)).max() <= 8


def test_dxt1_gradient_quality():
    from rgbd_recon.io import dxt

    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 255, (16, 16, 3)) * 0.3
           + np.linspace(0, 170, 16)[None, :, None]).astype(np.uint8)
    out = dxt.decode_dxt1(dxt.encode_dxt1(img), 16, 16)
    rmse = np.sqrt(np.mean((out.astype(float) - img.astype(float)) ** 2))
    assert rmse < 30.0  # range-fit quality bound


def test_dxt5_alpha():
    from rgbd_recon.io import dxt

    # one opaque DXT5 block: alpha palette a0=255, a1=255 -> all 255
    color_block = dxt.encode_dxt1(np.full((4, 4, 3), 200, np.uint8))
    alpha_block = bytes([255, 254] + [0] * 6)
    out = dxt.decode_dxt5(alpha_block + color_block, 4, 4)
    assert out.shape == (4, 4, 4)
    assert (out[..., 3] == 255).all()
    assert np.abs(out[..., :3].astype(int) - 200).max() <= 8


def test_depth_compression_roundtrip():
    from rgbd_recon.io import dxt

    near, far = 0.5, 4.5
    d = np.linspace(0.6, 4.4, 256).astype(np.float32)
    u8 = dxt.compress_depth(d, near, far)
    back = dxt.uncompress_depth(u8, near, far)
    ok = back > 0
    assert ok.mean() > 0.95
    # sqrt mapping: relative error grows with depth but stays small
    assert np.abs(back[ok] - d[ok]).max() < 0.06


def test_depth_compression_invalid_is_zero():
    from rgbd_recon.io import dxt

    u8 = dxt.compress_depth(np.array([0.0, 0.2, 10.0], np.float32), 0.5, 4.5)
    assert (dxt.uncompress_depth(u8, 0.5, 4.5) == 0.0).all()


# ---------------------------------------------------------------------------
# navigation
# ---------------------------------------------------------------------------

def test_orbit_navigator_distance_and_target():
    from rgbd_recon.viz import OrbitNavigator

    nav = OrbitNavigator(poi=(0.0, 1.0, 0.0), distance=3.0)
    cam = nav.camera()
    assert np.isclose(np.linalg.norm(np.asarray(cam.eye) - np.asarray(nav.poi)), 3.0)
    nav.orbit(np.pi / 2, 0.0)
    cam2 = nav.camera()
    assert not np.allclose(cam.eye, cam2.eye)
    assert np.isclose(
        np.linalg.norm(np.asarray(cam2.eye) - np.asarray(nav.poi)), 3.0
    )


def test_orbit_navigator_zoom_reset():
    from rgbd_recon.viz import OrbitNavigator

    nav = OrbitNavigator(distance=2.0)
    nav.zoom(0.5)
    assert np.isclose(nav.distance, 1.0)
    nav.pan(0.3, -0.1)
    nav.reset()
    assert np.isclose(nav.distance, 2.0)
    assert np.allclose(nav.poi, (0.0, 1.1, 0.0))
