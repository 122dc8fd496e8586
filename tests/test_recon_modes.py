"""Points (mode 0) and trigrid (mode 2) strategy tests."""

import numpy as np
import pytest

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.config import PipelineConfig
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.ops.raymarch import ViewCamera
from rgbd_recon.recon import TsdfPipeline
from rgbd_recon.recon.points import PointsPipeline
from rgbd_recon.recon.trigrid import TrigridPipeline
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
    cfg = PipelineConfig(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02)
    tsdf_pipe = TsdfPipeline(calib, cfg, BBOX)
    maps, counts = tsdf_pipe.preprocess(frames)
    cam = ViewCamera(width=48, height=40, eye=(0.0, 1.2, 2.5),
                     target=(0.0, 1.1, 0.0))
    return calib, cfg, scene, maps, cam


def test_points_renderer(setup):
    calib, cfg, scene, maps, cam = setup
    pipe = PointsPipeline(calib, cfg)
    img, depth, covered = pipe.make_renderer(cam)(maps)
    img, covered = np.asarray(img), np.asarray(covered)
    assert covered.sum() > 50
    assert img[covered].max() > 0.05
    # background black, depth 1.0
    assert np.asarray(depth)[~covered].min() == 1.0


def test_points_depth_ordering(setup):
    """Splatted depth buffer must be consistent: covered pixels < 1."""
    calib, cfg, scene, maps, cam = setup
    pipe = PointsPipeline(calib, cfg)
    _, depth, covered = pipe.make_renderer(cam)(maps)
    depth, covered = np.asarray(depth), np.asarray(covered)
    assert (depth[covered] < 1.0).all()
    assert (depth[covered] > 0.0).all()


def test_trigrid_renderer(setup):
    calib, cfg, scene, maps, cam = setup
    # min_length scales with grid resolution: the reference's 0.0125 suits
    # 512px grids; our 48px test grid has ~10x coarser spacing
    pipe = TrigridPipeline(calib, cfg, min_length=0.15)
    img, depth, covered = pipe.make_renderer(cam)(maps)
    img, covered = np.asarray(img), np.asarray(covered)
    assert covered.sum() > 50
    assert img[covered].max() > 0.05
    # normalized blend: finite, bounded colors
    assert np.isfinite(img).all()
    assert img.max() < 2.0


def test_trigrid_epsilon_occlusion(setup):
    """Fragments far behind the front surface must not bleed into the
    accumulation: render with a second sphere hidden behind the first."""
    calib, cfg, scene, maps, cam = setup
    pipe = TrigridPipeline(calib, cfg, min_length=0.15, epsilon=0.075)
    img1, _, cov1 = pipe.make_renderer(cam)(maps)
    # tighter epsilon keeps only the closest sheet; coverage shouldn't grow
    pipe2 = TrigridPipeline(calib, cfg, min_length=0.15, epsilon=1e-4)
    img2, _, cov2 = pipe2.make_renderer(cam)(maps)
    assert np.asarray(cov2).sum() <= np.asarray(cov1).sum() + 5
