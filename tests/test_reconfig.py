"""Runtime reconfiguration: live voxel/brick/limit changes and the
feedback control plane (the reference's GUI sliders + FeedbackReceiver,
recon_integration.cpp:341-354, 468-484; kinect_client.cpp:362-376,
637-673)."""

import numpy as np
import pytest

from rgbd_recon.calib.sensors import build_synthetic_calibration
from rgbd_recon.core.config import PipelineConfig
from rgbd_recon.core.grid import BoundingBox
from rgbd_recon.ops.raymarch import ViewCamera
from rgbd_recon.recon import TsdfPipeline
from rgbd_recon.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


@pytest.fixture(scope="module")
def setup():
    rig = default_test_rig(
        num_sensors=2, depth_size=(48, 40), color_size=(64, 48), bbox=BBOX
    )
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32))
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    return calib, frames


def test_voxel_size_flip_keeps_frames_flowing(setup):
    """The reference rebuilds volume + bricks on a voxel-size change
    (recon_integration.cpp:341-354); here reconfigure() re-derives grids
    and bakes, and existing renderer handles keep working."""
    calib, frames = setup
    cfg = PipelineConfig(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02,
                        num_lods=4)
    pipe = TsdfPipeline(calib, cfg, BBOX)
    cam = ViewCamera(width=64, height=48, eye=(0.0, 1.3, 2.6),
                     target=(0.0, 1.1, 0.0))
    renderer = pipe.make_renderer(cam)

    v1, m1, c1 = pipe.fuse(frames)
    out1 = renderer(v1, m1, c1)
    shape1 = v1.shape
    hits1 = int(np.asarray(out1.hit).sum())
    assert hits1 > 50

    pipe.set_voxel_size(0.025)          # 2x finer mid-run
    v2, m2, c2 = pipe.fuse(frames)
    assert v2.shape != shape1
    assert v2.shape == pipe.volume_grid.shape
    out2 = renderer(v2, m2, c2)         # same handle, rebuilt lazily
    hits2 = int(np.asarray(out2.hit).sum())
    assert hits2 > 50

    pipe.set_voxel_size(0.05)           # flip back: cached jits, same shape
    v3, m3, c3 = pipe.fuse(frames)
    assert v3.shape == shape1
    out3 = renderer(v3, m3, c3)
    np.testing.assert_array_equal(np.asarray(out3.hit), np.asarray(out1.hit))


def test_tsdf_limit_swap_without_recompile(setup):
    """tsdf_limit is a traced scalar: set_tsdf_limit() must not retrace
    the stage programs (the reference's slider re-integrates only)."""
    calib, frames = setup
    cfg = PipelineConfig(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02,
                        num_lods=4)
    pipe = TsdfPipeline(calib, cfg, BBOX)
    v1, m1, c1 = pipe.fuse(frames)
    n_traces = pipe._integrate._cache_size()

    pipe.set_tsdf_limit(0.04)
    v2, _, _ = pipe.fuse(frames)
    assert pipe._integrate._cache_size() == n_traces, "limit change retraced"
    # a doubled truncation band genuinely changes the fused field
    assert float(np.abs(np.asarray(v2) - np.asarray(v1)).max()) > 1e-4
    assert float(np.asarray(v2).max()) > float(np.asarray(v1).max()) + 1e-3


def test_processing_toggle_uses_cached_variant(setup):
    """Toggle flips re-trace once per variant, then swap instantly from
    the jit cache (kinect_client.cpp:362-376 re-runs the chain on any
    GUI toggle)."""
    calib, frames = setup
    cfg = PipelineConfig(voxel_size=0.05, brick_size=0.25, tsdf_limit=0.02,
                        num_lods=4)
    pipe = TsdfPipeline(calib, cfg, BBOX)
    _ = pipe.fuse(frames)
    jit_a = pipe._preprocess

    pipe.reconfigure(bilateral=False)
    _ = pipe.fuse(frames)
    assert pipe._preprocess is not jit_a

    pipe.reconfigure(bilateral=True)
    assert pipe._preprocess is jit_a   # cache hit: the original wrapper
    _ = pipe.fuse(frames)


def test_feedback_state_drives_mode_and_camera():
    """A packed FeedbackState round-trips the wire and yields a usable
    camera pose + recon mode switch (kinect_client.cpp:637-673)."""
    from rgbd_recon.io.network import FEEDBACK_BYTES, FeedbackState
    from rgbd_recon.recon.tsdf_pipeline import CamParams

    mat = np.eye(4, dtype=np.float32)
    mat[:3, 3] = (0.5, 1.0, 3.0)
    fb = FeedbackState(cyclops_mat=mat, recon_mode=0, stream_slot=1)
    wire = fb.pack()
    assert len(wire) == FEEDBACK_BYTES
    fb2 = FeedbackState.unpack(wire)
    assert fb2.recon_mode == 0 and fb2.stream_slot == 1
    np.testing.assert_allclose(fb2.cyclops_mat, mat)

    cam = CamParams.from_matrix(fb2.cyclops_mat, BBOX)
    np.testing.assert_allclose(np.asarray(cam.eye_w), (0.5, 1.0, 3.0))
    # eye in volume-normalized coordinates
    np.testing.assert_allclose(
        np.asarray(cam.eye_vol),
        ((0.5 + 1.0) / 2.0, 1.0 / 2.2, (3.0 + 1.0) / 2.0),
        rtol=1e-6,
    )
