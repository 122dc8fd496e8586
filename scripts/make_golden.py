"""Generate the committed golden full-pipeline fixture.

Builds the small deterministic scene, runs the JAX preprocess chain (whose
passes are individually oracle-tested in tests/test_preprocess.py), then
runs the INDEPENDENT NumPy pipeline (tests/golden_np.py: integrate ->
dense trilinear march -> secant -> blendColors -> window depth ->
pull-push) on the preprocessed maps and stores inputs + NumPy outputs in
tests/golden/golden_small.npz. tests/test_golden.py regression-tests the
JAX exact-parity pipeline against this fixture.

Run (CPU): python scripts/make_golden.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np


# single source of truth for the fixture's scene + camera + config
SCENE = dict(
    num_sensors=2, depth_size=(48, 40), color_size=(64, 48),
    cv_res=(16, 24, 16), inv_res=(32, 36, 32),
    voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02, num_lods=4,
    width=48, height=40, eye=(0.0, 1.3, 2.6), target=(0.0, 1.1, 0.0),
    fov_y=50.0, near=0.1, far=20.0,
)


def build_scene():
    """The fixture's pipeline, frames, bbox and calibration, built on the
    default JAX backend (the CPU when generating the fixture; the GPU when
    chip_smoke.py checks the card against it)."""
    from rgbd_recon.calib.sensors import build_synthetic_calibration
    from rgbd_recon.core.config import PipelineConfig
    from rgbd_recon.core.grid import BoundingBox
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    s = SCENE
    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(
        num_sensors=s["num_sensors"], depth_size=s["depth_size"],
        color_size=s["color_size"], bbox=bbox,
    )
    calib = build_synthetic_calibration(
        rig, bbox, cv_res=s["cv_res"], inv_res=s["inv_res"]
    )
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    # exact-parity configuration: trilinear march, no space skipping, no
    # bricking (dense integrate), volume-lookup blending
    cfg = PipelineConfig(
        voxel_size=s["voxel_size"], brick_size=s["brick_size"],
        tsdf_limit=s["tsdf_limit"], num_lods=s["num_lods"],
        bricking=False, skip_space=False, march_mode="trilinear",
        march_empty_skip=False, integrate_taps="bilinear",
        projection_model=False, march_dtype="float32", mark_stride=1,
    )
    pipe = TsdfPipeline(calib, cfg, bbox)
    return pipe, frames, bbox, calib


FIXTURE = os.path.join(REPO, "tests", "golden", "golden_small.npz")


def run_jax(pipe, frames):
    """(maps, volume, render output) of the fixture's scene through the
    JAX exact-parity pipeline."""
    from rgbd_recon.ops.raymarch import ViewCamera

    s = SCENE
    maps, counts = pipe.preprocess(frames)
    volume = pipe.integrate(maps, counts)
    camera = ViewCamera(
        width=s["width"], height=s["height"], eye=s["eye"],
        target=s["target"], fov_y=s["fov_y"], near=s["near"], far=s["far"],
    )
    out = pipe.make_renderer(camera)(volume, maps, counts)
    return maps, volume, out


def check_maps(golden, maps):
    """The fixture's stored inputs must equal the current preprocess
    output — otherwise the comparisons below compare different frames."""
    np.testing.assert_allclose(
        np.asarray(maps.depth[..., 0]), golden["maps_depth"],
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(maps.quality), golden["maps_quality"],
        rtol=1e-4, atol=1e-6,
    )


def check_volume(golden, volume):
    np.testing.assert_allclose(
        np.asarray(volume), golden["volume"], rtol=1e-4, atol=1e-6
    )


def check_render(golden, out):
    hit_j = np.asarray(out.hit)
    hit_n = golden["hit"]
    # hit masks must agree except at most a couple of knife-edge pixels
    assert (hit_j != hit_n).sum() <= max(2, int(0.02 * hit_n.sum())), (
        int(hit_j.sum()), int(hit_n.sum()))
    both = hit_j & hit_n
    np.testing.assert_allclose(
        np.asarray(out.depth)[both], golden["depth"][both],
        rtol=0, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(out.color)[both], golden["color"][both],
        rtol=0, atol=1e-3,
    )


def main():
    import golden_np

    pipe, frames, bbox, calib = build_scene()
    s = SCENE
    maps, counts = pipe.preprocess(frames)

    maps_np = {
        "depth": np.asarray(maps.depth[..., 0]),
        "quality": np.asarray(maps.quality),
        "silhouette": np.asarray(maps.silhouette),
        "color": np.asarray(maps.color),
    }

    vol_np = golden_np.integrate(
        pipe.volume_grid.shape, np.asarray(calib.cv_xyz_inv),
        maps_np["depth"], maps_np["quality"], maps_np["silhouette"],
        s["tsdf_limit"],
    )
    max_steps = int(np.ceil(np.sqrt(3.0) / (s["tsdf_limit"] * 0.5)))
    color, depth, hit, _g = golden_np.render(
        vol_np, maps_np["color"], maps_np["depth"], maps_np["quality"],
        np.asarray(calib.cv_xyz_inv), np.asarray(calib.cv_uv),
        np.asarray(bbox.min), np.asarray(bbox.max),
        s["width"], s["height"], s["eye"], s["target"], s["fov_y"],
        s["near"], s["far"], s["tsdf_limit"], s["num_lods"], max_steps,
    )

    path = FIXTURE
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        volume=vol_np, color=color, depth=depth, hit=hit,
        maps_depth=maps_np["depth"], maps_quality=maps_np["quality"],
        maps_silhouette=maps_np["silhouette"], maps_color=maps_np["color"],
    )
    print(f"wrote {path}: volume {vol_np.shape}, "
          f"hit px {int(hit.sum())}, "
          f"{os.path.getsize(path) / 1e6:.2f} MB")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
