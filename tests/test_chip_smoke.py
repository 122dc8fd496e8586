"""chip_smoke.py, the end-to-end check on the GPU: its device gate runs
here; its card-only checks are GPU-marked and skip on the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code == 1
    assert "not a GPU" in capsys.readouterr().err


@pytest.mark.parametrize("args", [[], ["--gpus", "4"]])
def test_smoke_without_gpu_exits_nonzero_with_no_result(tmp_path, args):
    """Alone in a directory and on the CPU, the script fails before any
    phase and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_golden_fixture_on_gpu(gpu_device):
    import jax

    with jax.default_device(gpu_device):
        chip_smoke.parity_golden()


@pytest.mark.gpu
def test_preprocess_gpu_matches_cpu(gpu_device):
    import jax

    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.core import BoundingBox, PipelineConfig
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    with jax.default_device(gpu_device):
        bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
        rig = default_test_rig(num_sensors=4, depth_size=(128, 106),
                               color_size=(160, 128), bbox=bbox)
        calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                            inv_res=(40, 44, 40))
        frames = render_rig_frames(
            SyntheticScene(spheres=[chip_smoke.SPHERE]), rig)
        pipe = TsdfPipeline(calib, PipelineConfig(voxel_size=0.05,
                                                  brick_size=0.25), bbox)
        chip_smoke.parity_preprocess(pipe, frames)
        assert np.isfinite(np.asarray(pipe.preprocess(frames)[0].depth)).all()
