"""Multi-host (multi-controller) distribution proof: two PROCESSES, each
with 4 virtual CPU devices, run the brick-compact sharded step over one
global 2x4-process-spanning mesh via jax.distributed — the host-crossing
layout of BASELINE.md's "N>=2 hosts" target — and must reproduce the
single-process result.

The workers live in scripts/multihost_worker.py (also runnable by hand);
this test launches them, then computes the single-process reference with
the SAME scene and compares. The reference comms inventory this replaces
is the reference app's single-process ZMQ fan-in
(framework/NetKinectArray.cpp:484-544); here the fan-in
becomes jax collectives over the process-spanning mesh.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_step_matches_single(tmp_path):
    port = _free_port()
    outdir = str(tmp_path / "mh")
    env = dict(os.environ)
    # the workers pin their own platform/device-count; scrub the parent
    # test session's XLA flags so they don't double-apply
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER,
             "--process-id", str(i), "--num-processes", "2",
             "--coordinator", f"127.0.0.1:{port}", "--outdir", outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    deadline = time.time() + 800
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(5, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    assert os.path.exists(os.path.join(outdir, "done")), outs[0][-2000:]

    import json

    meta = json.load(open(os.path.join(outdir, "meta.json")))
    assert meta["processes"] == 2
    assert meta["global_devices"] == 8
    assert meta["process_spans"] == [0, 1], (
        "mesh must span both processes"
    )

    vol_mh = np.load(os.path.join(outdir, "volume.npy"))
    color_mh = np.load(os.path.join(outdir, "color.npy"))
    hit_mh = np.load(os.path.join(outdir, "hit.npy"))

    # single-process reference with the SAME scene (this test session runs
    # on the 8-virtual-device CPU backend via conftest)
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

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(
        num_sensors=2, depth_size=(48, 40), color_size=(64, 48), bbox=bbox
    )
    calib = build_synthetic_calibration(
        rig, bbox, cv_res=(16, 24, 16), inv_res=(32, 36, 32)
    )
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig
    )
    cfg = PipelineConfig(
        voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02,
        integrate_taps="bilinear", skip_fine_rounds=3, num_lods=4,
    )
    pipe = TsdfPipeline(calib, cfg, bbox)
    camera = ViewCamera(width=48, height=32, eye=(0.0, 1.3, 2.6),
                        target=(0.0, 1.1, 0.0))
    volume_ref, maps_ref, counts_ref = pipe.fuse(frames)
    out_ref = pipe.make_renderer(camera)(volume_ref, maps_ref, counts_ref)

    np.testing.assert_allclose(
        vol_mh, np.asarray(volume_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        color_mh, np.asarray(out_ref.color), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(hit_mh, np.asarray(out_ref.hit))
