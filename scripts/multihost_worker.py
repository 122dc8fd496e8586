"""Multi-host (multi-controller) worker for the jax.distributed proof.

Each process contributes 4 virtual CPU devices to a global 8-device mesh
(2 processes x 4 — the host-spanning layout of BASELINE.md's "N>=2 hosts"
target). All processes build the identical scene, run ONE sharded
brick-compact step over the global mesh, and process 0 writes the gathered
outputs + the measured per-frame collective byte counts for the parent
test to compare against the single-process reference.

Launched by tests/test_multihost.py; runnable by hand:

  python scripts/multihost_worker.py --process-id 0 --num-processes 2 \
      --coordinator 127.0.0.1:12655 --outdir /tmp/mh &
  python scripts/multihost_worker.py --process-id 1 --num-processes 2 \
      --coordinator 127.0.0.1:12655 --outdir /tmp/mh
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="127.0.0.1:12655")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.devices_per_process}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import numpy as np
    from jax.experimental import multihost_utils

    from rgbd_recon.calib.sensors import build_synthetic_calibration
    from rgbd_recon.core.config import PipelineConfig
    from rgbd_recon.core.grid import BoundingBox
    from rgbd_recon.dist import make_mesh, shard_pipeline_step
    from rgbd_recon.ops.raymarch import ViewCamera
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    n_global = args.num_processes * args.devices_per_process
    assert len(jax.devices()) == n_global, (
        f"expected {n_global} global devices, got {len(jax.devices())}"
    )

    # identical scene on every process (deterministic construction) —
    # MUST match tests/test_multihost.py's reference setup
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

    mesh = make_mesh(n_global)
    step = shard_pipeline_step(pipe, camera, mesh)
    volume, out = step(frames)

    vol_np = multihost_utils.process_allgather(volume, tiled=True)
    color_np = multihost_utils.process_allgather(out.color, tiled=True)
    hit_np = multihost_utils.process_allgather(out.hit, tiled=True)

    if args.process_id == 0:
        os.makedirs(args.outdir, exist_ok=True)
        np.save(os.path.join(args.outdir, "volume.npy"), np.asarray(vol_np))
        np.save(os.path.join(args.outdir, "color.npy"), np.asarray(color_np))
        np.save(os.path.join(args.outdir, "hit.npy"), np.asarray(hit_np))
        meta = {
            "processes": args.num_processes,
            "devices_per_process": args.devices_per_process,
            "global_devices": n_global,
            "process_spans": sorted(
                {d.process_index for d in jax.devices()}
            ),
        }
        with open(os.path.join(args.outdir, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(args.outdir, "done"), "w") as f:
            f.write("ok")
    # all processes must stay alive until the collectives complete
    multihost_utils.sync_global_devices("rgbd_multihost_done")


if __name__ == "__main__":
    main()
