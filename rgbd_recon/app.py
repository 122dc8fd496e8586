"""Application shell — the kinect_client / calib_inverter equivalents.

Headless CLI (the reference's GLFW/ImGui viewer becomes offline rendering +
CSV instrumentation; SURVEY.md §7.7):

  python -m rgbd_recon.app run scene.ks --conf settings.conf \
      [--streams recordings/] [--frames N] [--out out/]
        -> reconstruction loop: stream/synthetic frames -> TSDF fusion ->
           raymarched PNGs + stage-timing CSV (time_limit honored)

  python -m rgbd_recon.app invert scene.ks --voxel-size 0.01 --out dir/
        -> offline inverse-calibration baking (calib_inverter.cpp:12-75)

  python -m rgbd_recon.app record --out dir/ --frames N
        -> synthesize a test scene into reference-format .stream files

CLI flags follow the reference's CMDParser style where they map
(framework/io/CMDParser.cpp; kinect_client.cpp:870-885).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _load_scene(ks_path, conf_path=None):
    from .core.config import PipelineConfig, parse_conf, parse_ks

    scene = parse_ks(ks_path)
    config = PipelineConfig()
    if conf_path:
        config = PipelineConfig.from_conf(parse_conf(Path(conf_path).read_text()))
    return scene, config


def _build_calibration(scene, cv_res=(128, 256, 128), inv_res=None,
                       voxel_size=0.01, depth_size=(128, 106),
                       color_size=(160, 128)):
    """Build a CalibrationSet from the scene's .yml files (analytic bake) or
    from pre-baked .cv_xyz/.cv_uv/.cv_xyz_inv volumes when present."""
    from .calib.kinect_yml import parse_kinect_yml
    from .calib.sensors import build_synthetic_calibration
    from .calib.volume_io import read_calibration_volume
    from .core.camera import SensorRig

    base = Path(scene.base_dir)
    baked = []
    sensors = []
    missing = []
    for name in scene.calib_files:
        yml = base / name
        stem = yml.with_suffix("")
        cvx, cvu, cvi = (
            Path(str(stem) + ".cv_xyz"),
            Path(str(stem) + ".cv_uv"),
            Path(str(stem) + ".cv_xyz_inv"),
        )
        if cvx.exists() and cvu.exists() and cvi.exists():
            baked.append((cvx, cvu, cvi))
        elif yml.exists():
            sensors.append(parse_kinect_yml(yml).to_rgbd_sensor())
        else:
            missing.append(name)

    if missing and not (baked or sensors):
        # self-contained demo mode: no calibration data on disk -> build a
        # synthetic rig matching the scene's sensor count
        from .sensors.synthetic import default_test_rig

        print(
            f"warning: no calibration files found for {missing}; using a "
            "synthetic rig", file=sys.stderr,
        )
        rig = default_test_rig(num_sensors=len(missing), bbox=scene.bbox,
                               depth_size=tuple(depth_size),
                               color_size=tuple(color_size))
        sensors = list(rig.sensors)
    elif missing:
        raise FileNotFoundError(f"no calibration for {missing}")

    if baked and not sensors:
        import jax.numpy as jnp

        from .calib.frustum import frustum_from_cv_xyz
        from .calib.sensors import CalibrationSet

        xs, us, invs, lims, cams = [], [], [], [], []
        for cvx, cvu, cvi in baked:
            vx, lim = read_calibration_volume(cvx, channels=3)
            vu, _ = read_calibration_volume(cvu, channels=2)
            vi, _ = read_calibration_volume(cvi, channels=4)
            xs.append(vx)
            us.append(vu)
            invs.append(vi)
            lims.append(lim)
            cams.append(frustum_from_cv_xyz(vx).camera_position())
        return CalibrationSet(
            cv_xyz=jnp.asarray(np.stack(xs)),
            cv_uv=jnp.asarray(np.stack(us)),
            cv_xyz_inv=jnp.asarray(np.stack(invs)),
            depth_limits=jnp.asarray(np.array(lims, np.float32)),
            camera_positions=jnp.asarray(np.stack(cams)),
            bbox_min=jnp.asarray(np.array(scene.bbox.min, np.float32)),
            bbox_max=jnp.asarray(np.array(scene.bbox.max, np.float32)),
        )

    if sensors:
        rig = SensorRig(sensors=tuple(sensors))
        if inv_res is None:
            size = scene.bbox.size
            inv_res = tuple(int(np.ceil(s / voxel_size)) for s in size)
        return build_synthetic_calibration(rig, scene.bbox, cv_res, inv_res)
    raise ValueError("scene has no usable calibrations")


def cmd_run(args):
    import jax

    from .bench import TimerDatabase
    from .ops.raymarch import ViewCamera
    from .recon import (
        CalibVisPipeline,
        MvtPipeline,
        PointsPipeline,
        TrigridPipeline,
        TsdfPipeline,
    )
    from .sensors.frames import FrameSet
    from .viz.stereo import StereoCamera, make_stereo_renderer

    scene, config = _load_scene(args.scene, args.conf)
    if args.mode is not None:
        config.recon_mode = args.mode
    calib = _build_calibration(
        scene, inv_res=args.inv_res, voxel_size=config.voxel_size,
        depth_size=tuple(args.depth_size), color_size=tuple(args.color_size),
    )
    num_sensors = calib.num_sensors
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    pipe = TsdfPipeline(calib, config, scene.bbox)
    center = scene.bbox.center
    camera = ViewCamera(
        width=args.width, height=args.height,
        eye=(center[0], center[1] + 0.2, center[2] + 2.6),
        target=tuple(center.tolist()),
    )
    if args.stereo != "mono":
        # anaglyph / side-by-side output (kinect_client.cpp:612-673)
        renderer = make_stereo_renderer(
            pipe.make_renderer, StereoCamera(cyclops=camera), mode=args.stereo
        )

        def _tsdf_render(volume, maps, counts, cam_pose=None):
            return renderer(volume, maps, counts), None
    else:
        _renderer = pipe.make_renderer(camera)

        def _tsdf_render(volume, maps, counts, cam_pose=None):
            out = _renderer(volume, maps, counts, camera_pose=cam_pose)
            return out.color, out
    points_renderer = PointsPipeline(calib, config).make_renderer(camera)
    trigrid_renderer = TrigridPipeline(calib, config).make_renderer(camera)
    mvt_renderer = MvtPipeline(calib, config).make_renderer(camera)
    calibvis_renderer = CalibVisPipeline(
        pipe.volume_grid, config.tsdf_limit
    ).make_renderer(camera)

    # checkpoint/resume (io/checkpoint.py — a capability the reference lacks)
    ckpt_mgr = None
    if args.checkpoint_dir:
        from .io.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(args.checkpoint_dir)

    # frame source: ZMQ stream, .stream replay, or synthetic fallback —
    # all pumped through FrameFeed so host decode overlaps the device step
    # (the reference's recv-thread + double-PBO overlap,
    # NetKinectArray.cpp:226-238 + double_pixel_buffer.cpp). Live network
    # sources drop to the latest frame (HWM=1); replay/synthetic sources
    # deliver every frame in order (the reference only drops on the live
    # path — round-3 advisor finding).
    from .io.feed import FrameFeed
    from .io.stream import RAW, FrameCompression

    # PER-SENSOR wire encodings, like the reference sizing each sensor's
    # buffers from its own calibration's isCompressedRGB/Depth flags
    # (NetKinectArray.cpp:120-144); --stream-compression overrides all
    if args.stream_compression != "raw" or args.stream_depth_u8:
        override = FrameCompression(
            rgb={"raw": 0, "dxt1": 1, "dxt5": 5}[args.stream_compression],
            depth_u8=args.stream_depth_u8,
        )
        compressions = [override] * num_sensors
    else:
        from .calib.kinect_yml import parse_kinect_yml

        base = Path(scene.base_dir)
        compressions = []
        for name in scene.calib_files:
            yml = base / name
            comp = RAW
            if yml.exists():
                cal = parse_kinect_yml(yml)
                if cal.compressed_rgb or cal.compressed_depth:
                    comp = FrameCompression.from_calibration(cal)
                    print(f"wire compression from {name}: {comp}",
                          file=sys.stderr)
            compressions.append(comp)
        compressions += [RAW] * (num_sensors - len(compressions))

    zmq_source = None
    feed_mode = "ordered"
    if args.zmq:
        from .io.network import ZmqFrameSource

        feed_mode = "latest"
        zmq_source = ZmqFrameSource(
            args.zmq, num_sensors, depth_size=tuple(args.depth_size),
            color_size=tuple(args.color_size), endpoint_slave=args.zmq_slave,
            compression=compressions,
        )
        source = zmq_source.latest
    elif args.streams:
        # stream sizes must match --depth-size/--color-size. All wire
        # encodings (raw / DXT1 / DXT5 color, f32 / u8 depth) replay
        # through the native GIL-free reader (native/framering.cpp) when
        # it builds: wire bytes pump off-GIL, the consumer decodes
        # (the reference's recv-side split, NetKinectArray.cpp:511-542).
        from .io import native as native_io
        from .io.stream import StreamReader

        use_native = (
            not args.no_native_ingest
            and native_io.available()
        )
        readers = []
        sdirs = sorted(Path(args.streams).glob("*.stream"))
        if len(sdirs) < num_sensors:
            raise FileNotFoundError(
                f"need {num_sensors} .stream files in {args.streams}"
            )
        for i, p in enumerate(sdirs[:num_sensors]):
            if use_native:
                readers.append(native_io.NativeStreamReader(
                    p, depth_size=tuple(args.depth_size),
                    color_size=tuple(args.color_size),
                    compression=compressions[i],
                ))
            else:
                readers.append(
                    StreamReader(p, depth_size=tuple(args.depth_size),
                                 color_size=tuple(args.color_size),
                                 compression=compressions[i])
                )
        if use_native:
            print("replay through native framering", file=sys.stderr)
        clock = [0.0]

        def source():
            colors, depths = [], []
            for r in readers:
                c, d = r.read_frame()
                colors.append(c)
                depths.append(d)
            ts = clock[0]
            clock[0] += 1.0 / 30.0
            return ts, np.stack(colors), np.stack(depths)
    else:
        from .sensors.synthetic import (
            SyntheticScene, default_test_rig, render_rig_frames,
        )

        rig = default_test_rig(
            num_sensors=num_sensors,
            depth_size=tuple(args.depth_size),
            color_size=tuple(args.color_size),
            bbox=scene.bbox,
        )
        clock = [0.0]

        def source():
            t = clock[0]
            clock[0] += 1.0 / 30.0
            sc = SyntheticScene(
                spheres=[((0.25 * np.sin(t), 1.1, 0.25 * np.cos(t)), 0.55)]
            )
            fr = render_rig_frames(sc, rig, t)
            return t, np.asarray(fr.colors), np.asarray(fr.depths)

    feed = FrameFeed(source, mode=feed_mode)

    # control plane: remote feedback channel driving recon_mode, the
    # stream slot, and the render-camera pose live (the reference's
    # FeedbackReceiver + kinect_client.cpp:637-673 side-by-side driver)
    fbr = None
    if args.feedback:
        from .io.network import FeedbackReceiver

        fbr = FeedbackReceiver(args.feedback)
        print(f"feedback channel on {args.feedback}", file=sys.stderr)

    db = TimerDatabase()
    import jax.numpy as jnp

    start = time.time()
    preview = None
    if getattr(args, "preview_port", 0):
        from .viz.preview import PreviewServer

        preview = PreviewServer(port=args.preview_port)
        print(f"live preview: http://localhost:{preview.port}/",
              file=sys.stderr)

    n_done = 0
    start_frame = 0
    if ckpt_mgr is not None and args.resume:
        resumed = ckpt_mgr.latest()
        if resumed is not None:
            start_frame = resumed.frame_index
            print(f"resuming at frame {start_frame}", file=sys.stderr)

    while True:
        if args.frames and n_done >= args.frames:
            break
        if config.time_limit and time.time() - start > config.time_limit:
            break
        # first frame may wait on the source's cold compile (synthetic
        # renderer / stream decode warmup)
        frames = feed.get(timeout=120.0 if n_done == 0 else 10.0)
        if frames is None:
            print("frame source idle; stopping", file=sys.stderr)
            break
        ts = float(np.asarray(frames.timestamp))

        # live control: mode / stream-slot / camera pose from the feedback
        # channel (the reference applies these inside its draw loop,
        # kinect_client.cpp:637-673; NetKinectArray.cpp:766-771)
        cam_pose = None
        if fbr is not None and fbr.seq > 0:
            fb = fbr.get()
            if int(fb.recon_mode) != config.recon_mode:
                print(f"feedback: recon_mode -> {int(fb.recon_mode)}",
                      file=sys.stderr)
            config.recon_mode = int(fb.recon_mode)
            if zmq_source is not None:
                zmq_source.stream_slot = int(fb.stream_slot) % 2
            from .recon.tsdf_pipeline import CamParams

            cam_pose = CamParams.from_matrix(fb.cyclops_mat, scene.bbox)

        render_out = None
        with db.time("1preprocess+2integrate"):
            volume, maps, counts = pipe.fuse(frames)
            jax.block_until_ready(volume)
        with db.time("3recon"):
            if config.recon_mode == 0:
                img, _, _ = points_renderer(maps)
            elif config.recon_mode == 2:
                img, _, _ = trigrid_renderer(maps)
            elif config.recon_mode == 3:
                img, _, _ = mvt_renderer(maps)
            elif config.recon_mode == 4:
                img, _, _ = calibvis_renderer(volume)
            else:
                img, render_out = _tsdf_render(
                    volume, maps, counts, cam_pose
                )
            jax.block_until_ready(img)
        if args.save_renders:
            from .viz import save_image

            save_image(out_dir / f"frame_{n_done:04d}.png", np.asarray(img))
        if preview is not None:
            # live MJPEG preview (the reference's viewer window,
            # kinect_client.cpp:583-716, as a browser stream)
            preview.update(np.asarray(img))
        n_done += 1
        if ckpt_mgr is not None and n_done % args.checkpoint_every == 0:
            from .io.checkpoint import ReconCheckpoint, config_to_json

            ckpt_mgr.save(ReconCheckpoint(
                volume=np.asarray(volume),
                brick_counts=np.asarray(counts),
                frame_index=start_frame + n_done,
                timestamp=float(ts),
                config_json=config_to_json(config),
            ))
        if (args.refine_every and config.recon_mode == 1
                and n_done % args.refine_every == args.refine_every - 1):
            # sensor-pose drift correction: estimate 6-DoF corrections
            # against the leave-one-out consensus and fold them into the
            # calibration for all subsequent frames
            poses, _ = pipe.refine_sensor_poses(maps, counts)
            norms = np.linalg.norm(np.asarray(poses)[:, 3:], axis=1)
            print(
                f"refined sensor poses; translation corrections (mm): "
                f"{np.round(norms * 1000, 2)}", file=sys.stderr,
            )
        if n_done % 10 == 1 and config.recon_mode == 1:
            # capacity-overflow observability: warn the moment a fixed
            # capacity drops geometry OR pixels (round-2/3 advisor
            # findings) — includes the render-side block/ray/hit counters
            diag = pipe.diagnostics(counts, render_out)
            if diag.get("bricks_dropped", 0):
                print(
                    f"WARNING: {diag['bricks_dropped']} occupied bricks "
                    f"beyond brick_capacity={diag['brick_capacity']} were "
                    "dropped — raise PipelineConfig.brick_capacity",
                    file=sys.stderr,
                )
            for key, knob in (
                ("blocks_dropped", "ray_compaction"),
                ("phase2_rays_dropped", "march tail capacity"),
                ("hits_dropped", "hit_compaction"),
                ("oct_bricks_dropped", "brick_capacity (oct table)"),
            ):
                if diag.get(key, 0):
                    print(
                        f"WARNING: {diag[key]} {key} this frame — raise "
                        f"PipelineConfig.{knob}", file=sys.stderr,
                    )
        print(f"frame {n_done} t={ts:.2f}", file=sys.stderr)

    produced = feed.frames_produced
    feed.close()
    if zmq_source is not None:
        zmq_source.close()
    if fbr is not None:
        fbr.close()
    csv_text = db.write_csv(out_dir / "timings.csv")
    print(csv_text, file=sys.stderr)
    if feed_mode == "latest":
        dropped = max(0, produced - n_done)
        print(
            f"processed {n_done} frames ({dropped} dropped to keep latest) "
            f"-> {out_dir}"
        )
    else:
        print(f"processed {n_done} frames (in order) -> {out_dir}")


def cmd_invert(args):
    """Offline inverse-calibration baking (source/calib_inverter.cpp)."""
    from .calib.inverter import invert_calibration_knn
    from .calib.volume_io import read_calibration_volume, write_calibration_volume
    from .core.config import parse_ks

    scene = parse_ks(args.scene)
    base = Path(scene.base_dir)
    size = scene.bbox.size
    res = tuple(int(np.ceil(s / args.voxel_size)) for s in size)
    out_dir = Path(args.out or base)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in scene.calib_files:
        stem = (base / name).with_suffix("")
        cv_path = Path(str(stem) + ".cv_xyz")
        vol, limits = read_calibration_volume(cv_path, channels=3)
        print(f"inverting {cv_path} at res {res}", file=sys.stderr)
        inv = invert_calibration_knn(vol, scene.bbox, res)
        out_path = out_dir / (cv_path.name + "_inv")
        write_calibration_volume(out_path, inv, limits)
        print(f"wrote {out_path}")


def cmd_warm(args):
    """Run bench.py in compile-only mode: identical HLO by construction,
    so the persistent cache entries it creates are the ones bench/app hit.

    One process per card: a JAX process reserves most of the GPU's memory
    when it first touches it, so this parent must not initialise a device
    before the child runs. main() only sets the cache config, which
    creates no backend; keep it that way."""
    import os
    import subprocess

    bench_py = Path(__file__).resolve().parent.parent / "bench.py"
    env = dict(os.environ, RGBD_BENCH_COMPILE_ONLY="1")
    subprocess.run([sys.executable, str(bench_py)], env=env, check=True)


def cmd_record(args):
    """Synthesize a moving-sphere sequence into .stream files."""
    from .core.grid import BoundingBox
    from .io.stream import StreamWriter
    from .sensors.synthetic import SyntheticScene, default_test_rig, render_rig_frames

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(
        num_sensors=args.sensors,
        depth_size=tuple(args.depth_size), color_size=tuple(args.color_size),
        bbox=bbox,
    )
    from .io.stream import FrameCompression

    compression = FrameCompression(
        rgb={"raw": 0, "dxt1": 1, "dxt5": 5}[args.compress],
        depth_u8=args.compress_depth_u8,
        near=rig.sensors[0].depth.near, far=rig.sensors[0].depth.far,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    writers = [
        StreamWriter(out / f"{s.serial or f'sensor{i}'}.stream",
                     compression=compression)
        for i, s in enumerate(rig.sensors)
    ]
    for f in range(args.frames):
        t = f / 30.0
        scene = SyntheticScene(
            spheres=[((0.25 * np.sin(t), 1.1, 0.25 * np.cos(t)), 0.55)]
        )
        fr = render_rig_frames(scene, rig, t)
        for i, w in enumerate(writers):
            w.write_frame(np.asarray(fr.colors[i]), np.asarray(fr.depths[i]))
        print(f"recorded frame {f}", file=sys.stderr)
    for w in writers:
        w.close()
    print(f"wrote {len(writers)} stream files x {args.frames} frames -> {out}")


def main(argv=None):
    from .core.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="rgbd_recon")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="reconstruction loop")
    pr.add_argument("scene", help=".ks scene file")
    pr.add_argument("--conf", help=".conf settings file")
    pr.add_argument("--streams", help="directory of .stream recordings")
    pr.add_argument("--zmq", default=None,
                    help="ZMQ SUB endpoint for live frames, e.g. "
                         "tcp://127.0.0.1:7000 (master)")
    pr.add_argument("--zmq-slave", default=None,
                    help="secondary ZMQ endpoint (stream-slot switch)")
    pr.add_argument("--feedback", default=None,
                    help="ZMQ SUB endpoint of the feedback control channel "
                         "(drives recon_mode / stream slot / camera pose "
                         "live, like the reference's FeedbackReceiver)")
    pr.add_argument("--no-native-ingest", action="store_true",
                    help="force the pure-Python .stream reader even when "
                         "the native framering library builds")
    pr.add_argument("--stream-compression", default="raw",
                    choices=["raw", "dxt1", "dxt5"],
                    help="wire color encoding of --streams/--zmq frames")
    pr.add_argument("--stream-depth-u8", action="store_true",
                    help="wire depth is uint8 sqrt-compressed")
    pr.add_argument("--refine-every", type=int, default=0,
                    help="run sensor-pose refinement every N frames and "
                         "apply the corrections (0 = off)")
    pr.add_argument("--frames", type=int, default=10)
    pr.add_argument("--mode", type=int, default=None,
                    help="recon mode override (0 points, 1 tsdf, 2 trigrid, "
                         "3 mvt, 4 calib vis)")
    pr.add_argument("--stereo", default="mono",
                    choices=["mono", "anaglyph", "side-by-side"],
                    help="stereo output mode (tsdf mode only)")
    pr.add_argument("--checkpoint-dir", default=None,
                    help="enable rotating checkpoints in this directory")
    pr.add_argument("--checkpoint-every", type=int, default=10)
    pr.add_argument("--resume", action="store_true",
                    help="resume frame cursor from the latest checkpoint")
    pr.add_argument("--preview-port", type=int, default=0,
                    help="serve a live MJPEG preview of the render on "
                         "http://<host>:PORT/ (0 = off)")
    pr.add_argument("--out", default="out")
    pr.add_argument("--width", type=int, default=640)
    pr.add_argument("--height", type=int, default=360)
    pr.add_argument("--depth-size", type=int, nargs=2, default=(128, 106))
    pr.add_argument("--color-size", type=int, nargs=2, default=(160, 128))
    pr.add_argument("--inv-res", type=int, nargs=3, default=None)
    pr.add_argument("--save-renders", action="store_true", default=True)
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("invert", help="bake inverse calibration volumes")
    pi.add_argument("scene", help=".ks scene file")
    pi.add_argument("--voxel-size", type=float, default=0.01)
    pi.add_argument("--out")
    pi.set_defaults(fn=cmd_invert)

    pw = sub.add_parser(
        "warm",
        help="pre-compile the default reference-scale programs into the "
             "persistent XLA cache (bench/app then start in seconds)",
    )
    pw.set_defaults(fn=cmd_warm)

    pc = sub.add_parser("record", help="synthesize .stream recordings")
    pc.add_argument("--out", default="recordings")
    pc.add_argument("--frames", type=int, default=30)
    pc.add_argument("--sensors", type=int, default=4)
    pc.add_argument("--depth-size", type=int, nargs=2, default=(128, 106))
    pc.add_argument("--color-size", type=int, nargs=2, default=(160, 128))
    pc.add_argument("--compress", default="raw",
                    choices=["raw", "dxt1", "dxt5"],
                    help="color wire encoding of the recorded streams")
    pc.add_argument("--compress-depth-u8", action="store_true",
                    help="record uint8 sqrt-compressed depth")
    pc.set_defaults(fn=cmd_record)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
