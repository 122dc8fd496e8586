"""Headline benchmark: fused frames/s at 4 sensors (bricked TSDF).

Reference-scale configuration (BASELINE.md):
  4 sensors, 512x424 depth maps, bbox 2 x 2.2 x 2 m, 1 cm voxels
  (200x220x200 = 8.8M), 10 cm bricks, tsdf_limit 0.01, raymarched render
  at 1280x720.

Prints ONE JSON line:
  {"metric": "fused_fps_4sensors", "value": N, "unit": "frames/s",
   "vs_baseline": N, "full_frame_fps": N, "surface_rmse_mm": {...}}
vs_baseline is against the reference's real-time target of 30 fused
frames/s per host (BASELINE.md "Target").

Hygiene (round-3 verdict): every timed loop is preceded by untimed warmup
iterations, the headline numbers carry >= 3 samples each, and the render's
march-volume bake is timed as its own row. surface_rmse_mm fuses a known
analytic sphere at reference scale and reports hit-depth RMSE against the
analytic surface for BOTH the fast defaults and the reference-exact parity
mode (BASELINE.md "tight geometric error parity").

Per-stage breakdown (the reference's timer taxonomy) goes to stderr and
bench_stages.csv.
"""

import json
import os
import subprocess
import sys
import time


def main():
    import jax

    # persistent compilation cache (core/cache.py): reference-scale
    # programs take long to compile, so later processes reuse them
    from rgbd_recon.core.cache import enable_compile_cache

    enable_compile_cache()

    from rgbd_recon.bench import TimerDatabase, sphere_surface_rmse_mm

    sync = jax.block_until_ready
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "unknown"
    print(f"device: {len(jax.devices())} x {dev.device_kind} "
          f"({dev.platform}); card: {card}", file=sys.stderr)

    import dataclasses

    import jax.numpy as jnp

    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.core import BoundingBox, PipelineConfig
    from rgbd_recon.ops.raymarch import ViewCamera
    from rgbd_recon.recon import TsdfPipeline
    from rgbd_recon.sensors import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    fast_only = os.environ.get("RGBD_BENCH_FAST", "") == "1"

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(
        num_sensors=4, depth_size=(512, 424), color_size=(1280, 1080), bbox=bbox
    )
    print("baking calibration volumes...", file=sys.stderr)
    calib = build_synthetic_calibration(
        rig, bbox, cv_res=(128, 256, 128), inv_res=(200, 220, 200)
    )
    # single analytic sphere: the surface-RMSE oracle needs a closed-form
    # ray-surface distance
    SPHERE_C = (0.0, 1.1, 0.0)
    SPHERE_R = 0.55
    scene = SyntheticScene(spheres=[(SPHERE_C, SPHERE_R)])
    print("rendering synthetic frames...", file=sys.stderr)
    frames = render_rig_frames(scene, rig)

    cfg = PipelineConfig(
        voxel_size=0.01, brick_size=0.1, tsdf_limit=0.01, num_lods=7
    )
    pipe = TsdfPipeline(calib, cfg, bbox)
    camera = ViewCamera(width=1280, height=720, eye=(0.0, 1.3, 2.6),
                        target=(0.0, 1.1, 0.0))
    renderer = pipe.make_renderer(camera)

    db = TimerDatabase()

    t0 = time.perf_counter()
    print("compiling fuse...", file=sys.stderr)
    volume, maps, counts = pipe.fuse(frames)
    sync(volume)
    print(f"fuse compiled+ran in {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    print("compiling render...", file=sys.stderr)
    out = renderer(volume, maps, counts)
    sync(out.color)
    print(f"render compiled+ran in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    if os.environ.get("RGBD_BENCH_COMPILE_ONLY", "") == "1":
        # `app warm`: populate the persistent compile cache for the
        # default reference-scale shapes, then exit — a later bench/app
        # process reaches steady state without the minute-scale compiles
        if not fast_only:
            parity_cfg = dataclasses.replace(
                cfg, march_mode="trilinear", march_empty_skip=False,
                integrate_taps="bilinear", mark_stride=1,
                projection_model=False, march_dtype="float32",
            )
            pipe_p = TsdfPipeline(calib, parity_cfg, bbox)
            vp, mp, cp = pipe_p.fuse(frames)
            sync(pipe_p.make_renderer(camera)(vp, mp, cp).color)
        print("compile cache warmed", file=sys.stderr)
        return

    def timed_loop(name, fn, samples=3, iters=10, warmup=2):
        for _ in range(warmup):
            r = fn()
        sync(jax.tree_util.tree_leaves(r)[0])
        for _ in range(samples):
            t0 = time.perf_counter()
            for _ in range(iters):
                r = fn()
            sync(jax.tree_util.tree_leaves(r)[0])
            db.timer(name).add((time.perf_counter() - t0) / iters)

    # fused update (preprocess + bricks + integrate): the headline loop
    timed_loop("2integrate+1preprocess", lambda: pipe.fuse(frames)[0])
    # stage splits (each loop warmed + >=3 samples)
    timed_loop("1preprocess", lambda: pipe.preprocess(frames)[0])
    maps2, counts2 = pipe.preprocess(frames)
    timed_loop("2integrate", lambda: pipe.integrate(maps2, counts2))
    timed_loop("3recon", lambda: renderer(volume, maps, counts).color)

    # per-pass taxonomy inside the chains (the reference's timer names:
    # NetKinectArray.cpp:211-216, recon_integration.cpp:146-148) — each
    # pass timed as its own program, so the numbers carry dispatch overhead
    # the fused chains do not; they expose intra-chain regressions.
    from rgbd_recon.ops import holefill as hf
    from rgbd_recon.ops import preprocess as pp

    pmod = pipe._get_pixel_models(frames.depths.shape[1:3])
    morph_f = jax.jit(jax.vmap(pp.morph_dilate))
    bil_f = jax.jit(lambda d: pp.bilateral_window_sums(d, calib.depth_limits))
    qual_f = jax.jit(pp.quality_window_sums)
    bnd_f = jax.jit(jax.vmap(lambda d, l: pp.boundary(d, l, True)))
    pmt = None
    if pmod is not None:
        pmt = (pmod.ray_a, pmod.ray_b, pmod.uv_p, pmod.uv_q, pmod.uv_r)
    nrm_f = jax.jit(jax.vmap(
        lambda d, pm_: pp.normals(d, None, pixel_model=pm_)))
    mark_f = jax.jit(lambda m: pipe._mark_bricks(calib, pmod, m))
    fill_f = jax.jit(
        lambda c_, d: hf.fill_colors_planar(list(c_), d, cfg.num_lods))
    rgba0 = [jnp.zeros(out.color.shape[:2], jnp.float32) for _ in range(4)]
    dwin0 = jnp.ones(out.color.shape[:2], jnp.float32)
    # the march-volume bake (skip sentinels + surface bricks), timed solo
    render_fn, _cam0 = pipe.make_render_fn(camera)
    bake_f = jax.jit(
        lambda v, cts: render_fn.bake(v, cts, jnp.float32(cfg.tsdf_limit))[0].pairs
    )

    passes = [
        ("morph", lambda: morph_f(frames.depths)),
        ("bilateral", lambda: bil_f(maps.raw_depth)),
        ("boundary", lambda: bnd_f(maps.depth, maps.lab)),
        ("normal", lambda: nrm_f(maps.depth, pmt)),
        ("quality", lambda: qual_f(maps.depth[..., 0])),
        ("brickdraw", lambda: mark_f(maps)),
        ("holefill", lambda: fill_f(rgba0, dwin0)),
        ("bake", lambda: bake_f(volume, counts)),
    ]
    for name, fn in passes:
        sync(jax.tree_util.tree_leaves(fn())[0])
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(10):
                r = fn()
            sync(jax.tree_util.tree_leaves(r)[0])
            db.timer(name).add((time.perf_counter() - t0) / 10)

    # full frame: fuse + render
    def full():
        v, m, ct = pipe.fuse(frames)
        return renderer(v, m, ct).color

    timed_loop("frame", full, samples=3, iters=10)

    # ---- surface-RMSE parity oracle (analytic sphere) -------------------
    def surface_rmse_mm(render_out, cam):
        return sphere_surface_rmse_mm(render_out, cam, SPHERE_C, SPHERE_R)

    rmse = {}
    rmse_fast, n_fast = surface_rmse_mm(out, camera)
    rmse["fast"] = round(rmse_fast, 2)
    print(f"surface RMSE fast: {rmse_fast:.2f} mm over {n_fast} px",
          file=sys.stderr)
    if not fast_only:
        print("compiling reference-exact parity mode for RMSE...",
              file=sys.stderr)
        parity_cfg = dataclasses.replace(
            cfg, march_mode="trilinear", march_empty_skip=False,
            integrate_taps="bilinear", mark_stride=1,
            projection_model=False, march_dtype="float32",
        )
        pipe_p = TsdfPipeline(calib, parity_cfg, bbox)
        vp, mp, cp = pipe_p.fuse(frames)
        outp = pipe_p.make_renderer(camera)(vp, mp, cp)
        sync(outp.color)
        rmse_exact, n_exact = surface_rmse_mm(outp, camera)
        rmse["reference_exact"] = round(rmse_exact, 2)
        print(f"surface RMSE exact: {rmse_exact:.2f} mm over {n_exact} px",
              file=sys.stderr)

    fused_dt = db.timer("2integrate+1preprocess").mean
    fps = 1.0 / fused_dt
    full_fps = 1.0 / db.timer("frame").mean

    print(db.write_csv("bench_stages.csv"), file=sys.stderr)
    print(f"fused fps: {fps:.2f}  full-frame fps (incl. render): {full_fps:.2f}",
          file=sys.stderr)

    print(json.dumps({
        "metric": "fused_fps_4sensors",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "full_frame_fps": round(full_fps, 3),
        "surface_rmse_mm": rmse,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
