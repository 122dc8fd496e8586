#!/usr/bin/env python3
"""End-to-end smoke test of the reconstruction system on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: phases 1-4 below
    python chip_smoke.py --gpus 4   # the z-slab sharded rig on four GPUs,
                                    # against one device (phase 5 only)

Every phase runs at the reference-scale rig (bench.py): 4 sensors with
512x424 depth and 1280x1080 color, calibration volumes at 128x256x128 and
200x220x200, a 2 x 2.2 x 2 m box at 1 cm voxels (200x220x200) with 10 cm
bricks, and a 1280x720 view.

  1. device: the default JAX device must be a GPU; prints the card's name
     and power limit, the JAX version and the compile-cache directory;
  2. CLI: `app record` 3 frames, then `app run` them into 3 PNGs, each of
     which must show surface pixels;
  3. library: TsdfPipeline fuse + render for 3 frames with compile seconds
     per program; analytic-sphere surface RMSE of the fast defaults and of
     the reference-exact mode must stay within one voxel (10 mm);
  4. parity on the card: preprocess against the CPU backend, the pull-push
     hole fill against the NumPy reference (tests/golden_np.py), the
     golden fixture (tests/golden/golden_small.npz), and the Triton
     stencil kernels against the jnp folds;
  5. (--gpus 4 only) dist.shard_pipeline_step over a 4-device mesh against
     the single-device pipeline.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails. The last line of stdout is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# the reference-scale rig (bench.py)
BBOX = ((-1.0, 0.0, -1.0), (1.0, 2.2, 1.0))
DEPTH_SIZE = (512, 424)
COLOR_SIZE = (1280, 1080)
CV_RES = (128, 256, 128)
INV_RES = (200, 220, 200)
VIEW = (1280, 720)
VOXEL, BRICK, TSDF_LIMIT = 0.01, 0.1, 0.01
SPHERE = ((0.0, 1.1, 0.0), 0.55)

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu(min_count=1):
    """The JAX devices, if the default one is a GPU and there are at least
    ``min_count``; otherwise exit 1. Never falls back to the CPU."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"FAIL device: JAX found no usable backend: {e}", file=sys.stderr)
        sys.exit(1)
    if devs[0].platform != "gpu":
        print(f"FAIL device: the default JAX device is {devs[0].platform} "
              f"({devs[0].device_kind}), not a GPU", file=sys.stderr)
        sys.exit(1)
    if len(devs) < min_count:
        print(f"FAIL device: {len(devs)} GPU(s), {min_count} needed",
              file=sys.stderr)
        sys.exit(1)
    return devs


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from its
    monitoring events."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.total += duration


def timed(clock, name, fn):
    """Run ``fn`` to completion; print wall and compile seconds."""
    import jax

    c0, t0 = clock.total, time.perf_counter()
    out = jax.block_until_ready(fn())
    wall = time.perf_counter() - t0
    print(f"  {name}: {wall:.3f} s wall, {clock.total - c0:.3f} s compile",
          flush=True)
    return out


def reference_rig():
    from rgbd_recon.calib import build_synthetic_calibration
    from rgbd_recon.core import BoundingBox
    from rgbd_recon.sensors import default_test_rig

    bbox = BoundingBox(min=BBOX[0], max=BBOX[1])
    rig = default_test_rig(num_sensors=4, depth_size=DEPTH_SIZE,
                           color_size=COLOR_SIZE, bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=CV_RES,
                                        inv_res=INV_RES)
    return bbox, rig, calib


def reference_pipeline(calib, bbox, exact=False):
    """The bench.py configuration; ``exact`` is its reference-exact mode."""
    import dataclasses

    from rgbd_recon.core import PipelineConfig
    from rgbd_recon.recon import TsdfPipeline

    cfg = PipelineConfig(voxel_size=VOXEL, brick_size=BRICK,
                         tsdf_limit=TSDF_LIMIT, num_lods=7)
    if exact:
        cfg = dataclasses.replace(
            cfg, march_mode="trilinear", march_empty_skip=False,
            integrate_taps="bilinear", mark_stride=1,
            projection_model=False, march_dtype="float32",
        )
    return TsdfPipeline(calib, cfg, bbox)


def view_camera():
    from rgbd_recon.ops.raymarch import ViewCamera

    return ViewCamera(width=VIEW[0], height=VIEW[1], eye=(0.0, 1.3, 2.6),
                      target=(0.0, 1.1, 0.0))


def phase_device():
    import jax

    from rgbd_recon.core.cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        print(f"card: {line}")
    d = jax.devices()[0]
    print(f"jax {jax.__version__}: {len(jax.devices())} x {d.device_kind} "
          f"({d.platform})")
    print(f"compile cache: {enable_compile_cache()}")


def phase_cli(workdir, frames=3):
    """`app record` then `app run` at the reference-scale rig."""
    from rgbd_recon.app import main as app_main
    from rgbd_recon.viz import load_image

    rec, out = workdir / "rec", workdir / "out"
    sizes = ["--depth-size", *map(str, DEPTH_SIZE),
             "--color-size", *map(str, COLOR_SIZE)]
    t0 = time.perf_counter()
    app_main(["record", "--out", str(rec), "--frames", str(frames),
              "--sensors", "4", *sizes])
    print(f"  record: {time.perf_counter() - t0:.3f} s", flush=True)
    scene = workdir / "scene.ks"
    scene.write_text(
        "".join(f"kinect s{i}.yml\n" for i in range(4))
        + "bbx {} {} {} {} {} {}\n".format(*BBOX[0], *BBOX[1])
    )
    conf = workdir / "rig.conf"
    conf.write_text(f"voxel_size: {VOXEL}\nbrick_size: {BRICK}\n"
                    f"tsdf_limit: {TSDF_LIMIT}\nrecon_mode: 1\n")
    t0 = time.perf_counter()
    app_main(["run", str(scene), "--conf", str(conf), "--streams", str(rec),
              "--frames", str(frames), "--out", str(out),
              "--width", str(VIEW[0]), "--height", str(VIEW[1]), *sizes])
    print(f"  run: {time.perf_counter() - t0:.3f} s for {frames} frames "
          "(compiles included)", flush=True)
    print("  " + (out / "timings.csv").read_text().strip()
          .replace("\n", "\n  "))
    pngs = sorted(out.glob("frame_*.png"))
    check(len(pngs) == frames, f"app run wrote {len(pngs)} PNGs, "
          f"{frames} expected")
    for p in pngs:
        img = load_image(p)
        n = int((img.max(axis=-1) > 0).sum())
        print(f"  {p.name}: {img.shape[1]}x{img.shape[0]}, {n} surface px")
        check(img.shape[:2] == (VIEW[1], VIEW[0]), f"{p.name}: wrong size")
        check(n > 0, f"{p.name} shows no surface")


def phase_library(clock, calib, bbox, rig, frames=3):
    """TsdfPipeline fuse + render; surface RMSE, fast and exact."""
    from rgbd_recon.bench import sphere_surface_rmse_mm
    from rgbd_recon.sensors import SyntheticScene, render_rig_frames

    fr = render_rig_frames(SyntheticScene(spheres=[SPHERE]), rig)
    camera = view_camera()
    results = {}
    for mode in ("fast", "exact"):
        pipe = reference_pipeline(calib, bbox, exact=(mode == "exact"))
        renderer = pipe.make_renderer(camera)
        print(f" {mode} mode:")
        for i in range(frames):
            maps, counts = timed(clock, f"frame {i} preprocess",
                                 lambda: pipe.preprocess(fr))
            volume = timed(clock, f"frame {i} integrate",
                           lambda: pipe.integrate(maps, counts))
            out = timed(clock, f"frame {i} render",
                        lambda: renderer(volume, maps, counts))
        rmse, n = sphere_surface_rmse_mm(out, camera, *SPHERE)
        overflow = np.asarray(out.overflow).tolist()
        print(f"  surface RMSE {rmse:.4f} mm over {n} hit px; "
              f"overflow {overflow}", flush=True)
        check(n > 0, f"{mode}: no pixel hits the surface")
        check(rmse <= VOXEL * 1000.0, f"{mode}: surface RMSE {rmse:.3f} "
              f"mm > {VOXEL * 1000.0} mm (one voxel)")
        results[mode] = (pipe, fr, volume, maps, counts, out)
    return results


def parity_preprocess(pipe, fr):
    """Preprocess on the GPU against the same program on the CPU backend."""
    import jax

    from rgbd_recon.ops.preprocess import preprocess_frames

    calib = pipe.calib
    pm = pipe._get_pixel_models(fr.depths.shape[1:3])
    args = (fr.depths, fr.colors, calib.cv_xyz, calib.cv_uv, calib.bbox_min,
            calib.bbox_max, calib.depth_limits, calib.camera_positions, pm)

    def run(depths, colors, cv_xyz, cv_uv, bmin, bmax, lim, cams, pm_):
        return preprocess_frames(depths, colors, cv_xyz, cv_uv, bmin, bmax,
                                 lim, cams, pixel_models=pm_)

    f = jax.jit(run)
    g = jax.device_get(f(*args))
    c = jax.device_get(f(*jax.device_put(args, jax.devices("cpu")[0])))
    lim = np.asarray(calib.depth_limits)
    span = (lim[:, 1] - lim[:, 0])[:, None, None]
    same_sil = g.silhouette == c.silhouette
    flags_eq = float((g.depth[..., 1] == c.depth[..., 1]).mean())
    sil_eq = float(same_sil.mean())
    err_m = float((np.abs(g.depth[..., 0] - c.depth[..., 0]) * span)
                  [same_sil].max())
    print(f"  preprocess {tuple(fr.depths.shape)} GPU vs CPU: depth max "
          f"|err| {err_m:.3e} m (tol 1e-5 m: f32 sums in another order); "
          f"silhouette equal {sil_eq:.6f}, refine flags equal {flags_eq:.6f} "
          "(tol >= 0.999: thresholds may flip on last-bit differences)")
    check(err_m <= 1e-5, "preprocess depth differs from the CPU backend")
    check(sil_eq >= 0.999 and flags_eq >= 0.999,
          "preprocess flags differ from the CPU backend")


def parity_kernels(pipe, fr):
    """The Triton-route stencil kernels (ops/stencil_triton.py) against the
    jnp folds, both on the card, at 4 x 424 x 512."""
    import jax
    import jax.numpy as jnp

    from rgbd_recon.ops import preprocess as pp
    from rgbd_recon.ops import stencil_triton

    lim = pipe.calib.depth_limits
    maps, _ = pipe.preprocess(fr)
    d_m, d_n = maps.raw_depth, maps.depth[..., 0]
    pairs = (
        ("bilateral", stencil_triton.bilateral13(d_m, lim),
         jax.jit(jax.vmap(pp.bilateral_sums))(d_m, lim[:, 0], lim[:, 1])),
        ("quality", stencil_triton.quality13(d_n),
         jax.jit(jax.vmap(pp.quality_sums))(d_n)),
    )
    for name, got, want in pairs:
        for g, w in zip(got, want):
            err = float(jnp.max(jnp.abs(g - w) / (1.0 + jnp.abs(w))))
            print(f"  {name}13 kernel {tuple(g.shape)} vs jnp fold: max "
                  f"|err| / (1 + |ref|) {err:.3e} (tol 1e-5: 169-term f32 "
                  "sums, contraction into FMAs may differ)")
            check(err <= 1e-5, f"{name} kernel differs from the jnp fold")


def parity_holefill(seed=0):
    """Pull-push fill at 1280x720 against the NumPy reference: the check
    that catches TF32 in the selection and interpolation matmuls."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO / "tests"))
    import golden_np

    from rgbd_recon.ops import holefill

    W, H = VIEW
    rng = np.random.default_rng(seed)
    valid = rng.random((H, W)) < 0.5
    valid[200:330, 400:700] = False                    # one large hole
    rgba = rng.random((H, W, 4)).astype(np.float32)
    rgba[..., 3] = 1.0
    rgba[~valid] = 0.0
    depth = np.where(valid, rng.uniform(0.2, 0.9, (H, W)), 1.0)
    depth = depth.astype(np.float32)
    f = jax.jit(lambda p, d: holefill.fill_colors_planar(p, d, 7)[0])
    got = np.stack(jax.device_get(
        f([jnp.asarray(rgba[..., i]) for i in range(4)], jnp.asarray(depth))
    ), axis=-1)
    want, _ = golden_np.fill_colors(rgba, depth, 7)
    err = np.abs(got - want).max(axis=-1)
    close = float((err <= 1e-5).mean())
    print(f"  holefill {H}x{W} vs NumPy: {close:.6f} of pixels within 1e-5 "
          f"(tol >= 0.999), max |err| {err.max():.3e} over "
          f"{int((err > 1e-5).sum())} px. Reason: each pull level agrees "
          "to ~1e-7, but last-bit differences flip a few far-side "
          "depth tests; TF32 matmuls would put every filled pixel off "
          "by ~1e-3")
    check(close >= 0.999, "hole fill differs from the NumPy reference")


def parity_golden():
    """The golden fixture's comparisons (tests/test_golden.py), on the GPU."""
    sys.path.insert(0, str(REPO / "scripts"))
    import make_golden

    golden = np.load(make_golden.FIXTURE)
    pipe, frames, _, _ = make_golden.build_scene()
    maps, volume, out = make_golden.run_jax(pipe, frames)
    make_golden.check_maps(golden, maps)
    make_golden.check_volume(golden, volume)
    make_golden.check_render(golden, out)
    print("  golden fixture: maps, volume and render within the "
          "tolerances of tests/test_golden.py")


def phase_sharded(clock, calib, bbox, rig, n_dev=4):
    """z-slab sharded step over n_dev devices against one device."""
    import jax

    from rgbd_recon.dist import make_mesh, shard_pipeline_step
    from rgbd_recon.sensors import SyntheticScene, render_rig_frames

    fr = render_rig_frames(SyntheticScene(spheres=[SPHERE]), rig)
    pipe = reference_pipeline(calib, bbox)
    camera = view_camera()
    renderer = pipe.make_renderer(camera)
    _, ref = timed(clock, "single-device fuse + render", lambda: (
        lambda v, m, c: (v, renderer(v, m, c)))(*pipe.fuse(fr)))
    step = shard_pipeline_step(pipe, camera, make_mesh(n_dev))
    for i in range(2):
        vol_sh, out_sh = timed(clock, f"sharded step {i}", lambda: step(fr))
    for name, a in (("volume", vol_sh), ("color", out_sh.color),
                    ("hit", out_sh.hit), ("depth", out_sh.depth)):
        devs = sorted(d.id for d in a.sharding.device_set)
        print(f"  {name} {tuple(a.shape)}: devices {devs}, "
              f"{len(a.addressable_shards)} shards")
    check(len(vol_sh.sharding.device_set) == n_dev,
          f"volume is not spread over {n_dev} devices")
    h_ref, h_sh = np.asarray(ref.hit), np.asarray(out_sh.hit)
    hit_eq = float((h_ref == h_sh).mean())
    both = h_ref & h_sh
    d_err = float(np.abs(np.asarray(ref.depth) - np.asarray(out_sh.depth))
                  [both].max())
    print(f"  sharded vs single device: hit masks equal {hit_eq:.6f} "
          f"(tol >= 0.999), window depth max |err| {d_err:.3e} on "
          f"{int(both.sum())} common hits (tol 1e-4)")
    check(both.sum() > 0, "no common hits")
    check(hit_eq >= 0.999, "sharded hit mask differs")
    check(d_err <= 1e-4, "sharded window depth differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded-rig phase, on four GPUs")
    args = ap.parse_args(argv)

    # the preprocess parity check compares against the CPU backend
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    devs = require_gpu(args.gpus)
    import jax

    print("== phase 1: device", flush=True)
    phase_device()
    clock = CompileClock()
    t0 = time.perf_counter()
    bbox, rig, calib = reference_rig()
    jax.block_until_ready(calib)
    print(f"reference rig calibration: {time.perf_counter() - t0:.3f} s")

    phases = []
    if args.gpus == 4:
        phases.append(("phase 5: sharded rig on 4 GPUs",
                       lambda: phase_sharded(clock, calib, bbox, rig)))
    else:
        tmp = tempfile.TemporaryDirectory()
        lib = {}
        phases += [
            ("phase 2: CLI record + run",
             lambda: phase_cli(Path(tmp.name))),
            ("phase 3: library fuse + render",
             lambda: lib.update(phase_library(clock, calib, bbox, rig))),
            ("phase 4a: preprocess GPU vs CPU",
             lambda: parity_preprocess(*lib["fast"][:2])),
            ("phase 4b: holefill vs NumPy", parity_holefill),
            ("phase 4c: golden fixture on the GPU", parity_golden),
            ("phase 4d: stencil kernels vs jnp on the card",
             lambda: parity_kernels(*lib["fast"][:2])),
        ]
    failed = []
    for name, fn in phases:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            failed.append(name)
            print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        sys.exit(1)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
