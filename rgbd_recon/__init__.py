"""rgbd_recon — real-time multi-RGBD reconstruction framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
steppobeck/rgbd-recon (C++/OpenGL): multi-sensor RGBD ingestion,
calibration-volume reprojection, per-sensor depth preprocessing, weighted
TSDF fusion into a bricked volume, raymarched surface extraction with
pull-push hole filling, plus additions (brick-sharded multi-device
distribution, sensor-pose refinement).

Layout (see SURVEY.md §7):
  core/     dtypes, volume/brick grids, camera structs, config + scene files
  calib/    calibration parsing, baked lookup volumes, inversion, frustums
  sensors/  frame sources (synthetic renderer, stream replay), host feed
  ops/      compute kernels (jnp)
  recon/    pipeline assembly (points / tsdf / trigrid strategies)
  dist/     device-mesh sharding, halo exchange, collectives
  refine/   sensor-pose bundle adjustment over depth-to-TSDF residuals
  io/       stream files, config files, native ring buffer bindings
  viz/      offline rendering, debug maps
  bench/    stage-timing harness (TimerDatabase equivalent)
"""

__version__ = "0.1.0"
