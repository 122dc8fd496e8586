"""Sensor-axis sharding of the preprocess chain.

SURVEY.md §2.10's "per-host sensor shards": every preprocessing pass
(morph, bilateral, boundary, normal, quality) is per-sensor independent,
so for rigs with many sensors the chain shards over the SENSOR axis of the
device mesh — each device runs the full 5-pass stencil chain on its
sensors only, then:

  - the sensor maps all_gather back to replicated (the consumers —
    brick-compact integration and the hit-path color blend — gather from
    every sensor's map per voxel/hit, so maps must be device-local
    everywhere; at reference scale the gathered payload is ~7 MB/frame,
    see MULTIHOST.md),
  - the brick counters psum: per-device marking histograms over local
    sensors sum into the global occupancy counters (the distributed form
    of the reference's atomicAdd bus, glsl/inc_bricks.glsl:40-58).

Engages when the sensor count is divisible by the mesh size (typical
multi-host rigs: sensors group by capture host); reference-scale 4-sensor
single-host rigs keep the replicated chain on every device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import bricks as brick_ops
from ..ops.preprocess import SensorMaps, preprocess_frames
from ..ops.sampling import trilinear_3d


def shard_preprocess(pipeline, mesh: Mesh, axis_name: str = "z"):
    """Build a sensor-sharded preprocess: frames -> (SensorMaps, counts).

    Output-identical to ``pipeline.preprocess`` (same kernels on sensor
    slices; all_gather preserves order). Requires num_sensors % mesh size
    == 0.
    """
    cfg = pipeline.config
    calib = pipeline.calib
    N = calib.num_sensors
    Nd = mesh.shape[axis_name]
    if N % Nd != 0:
        raise ValueError(
            f"sensor axis ({N}) must divide the mesh ({Nd}); pad the rig "
            "or use the replicated chain"
        )
    brick_res = pipeline.brick_grid.res
    brick_size = cfg.brick_size
    sp = P(axis_name)

    def local_chain(depths, colors, cv_xyz, cv_uv, depth_limits,
                    camera_positions, pm, bbox_min, bbox_max):
        maps_l = preprocess_frames(
            depths, colors, cv_xyz, cv_uv, bbox_min, bbox_max,
            depth_limits, camera_positions,
            morph=cfg.morph, bilateral=cfg.bilateral and cfg.processed,
            refine=cfg.refine, pixel_models=pm,
        )
        # brick marking on the LOCAL sensors, summed across devices
        # (mirrors TsdfPipeline._mark_bricks semantics incl. mark_stride)
        s = max(int(cfg.mark_stride), 1)
        d_all = maps_l.depth[..., 0]
        if s > 1:
            d_all = d_all[:, s // 2::s, s // 2::s]
        valids = (d_all > 0.0) & (d_all < 1.0)
        if pm is not None:
            ray_a, ray_b = pm.ray_a, pm.ray_b
            if s > 1:
                ray_a = ray_a[:, s // 2::s, s // 2::s]
                ray_b = ray_b[:, s // 2::s, s // 2::s]
            worlds = jnp.stack(
                [ray_a[..., j] + ray_b[..., j] * d_all for j in range(3)],
                axis=-1,
            )
        else:
            H, W = maps_l.depth.shape[1:3]
            u = (jnp.arange(W, dtype=jnp.float32)[s // 2::s] + 0.5) / W
            v = (jnp.arange(H, dtype=jnp.float32)[s // 2::s] + 0.5) / H
            uu, vv = jnp.meshgrid(u, v)
            worlds = jax.vmap(
                lambda cv, d: trilinear_3d(cv, jnp.stack([uu, vv, d], -1))
            )(cv_xyz, d_all)
        counts_l = brick_ops.mark_bricks(
            worlds, valids, bbox_min, brick_size, brick_res
        ) * (s * s)
        counts = jax.lax.psum(counts_l, axis_name)
        # maps back to replicated: every integration/blend consumer
        # gathers from every sensor's map
        maps = jax.tree_util.tree_map(
            lambda a: jax.lax.all_gather(a, axis_name).reshape(
                (-1,) + a.shape[1:]
            ),
            maps_l,
        )
        return maps, counts

    in_sensor = (sp, sp, sp, sp, sp, sp)

    def run(frames):
        pm = pipeline._get_pixel_models(frames.depths.shape[1:3])
        pm_spec = (sp if pm is not None else P(),)
        fn = shard_map(
            local_chain, mesh=mesh,
            in_specs=in_sensor + pm_spec + (P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)(
            frames.depths, frames.colors, calib.cv_xyz, calib.cv_uv,
            calib.depth_limits, calib.camera_positions, pm,
            calib.bbox_min, calib.bbox_max,
        )

    return run
