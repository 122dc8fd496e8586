"""Point-cloud reconstruction (mode 0) — one splat per depth pixel.

Re-design of ReconPoints (framework/reconstruction/recon_points.cpp +
glsl/points.{vs,gs,fs}) as a z-buffered scatter renderer:

  VS  (points.vs:22-35)  world pos / color texcoord via cv_xyz / cv_uv
  GS  (points.gs:35-61)  cull invalid depth + out-of-bbox; distance-scaled
                         point size (10 px / view distance; 4 in camera mode)
  FS  (points.fs:36-101) cull color border (uv outside [0.01, 0.99]),
                         shade(view_pos, view_normal, color)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..calib.sensors import CalibrationSet
from ..core.config import PipelineConfig
from ..ops import splat
from ..ops.preprocess import SensorMaps
from ..ops.raymarch import ViewCamera, shade
from ..ops.sampling import bilinear_2d, trilinear_3d


class PointsPipeline:
    """mode-0 strategy: renders SensorMaps directly, no volume."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None):
        self.calib = calib
        self.config = config or PipelineConfig()

    def make_renderer(self, camera: ViewCamera, jit_compile: bool = True):
        cfg = self.config
        max_size = 4.0 if cfg.shade_mode == 3 else 10.0  # points.gs:55-58
        rot = jnp.asarray(camera.rotation())
        eye = jnp.asarray(np.asarray(camera.eye, np.float32))

        # calib is a jit ARGUMENT (not a closure constant): closure-captured
        # arrays are baked into the lowered module, and cv volumes are
        # hundreds of MB at reference scale (see TsdfPipeline docstring).
        def render(maps: SensorMaps, calib: CalibrationSet):
            N, H, W = maps.depth.shape[:3]
            u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
            v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
            uu, vv = jnp.meshgrid(u, v)

            def per_sensor(cv_xyz, cv_uv, depth2, colors, normal):
                d = depth2[..., 0]
                coords = jnp.stack([uu, vv, d], axis=-1)
                world = trilinear_3d(cv_xyz, coords)
                texco = trilinear_3d(cv_uv, coords)[..., :2]
                color = bilinear_2d(colors, texco)
                in_box = jnp.all(
                    (world >= calib.bbox_min) & (world <= calib.bbox_max), axis=-1
                )
                # GS cull (points.gs:39-41) + FS border cull (points.fs:38-42)
                valid = (d > 0.0) & in_box
                valid &= (
                    (texco[..., 0] > 0.01) & (texco[..., 0] < 0.99)
                    & (texco[..., 1] > 0.01) & (texco[..., 1] < 0.99)
                )
                return world, color, valid, normal

            world, color, valid, normal = jax.vmap(per_sensor)(
                calib.cv_xyz, calib.cv_uv, maps.depth, maps.color, maps.normal
            )

            P = N * H * W
            world = world.reshape(P, 3)
            color = color.reshape(P, 3)
            normal = normal.reshape(P, 3)
            valid = valid.reshape(P)

            xy, z = splat.project_points(world, camera)
            valid &= z > camera.near
            # gl_PointSize = max_size / dist (points.gs:60); splat radius in
            # extra pixels beyond the center = size/2
            dist = jnp.linalg.norm(world - eye, axis=-1)
            radius = jnp.clip(max_size / jnp.maximum(dist, 1e-3) * 0.5, 0.0, 2.0)

            zbuf = splat.zbuffer_min(
                xy, z, valid, (camera.height, camera.width), radius
            )

            view_pos = jnp.matmul(world - eye, rot, precision="highest")
            view_normal = jnp.matmul(normal, rot, precision="highest")
            if cfg.shade_mode == 3:
                palette = jnp.asarray(
                    np.array(
                        [[228, 26, 28], [55, 126, 184], [77, 175, 74],
                         [152, 78, 163], [255, 127, 0]], np.float32
                    ) / 255.0
                )
                cam_colors = jnp.repeat(palette[:N % 6][:N], H * W, axis=0)
                shaded = cam_colors
            else:
                shaded = shade(view_pos, view_normal, color,
                               shade_mode=cfg.shade_mode, world_normal=normal)

            img, covered = splat.resolve_winners(
                xy, z, valid, shaded, zbuf, radius=radius, z_tol=1e-4
            )
            depth_out = jnp.where(jnp.isfinite(zbuf), camera.window_depth(zbuf), 1.0)
            img = jnp.where(covered[..., None], img, 0.0)
            return img, depth_out, covered

        inner = jax.jit(render) if jit_compile else render

        def renderer(maps: SensorMaps):
            return inner(maps, self.calib)

        return renderer
