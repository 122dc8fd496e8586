"""Triangle-grid reconstruction (mode 2) — visibility-epsilon accumulation.

Re-design of ReconTrigrid (framework/reconstruction/recon_trigrid.cpp +
glsl/trigrid_accum.{vs,gs,fs}, trigrid_normalize.fs) for XLA. The reference
builds a screen-space triangle mesh over each sensor's depth grid (2
triangles per pixel, recon_trigrid.cpp:48-61) and renders it twice:

  pass 1  depth only -> per-pixel closest surface
  pass 2  additive blend of quality-premultiplied shaded colors for
          fragments within epsilon (0.075 m, recon_trigrid.cpp:35) of the
          pass-1 depth (trigrid_accum.fs:61-76)
  normalize  color / accumulated quality (trigrid_normalize.fs)

Re-design: rasterization becomes fragment splatting — each valid grid
cell emits its triangle vertices as fragments (with the triangle-validity
cull from the GS: no negative depths, edge lengths < min_length * avg_depth
* 4, trigrid_accum.gs:27-37); the two passes are scatter-min + masked
scatter-add with identical visibility-epsilon semantics.
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

_EPSILON = 0.075        # recon_trigrid.cpp:35
_MIN_LENGTH = 0.0125    # KinectCalibrationFile.cpp:96 default


class TrigridPipeline:
    """mode-2 strategy: per-sensor surface meshes, epsilon-blended."""

    def __init__(self, calib: CalibrationSet, config: PipelineConfig = None,
                 min_length: float = _MIN_LENGTH, epsilon: float = _EPSILON):
        self.calib = calib
        self.config = config or PipelineConfig()
        self.min_length = min_length
        self.epsilon = epsilon

    def make_render_fn(self, camera: ViewCamera):
        """Raw render(maps, calib) — calib as jit argument, not closure
        constant (see PointsPipeline)."""
        cfg = self.config
        rot = jnp.asarray(camera.rotation())
        eye = jnp.asarray(np.asarray(camera.eye, np.float32))
        eps = self.epsilon
        min_length = self.min_length

        def render(maps: SensorMaps, calib: CalibrationSet):
            N, H, W = maps.depth.shape[:3]
            u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
            v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
            uu, vv = jnp.meshgrid(u, v)

            def per_sensor(cv_xyz, cv_uv, depth2, colors, quality):
                d = depth2[..., 0]
                coords = jnp.stack([uu, vv, d], axis=-1)
                world = trilinear_3d(cv_xyz, coords)
                texco = trilinear_3d(cv_uv, coords)[..., :2]
                color = bilinear_2d(colors, texco)

                # triangle-grid validity over each 2x2 cell: emulate the GS
                # cull on both triangles of the cell, then mark the cell's
                # fragments valid if either triangle survives.
                def shift(a, dy, dx):
                    return jnp.roll(a, (-dy, -dx), axis=(0, 1))

                d00, d10, d01, d11 = d, shift(d, 0, 1), shift(d, 1, 0), shift(d, 1, 1)
                w00 = world
                w10 = shift(world, 0, 1)
                w01 = shift(world, 1, 0)
                w11 = shift(world, 1, 1)

                def tri_ok(da, db, dc, wa, wb, wc):
                    has_depth = (da >= 0.0) & (db >= 0.0) & (dc >= 0.0)
                    avg = (da + db + dc) / 3.0
                    l = min_length * avg * 4.0
                    e1 = jnp.linalg.norm(wb - wa, axis=-1) < l
                    e2 = jnp.linalg.norm(wc - wa, axis=-1) < l
                    e3 = jnp.linalg.norm(wc - wb, axis=-1) < l
                    return has_depth & e1 & e2 & e3

                t1 = tri_ok(d00, d10, d01, w00, w10, w01)
                t2 = tri_ok(d10, d11, d01, w10, w11, w01)
                cell_ok = t1 | t2
                # no cell exists in the last row/col (rolled neighbors wrap)
                cell_ok = cell_ok.at[-1, :].set(False).at[:, -1].set(False)
                # a vertex fragment is valid if any adjacent cell is valid
                frag_ok = (
                    cell_ok
                    | jnp.roll(cell_ok, 1, axis=1)
                    | jnp.roll(cell_ok, 1, axis=0)
                    | jnp.roll(cell_ok, (1, 1), axis=(0, 1))
                )

                in_box = jnp.all(
                    (world >= calib.bbox_min) & (world <= calib.bbox_max), axis=-1
                )
                border = (
                    (texco[..., 0] > 0.01) & (texco[..., 0] < 0.99)
                    & (texco[..., 1] > 0.01) & (texco[..., 1] < 0.99)
                )
                valid = frag_ok & in_box & border & (d > 0.0)
                return world, color, quality, valid

            world, color, quality, valid = jax.vmap(per_sensor)(
                calib.cv_xyz, calib.cv_uv, maps.depth, maps.color, maps.quality
            )

            P = N * H * W
            world = world.reshape(P, 3)
            color = color.reshape(P, 3)
            quality = quality.reshape(P)
            valid = valid.reshape(P)

            xy, z = splat.project_points(world, camera)
            valid &= z > camera.near

            # splat footprint ~ projected cell size: pixel spacing in world
            # is ~ depth / fx; on screen ~ focal_out * spacing / depth ->
            # roughly constant; radius 1 px covers the grid at test scales
            radius = jnp.ones_like(z)

            zbuf = splat.zbuffer_min(
                xy, z, valid, (camera.height, camera.width), radius, max_radius=1
            )

            view_pos = jnp.matmul(world - eye, rot, precision="highest")
            shaded = shade(view_pos, jnp.zeros_like(view_pos), color,
                           shade_mode=0)
            premult = shaded * quality[:, None]  # trigrid_accum.fs:71-75

            acc, wsum = splat.accumulate_epsilon(
                xy, z, valid, premult, quality, zbuf, eps,
                radius=radius, max_radius=1,
            )
            covered = wsum > 0.0
            img = jnp.where(
                covered[..., None], acc / jnp.maximum(wsum, 1e-20)[..., None], 0.0
            )  # trigrid_normalize.fs:19-24
            depth_out = jnp.where(jnp.isfinite(zbuf), camera.window_depth(zbuf), 1.0)
            return img, depth_out, covered

        return render

    def make_renderer(self, camera: ViewCamera, jit_compile: bool = True):
        render = self.make_render_fn(camera)
        inner = jax.jit(render) if jit_compile else render

        def renderer(maps: SensorMaps):
            return inner(maps, self.calib)

        return renderer
