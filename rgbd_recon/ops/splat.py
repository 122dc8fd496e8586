"""Point/fragment splatting — the array-program substitute for rasterization.

The reference's non-TSDF reconstruction modes rasterize proxy geometry
(GL_POINTS per depth pixel, screen-space triangle grids). XLA has no
rasterizer; the equivalent primitive is a z-buffered scatter: project points,
scatter-min a depth buffer, then resolve attributes of the winning fragments.
All scatters are `jnp.ndarray.at[...].min/.add` ops — XLA lowers them to
sorted segmented updates, and shapes stay static (every candidate fragment is
computed; losers are masked).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def project_points(world, camera):
    """World positions (..., 3) -> (pixel xy (..., 2) float, view_z (...)).

    `camera` is an ops.raymarch.ViewCamera. view_z is the positive distance
    along the view direction (GL -z)."""
    rot = jnp.asarray(camera.rotation())          # cam->world (GL convention)
    eye = jnp.asarray(np.asarray(camera.eye, np.float32))
    view = jnp.matmul(world - eye, rot, precision="highest")  # world->view
    z = -view[..., 2]
    safe_z = jnp.maximum(z, 1e-6)
    tan_half = float(np.tan(np.radians(camera.fov_y) * 0.5))
    aspect = camera.width / camera.height
    ndc_x = view[..., 0] / (safe_z * tan_half * aspect)
    ndc_y = view[..., 1] / (safe_z * tan_half)
    px = (ndc_x * 0.5 + 0.5) * camera.width - 0.5
    py = (0.5 - ndc_y * 0.5) * camera.height - 0.5
    return jnp.stack([px, py], axis=-1), z


def zbuffer_min(
    xy: jnp.ndarray,        # (P, 2) pixel coords
    z: jnp.ndarray,         # (P,) view depth
    valid: jnp.ndarray,     # (P,) bool
    shape: Tuple[int, int],
    radius: jnp.ndarray = None,   # (P,) splat radius in pixels (0 = 1px)
    max_radius: int = 2,
) -> jnp.ndarray:
    """Scatter-min depth buffer. Returns (H, W) float32, inf where empty."""
    H, W = shape
    zbuf = jnp.full((H * W,), jnp.inf, jnp.float32)
    xi = jnp.round(xy[:, 0]).astype(jnp.int32)
    yi = jnp.round(xy[:, 1]).astype(jnp.int32)
    if radius is None:
        radius = jnp.zeros_like(z)
    for dy in range(-max_radius, max_radius + 1):
        for dx in range(-max_radius, max_radius + 1):
            r = float(max(abs(dx), abs(dy)))
            m = valid & (radius >= r)
            xx = xi + dx
            yy = yi + dy
            inb = m & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            flat = jnp.where(inb, yy * W + xx, 0)
            zval = jnp.where(inb, z, jnp.inf)
            zbuf = zbuf.at[flat].min(zval)
    return zbuf.reshape(H, W)


def accumulate_epsilon(
    xy: jnp.ndarray,
    z: jnp.ndarray,
    valid: jnp.ndarray,
    values: jnp.ndarray,     # (P, C) premultiplied values to accumulate
    weights: jnp.ndarray,    # (P,)
    zbuf: jnp.ndarray,       # (H, W) from zbuffer_min
    epsilon: float,
    radius: jnp.ndarray = None,
    max_radius: int = 2,
):
    """Visibility-epsilon additive accumulation (the trigrid second pass,
    glsl/trigrid_accum.fs:61-76): fragments within `epsilon` of the pass-1
    depth at their pixel accumulate premultiplied values + weights.

    Returns (accum (H, W, C), weight (H, W))."""
    H, W = zbuf.shape
    C = values.shape[-1]
    acc = jnp.zeros((H * W, C), jnp.float32)
    wacc = jnp.zeros((H * W,), jnp.float32)
    zflat = zbuf.reshape(-1)
    xi = jnp.round(xy[:, 0]).astype(jnp.int32)
    yi = jnp.round(xy[:, 1]).astype(jnp.int32)
    if radius is None:
        radius = jnp.zeros_like(z)
    for dy in range(-max_radius, max_radius + 1):
        for dx in range(-max_radius, max_radius + 1):
            r = float(max(abs(dx), abs(dy)))
            m = valid & (radius >= r)
            xx = xi + dx
            yy = yi + dy
            inb = m & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            flat = jnp.where(inb, yy * W + xx, 0)
            zhere = zflat[flat]
            visible = inb & (jnp.abs(z - zhere) <= epsilon) & jnp.isfinite(zhere)
            acc = acc.at[flat].add(jnp.where(visible[:, None], values, 0.0))
            wacc = wacc.at[flat].add(jnp.where(visible, weights, 0.0))
    return acc.reshape(H, W, C), wacc.reshape(H, W)


def resolve_winners(
    xy: jnp.ndarray,
    z: jnp.ndarray,
    valid: jnp.ndarray,
    values: jnp.ndarray,    # (P, C)
    zbuf: jnp.ndarray,
    radius: jnp.ndarray = None,
    max_radius: int = 2,
    z_tol: float = 1e-5,
):
    """Nearest-fragment resolve: each pixel takes the attribute of the
    fragment that won the z-buffer (point-mode rendering). Ties resolve
    arbitrarily (like GL point draw order)."""
    acc, w = accumulate_epsilon(
        xy, z, valid, values, jnp.ones_like(z), zbuf,
        epsilon=z_tol, radius=radius, max_radius=max_radius,
    )
    return acc / jnp.maximum(w, 1.0)[..., None], w > 0
