"""GL-semantics texture sampling as vectorized JAX gathers.

The single most important primitive of the framework (SURVEY.md §0): every
kernel of the reference projects between world and sensor space by trilinear
sampling of baked calibration volumes (GLSL ``texture(sampler3D, p)``), and
samples sensor maps bilinearly (``texture(sampler2DArray, p)``). Bit-careful
GL parity rules (OpenGL 4.4 spec §8.14):

  - normalized coordinate c over an axis of N texels maps to texel space
    x = c*N - 0.5; the two taps are floor(x) and floor(x)+1 with fractional
    blend x - floor(x);
  - CLAMP_TO_EDGE: each tap index clamps to [0, N-1] (the reference creates
    its 3D textures with default wrap = repeat in GL, but all lookups are
    interior, and edge-clamp matches the well-defined region — we standardise
    on clamp);
  - out-of-range c values therefore clamp smoothly to the border texel.

Layout: volumes are (D, H, W, C) arrays; lookups flatten to a
single gather from a (D*H*W, C) buffer with precomputed flat indices so XLA
emits one fused gather per corner (8 for trilinear, 4 for bilinear), all
vectorizable over arbitrary batch shapes.
"""

from __future__ import annotations

import jax.numpy as jnp


def _corner_gather(flat, idx, C):
    """Gather rows of a (N, C) buffer. idx has arbitrary batch shape."""
    out = jnp.take(flat, idx.reshape(-1), axis=0)
    return out.reshape(idx.shape + (C,))


def trilinear_3d(volume: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Trilinearly sample a 3D texture.

    Args:
      volume: (D, H, W, C) array. Axis order: D <- coord z, H <- y, W <- x.
      coords: (..., 3) normalized (x, y, z) in [0, 1].

    Returns: (..., C) sampled values.

    Equivalent of GLSL ``texture(sampler3D, p)`` with LINEAR filtering and
    clamp-to-edge (used for cv_xyz / cv_uv / cv_xyz_inv and the TSDF volume;
    reference kernels: glsl/tsdf_integration.vs:31, tsdf_raymarch.fs:144-146,
    pre_depth.fs:133).
    """
    D, H, W, C = volume.shape
    flat = volume.reshape(D * H * W, C)

    cx = coords[..., 0] * W - 0.5
    cy = coords[..., 1] * H - 0.5
    cz = coords[..., 2] * D - 0.5

    x0f = jnp.floor(cx)
    y0f = jnp.floor(cy)
    z0f = jnp.floor(cz)
    fx = (cx - x0f)[..., None]
    fy = (cy - y0f)[..., None]
    fz = (cz - z0f)[..., None]

    x0 = jnp.clip(x0f.astype(jnp.int32), 0, W - 1)
    x1 = jnp.clip(x0f.astype(jnp.int32) + 1, 0, W - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, H - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, H - 1)
    z0 = jnp.clip(z0f.astype(jnp.int32), 0, D - 1)
    z1 = jnp.clip(z0f.astype(jnp.int32) + 1, 0, D - 1)

    # flat index = (z * H + y) * W + x
    def fi(z, y, x):
        return (z * H + y) * W + x

    c000 = _corner_gather(flat, fi(z0, y0, x0), C)
    c001 = _corner_gather(flat, fi(z0, y0, x1), C)
    c010 = _corner_gather(flat, fi(z0, y1, x0), C)
    c011 = _corner_gather(flat, fi(z0, y1, x1), C)
    c100 = _corner_gather(flat, fi(z1, y0, x0), C)
    c101 = _corner_gather(flat, fi(z1, y0, x1), C)
    c110 = _corner_gather(flat, fi(z1, y1, x0), C)
    c111 = _corner_gather(flat, fi(z1, y1, x1), C)

    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def bilinear_2d(image: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Bilinearly sample a 2D texture.

    Args:
      image: (H, W, C) array.
      coords: (..., 2) normalized (u, v) in [0, 1] (u along W, v along H).

    Returns: (..., C).

    Equivalent of GLSL ``texture(sampler2D/sampler2DArray, p)`` per layer
    (reference: all pre_*.fs sensor-map lookups).
    """
    H, W, C = image.shape
    flat = image.reshape(H * W, C)

    cx = coords[..., 0] * W - 0.5
    cy = coords[..., 1] * H - 0.5
    x0f = jnp.floor(cx)
    y0f = jnp.floor(cy)
    fx = (cx - x0f)[..., None]
    fy = (cy - y0f)[..., None]

    x0 = jnp.clip(x0f.astype(jnp.int32), 0, W - 1)
    x1 = jnp.clip(x0f.astype(jnp.int32) + 1, 0, W - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, H - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, H - 1)

    c00 = _corner_gather(flat, y0 * W + x0, C)
    c01 = _corner_gather(flat, y0 * W + x1, C)
    c10 = _corner_gather(flat, y1 * W + x0, C)
    c11 = _corner_gather(flat, y1 * W + x1, C)

    c0 = c00 * (1 - fx) + c01 * fx
    c1 = c10 * (1 - fx) + c11 * fx
    return c0 * (1 - fy) + c1 * fy


def nearest_2d(image: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor 2D sampling (GLSL ``texelFetch`` on normalized
    coords / NEAREST filtering)."""
    H, W, C = image.shape
    flat = image.reshape(H * W, C)
    x = jnp.clip(jnp.floor(coords[..., 0] * W).astype(jnp.int32), 0, W - 1)
    y = jnp.clip(jnp.floor(coords[..., 1] * H).astype(jnp.int32), 0, H - 1)
    return _corner_gather(flat, y * W + x, C)
