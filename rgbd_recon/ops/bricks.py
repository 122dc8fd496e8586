"""Brick occupancy marking and gating — scatter-add instead of SSBO atomics.

Replicates glsl/inc_bricks.glsl semantics with dense arrays:

  - mark_brick (inc_bricks.glsl:40-58): every valid depth pixel's world
    position increments its containing brick's counter, plus conditionally
    the nearest neighbor brick along the dominant offset axis;
  - brick_occupied (inc_bricks.glsl:60-62): counter > min_voxels (10);
  - occupancy gating: instead of the reference's GPU->CPU counter readback +
    compacted index list (recon_integration.cpp:431-446 — its only per-frame
    sync), occupancy stays on device as a dense (Bz, By, Bx) bool mask and
    gated kernels compute densely under the mask (static shapes, no sync).
"""

from __future__ import annotations

import jax.numpy as jnp


def mark_bricks(
    world_pos: jnp.ndarray,   # (..., 3) world positions of valid pixels
    valid: jnp.ndarray,       # (...) bool
    bbox_min: jnp.ndarray,
    brick_size: float,
    brick_res: tuple,         # (Bx, By, Bz) static
) -> jnp.ndarray:
    """Scatter-add brick counters for one frame. Returns (Bz, By, Bx) int32.

    Exact port of mark_brick's index math (inc_bricks.glsl:40-58),
    including the reference's neighbor-marking quirk of testing only
    ``d_abs.x`` for the border condition (:52).
    """
    bx, by, bz = brick_res
    p = world_pos.reshape(-1, 3)
    v = valid.reshape(-1)

    rel = (p - bbox_min) / brick_size
    idx = jnp.floor(rel).astype(jnp.int32)
    idx = jnp.clip(idx, 0, jnp.array([bx - 1, by - 1, bz - 1], jnp.int32))

    # own brick: +1 for every valid pixel
    flat_own = (idx[:, 2] * by + idx[:, 1]) * bx + idx[:, 0]

    # neighbor brick along the dominant-offset axis (inc_bricks.glsl:42-52)
    brick_center = (idx.astype(jnp.float32) + 0.5) * brick_size + bbox_min
    diff = p - brick_center
    d_abs = jnp.abs(diff)
    min_v = jnp.max(d_abs, axis=-1, keepdims=True)
    min_c = jnp.where(d_abs < min_v, 0.0, 1.0)
    offset = jnp.sign(diff * min_c).astype(jnp.int32)
    nidx = jnp.clip(
        idx + offset, 0, jnp.array([bx - 1, by - 1, bz - 1], jnp.int32)
    )
    flat_n = (nidx[:, 2] * by + nidx[:, 1]) * bx + nidx[:, 0]
    near_border = d_abs[:, 0] > brick_size * 0.1  # quirk: x-axis only (:52)

    # Histogram as a one-hot matmul instead of a scatter-add (thousands
    # of pixels share each brick, so a scatter sees many duplicate
    # indices): counts[b] = sum_p onehot_hi[p] x onehot_lo[p] is an
    # exact (P, Hh) @ (P, G) contraction (0/1 bf16 inputs, f32
    # accumulation — exact for counts far beyond any sensor resolution).
    flat = jnp.concatenate([flat_own, flat_n])
    val = jnp.concatenate([v, v & near_border])
    B = bz * by * bx
    G = 128
    Hh = -(-B // G)
    hi = flat // G
    lo = flat % G
    oh_hi = (
        (hi[:, None] == jnp.arange(Hh, dtype=jnp.int32)[None, :])
        & val[:, None]
    ).astype(jnp.bfloat16)
    oh_lo = (
        lo[:, None] == jnp.arange(G, dtype=jnp.int32)[None, :]
    ).astype(jnp.bfloat16)
    counts = jnp.einsum(
        "ph,pg->hg", oh_hi, oh_lo, preferred_element_type=jnp.float32
    )
    counts = counts.reshape(-1)[:B].astype(jnp.int32)

    return counts.reshape(bz, by, bx)


def occupied_mask(counts: jnp.ndarray, min_voxels: int = 10) -> jnp.ndarray:
    """(Bz, By, Bx) bool occupancy (brick_occupied, inc_bricks.glsl:60-62)."""
    return counts > min_voxels


def expand_mask_to_voxels(
    mask: jnp.ndarray, voxel_to_brick: jnp.ndarray
) -> jnp.ndarray:
    """Broadcast a brick mask to per-voxel gating using the static
    voxel->brick map (core.grid.BrickGrid.voxel_to_brick_map)."""
    return mask.reshape(-1)[voxel_to_brick]


def expand_mask_to_voxel_grid(
    mask: jnp.ndarray,            # (Bz, By, Bx) bool
    vol_shape: tuple,             # (Z, Y, X) static voxel resolution
    bbox_size: tuple,             # (sx, sy, sz) static metric extents
    brick_size: float,
) -> jnp.ndarray:
    """Brick mask -> per-voxel mask via separable per-axis index vectors.

    Same semantics as `expand_mask_to_voxels` (voxel center's containing
    brick, BrickGrid.voxel_to_brick_map math: floor(world_offset /
    brick_size)), but the index arrays are three tiny per-axis vectors
    computed in-program instead of a full (Z, Y, X) int32 map — no ~35 MB
    constant in the lowered module, no big device-memory gather.
    """
    Z, Y, X = vol_shape
    sx, sy, sz = bbox_size
    Bz, By, Bx = mask.shape

    def axis_idx(R, B, size):
        i = jnp.arange(R, dtype=jnp.float32)
        b = jnp.floor((i + 0.5) / R * (size / brick_size)).astype(jnp.int32)
        return jnp.clip(b, 0, B - 1)

    iz = axis_idx(Z, Bz, sz)
    iy = axis_idx(Y, By, sy)
    ix = axis_idx(X, Bx, sx)
    return mask[iz][:, iy][:, :, ix]


def occupancy_ratio(mask: jnp.ndarray) -> jnp.ndarray:
    """Fraction of occupied bricks (the GUI stat, kinect_client.cpp:405)."""
    return jnp.mean(mask.astype(jnp.float32))
