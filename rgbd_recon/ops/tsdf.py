"""TSDF integration — weighted multi-sensor fusion into the volume.

Exact math of glsl/tsdf_integration.vs:23-58, restructured for XLA: instead
of one vertex-shader thread per voxel with a sensor loop, the whole volume is
a dense (Z, Y, X) array and the sensor loop is an unrolled scan whose body is
fully vectorized over all voxels (gathers through cv_xyz_inv + sensor maps).

Per voxel (volume-normalized position p), per sensor i in order:
  pos_calib = cv_xyz_inv[i](p)                       (:31)
  silhouette carve: sil < 1 and nothing written yet -> tsd = -limit, skip
                                                      (:32-39)
  sdist = pos_calib.z - depth_i(pos_calib.xy)        (:40-41)
  sdist <= -limit -> tsd = -limit                    (:42-45)
  sdist >= +limit -> skip                            (:46-48)
  else quality-weighted running average              (:49-54)
Initial value +limit (:28); voxels of unoccupied bricks keep the clear value
-limit (clearImage, recon_integration.cpp:250-251).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .sampling import bilinear_2d, trilinear_3d


def voxel_centers(
    vol_shape: Tuple[int, int, int],
    true_shape: Optional[Tuple[int, int, int]] = None,
) -> jnp.ndarray:
    """(Z, Y, X, 3) volume-normalized voxel-center positions, computed from
    iota *inside* the traced program.

    Materializing this grid host-side and closing over it bakes a ~100 MB
    constant into every jitted program (8.8M voxels at reference scale,
    SURVEY.md §6) — which both bloats the lowered module and costs a
    device-memory read per frame. Iota fuses into its consumers.

    ``true_shape`` supports sharding-padded grids: positions are normalized
    by the true resolution so padded rows land outside [0,1] and integrate
    to the clear value.
    """
    Z, Y, X = vol_shape
    tz, ty, tx = true_shape or vol_shape
    zi = jax.lax.broadcasted_iota(jnp.float32, (Z, Y, X), 0)
    yi = jax.lax.broadcasted_iota(jnp.float32, (Z, Y, X), 1)
    xi = jax.lax.broadcasted_iota(jnp.float32, (Z, Y, X), 2)
    return jnp.stack(
        [(xi + 0.5) / tx, (yi + 0.5) / ty, (zi + 0.5) / tz], axis=-1
    )


def precompute_projections(
    voxel_pos: jnp.ndarray, cv_xyz_inv: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hoist the frame-invariant cv_xyz_inv lookups out of the per-frame
    integration: the voxel grid and calibration volumes are both static, so
    each voxel's per-sensor (u, v, depth_norm) projection is a constant.

    This replaces the reference's per-voxel texture fetches
    (tsdf_integration.vs:31): one big gather at calibration time instead of
    one per frame, turning the per-frame kernel into pure elementwise math +
    small-map bilinear gathers.

    Returns (pos_calib (N, Z, Y, X, 3), in_frustum (N, Z, Y, X) bool).
    """

    def one(inv):
        lookup = trilinear_3d(inv, voxel_pos)
        return lookup[..., :3], lookup[..., 3] > 0.99

    return jax.lax.map(one, cv_xyz_inv)


@functools.partial(jax.jit, static_argnums=(1,))
def bake_projections(
    cv_xyz_inv: jnp.ndarray, vol_shape: Tuple[int, int, int]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jitted projection bake over an iota voxel grid (no host constants):
    the form the pipeline uses at setup."""
    return precompute_projections(voxel_centers(vol_shape), cv_xyz_inv)


def _fuse_sensor(tsd, total_w, pos_z, depth, qual, sil, in_frustum, limit,
                 carve_sil_threshold):
    """One sensor's update of the running (tsd, total_w) fold — the exact
    per-sensor branch structure of tsdf_integration.vs:30-55, vectorized
    over any batch shape. Shared by the dense and brick-compact paths."""
    # silhouette carve (:32-39): only when no sensor has written yet.
    # Threshold 1.0 = reference-exact; see PipelineConfig.
    carve = (sil < carve_sil_threshold) & (tsd >= limit) & in_frustum

    sdist = pos_z - depth
    behind = (sdist <= -limit) & in_frustum
    skip = (sdist >= limit) | ~in_frustum

    new_w = total_w + qual
    updated = jnp.where(
        new_w > 0.0,
        (tsd * total_w + qual * sdist) / jnp.maximum(new_w, 1e-20),
        tsd,
    )

    tsd_next = jnp.where(behind, -limit, jnp.where(skip, tsd, updated))
    w_next = jnp.where(behind | skip, total_w, new_w)

    tsd = jnp.where(carve, -limit, tsd_next)
    total_w = jnp.where(carve, total_w, w_next)
    return tsd, total_w


def integrate(
    voxel_pos: Union[jnp.ndarray, Tuple[int, int, int]],
    # (Z, Y, X, 3) volume-normalized voxel centers, or a static (Z, Y, X)
    # shape tuple -> centers are generated from iota in-program
    cv_xyz_inv: jnp.ndarray,     # (N, Dz, Hy, Wx, 4)
    depths: jnp.ndarray,         # (N, H, W) processed normalized depth
    qualities: jnp.ndarray,      # (N, H, W)
    silhouettes: jnp.ndarray,    # (N, H, W)
    limit: float,
    voxel_mask: Optional[jnp.ndarray] = None,  # (Z, Y, X) bool brick gating
    projections: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    carve_sil_threshold: float = 1.0,
    phantom_hull: bool = False,
    return_observers: bool = False,
) -> jnp.ndarray:
    """Returns the fused TSDF volume (Z, Y, X) float32 in [-limit, +limit].

    Pass `projections` from :func:`precompute_projections` to skip the
    per-frame cv_xyz_inv gathers (identical math, large speedup).

    ``return_observers`` also returns a per-voxel OBSERVER COUNT (f32):
    how many sensors contributed an in-band, positive-quality depth sample
    to the voxel. Pose refinement's contamination-aware consensus masks
    residuals to voxels >= 2 other sensors actually observed
    (refine/pose_ba.py) — regions a single (possibly drifted) sensor
    hallucinated then carry no weight."""
    if isinstance(voxel_pos, tuple):
        voxel_pos = voxel_centers(voxel_pos)
    num_sensors = depths.shape[0]

    tsd = jnp.full(voxel_pos.shape[:-1], limit, jnp.float32)
    total_w = jnp.zeros_like(tsd)
    observers = jnp.zeros_like(tsd) if return_observers else None

    for i in range(num_sensors):
        if projections is not None:
            pos_calib = projections[0][i]
            in_frustum = projections[1][i]
        else:
            lookup = trilinear_3d(cv_xyz_inv[i], voxel_pos)
            pos_calib = lookup[..., :3]
            # validity channel (w = 1 in-frustum, -1 outside,
            # calibration_inverter.cpp:128,141): voxels whose trilinear
            # lookup mixes invalid texels would read garbage projections.
            # The reference skips this check (its bbox is strictly inside
            # every frustum); we gate on it so partial-coverage rigs stay
            # correct.
            in_frustum = lookup[..., 3] > 0.99
        uv = pos_calib[..., :2]
        sil = bilinear_2d(silhouettes[i][..., None], uv)[..., 0]
        depth = bilinear_2d(depths[i][..., None], uv)[..., 0]
        qual = bilinear_2d(qualities[i][..., None], uv)[..., 0]

        tsd, total_w = _fuse_sensor(
            tsd, total_w, pos_calib[..., 2], depth, qual, sil, in_frustum,
            limit, carve_sil_threshold,
        )
        if return_observers:
            sdist = pos_calib[..., 2] - depth
            observers = observers + (
                in_frustum & (sdist > -limit) & (sdist < limit)
                & (qual > 0.0)
            ).astype(jnp.float32)

    if not phantom_hull:
        # Reference parity quirk (tsdf_integration.vs:28,57): voxels of
        # occupied bricks that NO sensor observed inside the truncation band
        # keep the +limit init value. Where such a region abuts carved
        # (-limit) space, the raymarcher finds a sign change that is not a
        # measured surface — a phantom wall inside objects / at hull
        # boundaries. With phantom_hull=False (default), unobserved voxels
        # (zero accumulated weight, still at +limit) are reset to -limit
        # ("unknown"), so only genuinely written TSDF bands produce hits.
        tsd = jnp.where((total_w <= 0.0) & (tsd >= limit), -limit, tsd)

    if voxel_mask is not None:
        tsd = jnp.where(voxel_mask, tsd, -limit)
    if return_observers:
        return tsd, observers
    return tsd


# ---------------------------------------------------------------------------
# Brick-compact integration (the fast path)
# ---------------------------------------------------------------------------
#
# The dense path computes all Z*Y*X voxels and masks — at reference scale
# that is 8.8M voxels although only 3-6% of bricks are occupied
# (inc_bricks.glsl:52-56 comments; recon_integration.cpp:255-261 processes
# occupied bricks only). Gathered elements dominate the integration's cost,
# so the compact path gathers only the occupied bricks' voxels.
#
# Layout: everything brick-major. The padded volume (Bz*v, By*v, Bx*v) is
# viewed as (B, V) where B = number of bricks and V = v^3 voxels per brick;
# per-voxel projections are pre-baked in this layout as 4-wide rows
# (u, v, depth_norm, valid) so one frame's integration is:
#
#   ids   = nonzero(occupied)[: capacity]            (fixed-size, on device)
#   proj  = proj_bricks[:, ids]                      (block gather, ~memcpy)
#   maps  = packed (N*H*W, 4) rows [depth, quality, silhouette, -]
#   vals  = maps[corner_flat_indices]                (4 row-gathers, N*K*V)
#   tsd   = sensor fold (exact tsdf_integration.vs math)
#   vol   = clear.at[ids].set(tsd)                   (block scatter)
#   dense = unbrick(vol)                             (transpose, bandwidth)
#
# Requires brick_size to be an integer multiple of voxel_size (true for the
# reference defaults: 10 cm bricks / 1 cm voxels); the pipeline falls back
# to the dense path otherwise.


def brick_layout(vol_shape: Tuple[int, int, int], brick_vox: int):
    """((Bz, By, Bx), padded_shape) for viewing a (Z, Y, X) volume as bricks
    of brick_vox^3 voxels."""
    Z, Y, X = vol_shape
    v = brick_vox
    Bz, By, Bx = -(-Z // v), -(-Y // v), -(-X // v)
    return (Bz, By, Bx), (Bz * v, By * v, Bx * v)


def bake_projections_bricks(
    cv_xyz_inv: jnp.ndarray,          # (N, Dz, Hy, Wx, 4)
    vol_shape: Tuple[int, int, int],  # true (Z, Y, X)
    brick_vox: int,
) -> jnp.ndarray:
    """(N, B, V, 4) brick-major per-voxel projections, rows
    (u, v, depth_norm, valid>0). Padded voxels (when the volume is not a
    multiple of the brick edge) get valid=-1 via out-of-range normalized
    positions. One-time setup cost."""
    (Bz, By, Bx), padded = brick_layout(vol_shape, brick_vox)
    v = brick_vox

    def one(inv):
        pos = voxel_centers(padded, true_shape=vol_shape)
        look = trilinear_3d(inv, pos)  # (Zp, Yp, Xp, 4)
        # resolve validity at bake time with the same rule as the dense
        # path (precompute_projections: interpolated channel > 0.99, i.e.
        # all 8 source texels valid); padded rows (positions outside [0,1],
        # which would clamp-sample the border texel) are invalid too
        inside = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=-1)
        valid = (look[..., 3] > 0.99) & inside
        look = look.at[..., 3].set(jnp.where(valid, 1.0, -1.0))
        bm = look.reshape(Bz, v, By, v, Bx, v, 4)
        bm = bm.transpose(0, 2, 4, 1, 3, 5, 6)
        return bm.reshape(Bz * By * Bx, v * v * v, 4)

    return jax.lax.map(one, cv_xyz_inv)


def occupied_brick_ids(
    counts: jnp.ndarray, min_voxels: int, capacity: int
) -> jnp.ndarray:
    """Flat ids of occupied bricks, fixed ``capacity`` entries; unused slots
    hold ``num_bricks`` (out of range -> dropped by the scatter). Bricks
    beyond capacity are dropped (capacity defaults give ~3x the reference's
    observed 3-5.5% occupancy headroom) — check
    :func:`occupied_brick_overflow` to observe drops."""
    occ = (counts > min_voxels).reshape(-1)
    B = occ.shape[0]
    if capacity >= B:
        # small grids: every brick id fits — no compaction needed
        ids = jnp.where(occ, jnp.arange(B, dtype=jnp.int32), B)
        return jnp.concatenate(
            [jnp.sort(ids), jnp.full((capacity - B,), B, jnp.int32)]
        )
    # top_k compaction instead of jnp.nonzero: picks the `capacity`
    # smallest occupied ids in ascending order (identical result)
    neg = jnp.where(occ, -jnp.arange(B, dtype=jnp.int32), -B)
    vals, _ = jax.lax.top_k(neg, capacity)
    return jnp.where(vals > -B, -vals, B)


def occupied_brick_overflow(
    counts: jnp.ndarray, min_voxels: int, capacity: int
) -> jnp.ndarray:
    """int32 number of occupied bricks DROPPED by the fixed-capacity
    compact integration this frame (0 = everything integrated). Cheap
    device-side reduction; surfaced by TsdfPipeline.diagnostics and the app
    loop so crowded scenes can't silently lose geometry."""
    n_occ = jnp.sum((counts > min_voxels).astype(jnp.int32))
    return jnp.maximum(n_occ - capacity, 0)


def integrate_bricks(
    proj_bricks: jnp.ndarray,   # (N, B, V, 4) from bake_projections_bricks
    ids: jnp.ndarray,           # (K,) occupied brick ids (pad = B)
    depths: jnp.ndarray,        # (N, H, W)
    qualities: jnp.ndarray,     # (N, H, W)
    silhouettes: jnp.ndarray,   # (N, H, W)
    limit: float,
    vol_shape: Tuple[int, int, int],
    brick_vox: int,
    carve_sil_threshold: float = 1.0,
    phantom_hull: bool = False,
    taps: str = "bilinear",
) -> jnp.ndarray:
    """Occupied-bricks-only integration; returns the dense (Z, Y, X) volume
    (unoccupied voxels at the clear value -limit, recon_integration.cpp:250).
    Bit-identical math to :func:`integrate` on the occupied set with
    taps="bilinear" (the reference's texture() filtering,
    tsdf_integration.vs:34-53); taps="nearest" fetches the maps at the
    nearest texel — a 4-wide row from a small per-sensor table at ~2x the
    gather rate, deviating from bilinear by at most the inter-pixel map
    variation (sub-voxel at reference sensor resolution)."""
    N, B, V, _ = proj_bricks.shape
    H, W = depths.shape[1:3]
    (Bz, By, Bx), padded = brick_layout(vol_shape, brick_vox)
    v = brick_vox

    ids_c = jnp.minimum(ids, B - 1)
    proj = proj_bricks[:, ids_c]          # (N, K, V, 4) block gather

    if taps == "nearest":
        # 8-byte map rows: [depth f32 | (quality, silhouette) as a bf16
        # pair bitcast into one f32 lane]. Halves the per-sensor gather
        # table (1.7 MB vs 3.5) into the fast gather size class; depth
        # keeps full precision (it enters sdist directly), quality is a
        # blend weight and the silhouette is {0,1} — both exact enough
        # in bf16 for the nearest-tap fast path.
        qs = jnp.stack([qualities, silhouettes], axis=-1).astype(jnp.bfloat16)
        qs_f32 = jax.lax.bitcast_convert_type(
            qs.reshape(N, H * W, 2), jnp.float32
        )
        p2 = jnp.stack(
            [depths.reshape(N, H * W), qs_f32], axis=-1
        )  # (N, H*W, 2)
        # one relayout to channel planes: the uv/validity math then runs
        # full-lane instead of strided 4-minor channel extracts
        proj_p = jnp.moveaxis(proj, -1, 0)     # (4, N, K, V)
        in_frustum = proj_p[3] > 0.0
        xi = jnp.clip((proj_p[0] * W).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip((proj_p[1] * H).astype(jnp.int32), 0, H - 1)
        idx = yi * W + xi
        rows = jnp.stack([p2[i][idx[i]] for i in range(N)])  # (N, K, V, 2)
        qs2 = jax.lax.bitcast_convert_type(
            rows[..., 1], jnp.bfloat16
        ).astype(jnp.float32)                               # (N, K, V, 2)
        vals = jnp.concatenate(
            [rows[..., :1], qs2, jnp.zeros_like(rows[..., :1])], axis=-1
        )
        return _fold_and_scatter(
            proj_p[2], vals, in_frustum, ids, limit, vol_shape, brick_vox,
            carve_sil_threshold, phantom_hull,
        )

    # full 2x2-packed sensor maps: row (y, x) holds the 3 channels
    # [depth, quality, silhouette] (+1 pad) at all four bilinear corners
    # (x, y), (x+1, y), (x, y+1), (x+1, y+1), edge-clamped — so ONE 16-wide
    # row gather fetches a complete bilinear footprint: one row per sample
    # instead of the two of a pair scheme or the four of per-corner
    # gathers.
    p4 = jnp.stack(
        [depths, qualities, silhouettes, jnp.zeros_like(depths)], axis=-1
    )  # (N, H, W, 4)
    px = jnp.concatenate([p4[:, :, 1:], p4[:, :, -1:]], axis=2)
    row8 = jnp.concatenate([p4, px], axis=-1)          # x, x+1
    row8_dn = jnp.concatenate([row8[:, 1:], row8[:, -1:]], axis=1)  # y+1
    packed = jnp.concatenate([row8, row8_dn], axis=-1).reshape(N, H * W, 16)

    u = proj[..., 0]
    vv = proj[..., 1]
    in_frustum = proj[..., 3] > 0.0

    cx = u * W - 0.5
    cy = vv * H - 0.5
    x0f = jnp.floor(cx)
    y0f = jnp.floor(cy)
    # GL clamp semantics at the borders (both taps -> the edge texel): the
    # packed row only carries (x, x+1) x (y, y+1), so express the clamp
    # through zero fractional weights
    fx = jnp.where(x0f < 0.0, 0.0, cx - x0f)[..., None]
    fy = jnp.where(y0f < 0.0, 0.0, cy - y0f)[..., None]
    x0 = jnp.clip(x0f.astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, H - 1)

    # per-sensor gathers: each indexes a ~14 MB table slice rather than
    # one big (N*H*W)-row table, keeping the working set small
    flat_idx = y0 * W + x0
    rows = jnp.stack([packed[i][flat_idx[i]] for i in range(N)])
    c0 = rows[..., 0:4] * (1 - fx) + rows[..., 4:8] * fx
    c1 = rows[..., 8:12] * (1 - fx) + rows[..., 12:16] * fx
    vals = c0 * (1 - fy) + c1 * fy
    # (N, K, V, 4): [depth, quality, silhouette]
    return _fold_and_scatter(
        proj[..., 2], vals, in_frustum, ids, limit, vol_shape, brick_vox,
        carve_sil_threshold, phantom_hull,
    )


def _fold_and_scatter(
    proj_z, vals, in_frustum, ids, limit, vol_shape, brick_vox,
    carve_sil_threshold, phantom_hull,
):
    """Sensor fold over sampled map values + block scatter back to the
    dense volume (shared by the bilinear and nearest tap paths).
    ``proj_z`` is the (N, K, V) normalized-depth plane of the baked
    projections."""
    N, K, V = vals.shape[:3]
    (Bz, By, Bx), padded = brick_layout(vol_shape, brick_vox)
    v = brick_vox
    num_bricks = Bz * By * Bx

    # one explicit relayout to channel-planes: the fold would otherwise
    # strided-read the 4-wide minor axis once per sensor per channel
    vals_p = jnp.moveaxis(vals, -1, 0)       # (4, N, K, V)
    tsd = jnp.full((K, V), limit, jnp.float32)
    total_w = jnp.zeros_like(tsd)
    for i in range(N):
        tsd, total_w = _fuse_sensor(
            tsd, total_w, proj_z[i], vals_p[0, i], vals_p[1, i],
            vals_p[2, i], in_frustum[i], limit, carve_sil_threshold,
        )

    if not phantom_hull:
        # see integrate(): unobserved +limit voxels become unknown (-limit)
        tsd = jnp.where((total_w <= 0.0) & (tsd >= limit), -limit, tsd)

    vol_bm = jnp.full((num_bricks, V), -limit, jnp.float32)
    vol_bm = vol_bm.at[ids].set(tsd, mode="drop")

    dense = vol_bm.reshape(Bz, By, Bx, v, v, v).transpose(0, 3, 1, 4, 2, 5)
    dense = dense.reshape(padded)
    Z, Y, X = vol_shape
    return dense[:Z, :Y, :X]
