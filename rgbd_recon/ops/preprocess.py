"""Per-sensor depth preprocessing chain (jnp reference kernels).

Replicates the reference's 5-pass GPU chain (NetKinectArray::processTextures,
framework/NetKinectArray.cpp:311-428) as pure functions over arrays:

  morph (dilate)  glsl/pre_morph.fs      3x3 outlier-rejecting fill
  bilateral+LAB   glsl/pre_depth.fs      13x13 depth-adaptive bilateral,
                                         bbox cull, LAB color
  boundary        glsl/pre_boundary.fs   silhouette + color-consistent refine
  normals         glsl/pre_normal.fs     central-difference world normals
  quality         glsl/pre_quality.fs    lateral continuity x viewing angle

All functions operate on one sensor; `preprocess_frames` vmaps the chain over
the sensor axis. Stencils are expressed as accumulation loops over static
offsets on edge-padded arrays — GL texture lookups at pixel-center + integer
offsets with clamp-to-edge resolve to exactly these shifted reads, and XLA
fuses the accumulation into a single pass over the map.

Depth map conventions (identical to the reference):
  raw/morphed depth: float32 meters; 0 = invalid
  processed depth (after bilateral): channel 0 = normalized depth in [0,1]
    (or 0 = culled, -1 = invalidated by boundary pass), channel 1 = local
    reliability (bilateral range confidence / boundary flags)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from ..core import pytree

from .color import rgb_to_lab
from .sampling import bilinear_2d, trilinear_3d

# Kinect v2 valid metric depth range (pre_morph.fs:32-33)
_MIN_DEPTH = 0.5
_MAX_DEPTH = 4.5


@pytree.dataclass
class SensorMaps:
    """All per-sensor intermediate maps — the equivalent of the reference's
    texture-unit bus (SURVEY.md §1: color=1, depth=2, quality=3, normal=4,
    silhouette=5, lab=7)."""

    depth: jnp.ndarray        # (N, H, W, 2) processed normalized depth + flag
    lab: jnp.ndarray          # (N, H, W, 3) LAB color at depth resolution
    silhouette: jnp.ndarray   # (N, H, W)
    normal: jnp.ndarray       # (N, H, W, 3) world-space normals
    quality: jnp.ndarray      # (N, H, W) fusion weights
    raw_depth: jnp.ndarray    # (N, H, W) morphed metric depth
    color: jnp.ndarray        # (N, Hc, Wc, 3) raw rgb (pass-through)


def _shifted(padded: jnp.ndarray, k: int, dy: int, dx: int, H: int, W: int):
    """View of an edge-padded (H+2k, W+2k, ...) array shifted by (dy, dx)."""
    return padded[k + dy : k + dy + H, k + dx : k + dx + W]


def _stencil_scan(padded: jnp.ndarray, k: int, H: int, W: int, body, init):
    """Fold `body(acc, shifted_window, dy, dx)` over all (2k+1)^2 offsets of
    a (H+2k, W+2k, ...) edge-padded array, fully unrolled.

    Unrolled rather than a ``lax.scan`` over offsets: a scan step is a
    fusion barrier, so the scanned form re-reads the padded array from
    device memory and round-trips the accumulators 169 times per sensor.
    Unrolled, XLA fuses the whole accumulation into one loop fusion that
    reads each neighbourhood through the caches. The body has no large
    constants, so the unrolled HLO stays small.

    `body` receives float32 (dy, dx) offsets from the window center.
    """
    acc = init
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            sl = padded[k + dy : k + dy + H, k + dx : k + dx + W]
            acc = body(acc, sl, float(dy), float(dx))
    return acc


def morph_dilate(depth: jnp.ndarray) -> jnp.ndarray:
    """Morphological dilate, pre_morph.fs:73-112 (the pass actually executed:
    mode 0 runs dilate(coords, 1), :123-127; mode 1 is passthrough :130-135).

    Invalid pixels (outside 0.5..4.5 m) are filled with the two-pass
    outlier-rejecting mean of their valid 3x3 neighbors: first the plain mean
    of valid neighbors, then the mean of those within 0.2 m of it.
    """
    H, W = depth.shape
    k = 1
    pad = jnp.pad(depth, k, mode="edge")

    valid_c = (depth > _MIN_DEPTH) & (depth < _MAX_DEPTH)

    sum1 = jnp.zeros_like(depth)
    cnt1 = jnp.zeros_like(depth)
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            s = _shifted(pad, k, dy, dx, H, W)
            v = (s > _MIN_DEPTH) & (s < _MAX_DEPTH)
            sum1 = sum1 + jnp.where(v, s, 0.0)
            cnt1 = cnt1 + v.astype(depth.dtype)
    any_valid = cnt1 > 0
    avg = sum1 / jnp.maximum(cnt1, 1.0)

    sum2 = jnp.zeros_like(depth)
    cnt2 = jnp.zeros_like(depth)
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            s = _shifted(pad, k, dy, dx, H, W)
            v = (s > _MIN_DEPTH) & (s < _MAX_DEPTH) & (jnp.abs(avg - s) < 0.2)
            sum2 = sum2 + jnp.where(v, s, 0.0)
            cnt2 = cnt2 + v.astype(depth.dtype)
    filled = jnp.where(cnt2 > 0, sum2 / jnp.maximum(cnt2, 1.0), 0.0)
    filled = jnp.where(any_valid, filled, 0.0)

    return jnp.where(valid_c, depth, filled)


def bilateral_sums(depth_m: jnp.ndarray, near, far):
    """13x13 depth-adaptive bilateral window sums, pre_depth.fs:85-127.

    (H, W) morphed metric depth -> (weighted depth sum, weight sum, range
    weight sum), each (H, W); edge-clamped neighbourhoods."""
    H, W = depth_m.shape
    ks = 6
    pad = jnp.pad(depth_m, ks, mode="edge")
    dist_range_max = 0.35 * depth_m / _MAX_DEPTH  # :89-91

    def bf_body(acc, s, dy, dx):
        depth_bf, w, w_range = acc
        depth_range = jnp.abs(s - depth_m)
        outside = (s < near) | (s > far)
        border = outside | (depth_range > dist_range_max)
        gauss_space = 1.0 - jnp.sqrt(dx * dx + dy * dy) / ks  # :38-41
        gauss_range = 1.0 - jnp.minimum(depth_range, dist_range_max) / jnp.maximum(
            dist_range_max, 1e-20
        )  # :45-48
        w_s = jnp.where(border, 0.0, gauss_space * gauss_range)
        return (
            depth_bf + w_s * s,
            w + w_s,
            w_range + jnp.where(border, 0.0, gauss_range),
        )

    zero = jnp.zeros_like(depth_m)
    return _stencil_scan(pad, ks, H, W, bf_body, (zero, zero, zero))


def quality_sums(d: jnp.ndarray):
    """13x13 lateral-continuity census of pre_quality.fs:65-119 on
    normalized depth: (H, W) -> (border count, range weight sum)."""
    H, W = d.shape
    ks = 6
    pad = jnp.pad(d, ks, mode="edge")
    dist_range_max = 0.35 * d  # :71-75 (max_depth = 1.0 here)

    def q_body(acc, s, dy, dx):
        border, w_range = acc
        depth_range = jnp.abs(s - d)
        is_border = (s <= 0.0) | (s >= 1.0) | (depth_range > dist_range_max)
        gauss_range = 1.0 - jnp.minimum(depth_range, dist_range_max) / jnp.maximum(
            dist_range_max, 1e-20
        )
        return (
            border + is_border.astype(d.dtype),
            w_range + jnp.where(is_border, 0.0, gauss_range),
        )

    zero = jnp.zeros_like(d)
    return _stencil_scan(pad, ks, H, W, q_body, (zero, zero))


def bilateral_lab(
    depth_m: jnp.ndarray,       # (H, W) morphed metric depth
    color: jnp.ndarray,         # (Hc, Wc, 3) rgb [0,1]
    cv_xyz: jnp.ndarray,        # (D, Hv, Wv, 3)
    cv_uv: jnp.ndarray,         # (D, Hv, Wv, 2)
    bbox_min: jnp.ndarray,
    bbox_max: jnp.ndarray,
    depth_limits: jnp.ndarray,  # (2,) near/far
    filter_on: bool = True,
    pixel_model=None,           # per-sensor PixelModels slice (a,b,p,q,r)
    bf_sums=None,               # precomputed (depth_bf, w, w_range) sums
    lab_in=None,                # precomputed (H, W, 3) LAB (lab_colors)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilateral depth filter + bbox cull + LAB conversion, pre_depth.fs.

    ``bf_sums`` injects the 13x13 window sums computed for all sensors at
    once (:func:`bilateral_sums` layout); None computes them here. ``lab_in`` injects the LAB color map (from
    :func:`lab_colors`, the unrolled per-sensor fast path).

    Returns (depth2 (H, W, 2): [normalized filtered depth, range confidence],
             lab (H, W, 3)).
    """
    H, W = depth_m.shape
    near, far = depth_limits[0], depth_limits[1]

    def norm_d(d):
        # pre_depth.fs:78-80
        return (d - near) / (far - near)

    depth_norm = norm_d(depth_m)
    if pixel_model is not None:
        # planar bbox cull: per-component planes instead of (H, W, 3)
        # packed math
        ray_a, ray_b, uv_p, uv_q, uv_r = pixel_model
        in_box = jnp.ones(depth_m.shape, bool)
        for j in range(3):
            wj = ray_a[..., j] + ray_b[..., j] * depth_norm
            in_box = in_box & (wj >= bbox_min[j]) & (wj <= bbox_max[j])
    else:
        u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        uu, vv = jnp.meshgrid(u, v)
        texcoord = jnp.stack([uu, vv], axis=-1)
        pos_world = trilinear_3d(
            cv_xyz, jnp.concatenate([texcoord, depth_norm[..., None]], axis=-1)
        )
        in_box = jnp.all(
            (pos_world >= bbox_min) & (pos_world <= bbox_max), axis=-1
        )

    if lab_in is not None:
        lab = lab_in
    else:
        # LAB color (pre_depth.fs:136: degenerate depth samples use z=1.0;
        # for the analytic models, evaluate at the far texel plane — the
        # clamped equivalent; see lab_colors)
        z_deg = (
            1.0 if pixel_model is None or cv_uv is None
            else 1.0 - 0.5 / cv_uv.shape[0]
        )
        z_for_uv = jnp.where(
            (depth_norm <= 0.0) | (depth_norm >= 1.0), z_deg, depth_norm
        )
        if pixel_model is not None:
            ze = z_for_uv[..., None]
            coords_c = (uv_p + uv_q * ze) / (1.0 + uv_r * ze)
        else:
            coords_c = trilinear_3d(
                cv_uv, jnp.concatenate([texcoord, z_for_uv[..., None]], axis=-1)
            )
        rgb = bilinear_2d(color, coords_c)
        lab = rgb_to_lab(rgb)

    if not filter_on:
        depth2 = jnp.stack([depth_norm, jnp.ones_like(depth_norm)], axis=-1)
        depth2 = jnp.where(in_box[..., None], depth2, 0.0)
        return depth2, lab

    # 13x13 bilateral (pre_depth.fs:85-127)
    ks = 6
    num_samples = float((2 * ks + 1) ** 2)
    if bf_sums is not None:
        depth_bf, w, w_range = bf_sums
    else:
        depth_bf, w, w_range = bilateral_sums(depth_m, near, far)

    filtered = depth_bf / jnp.maximum(w, 1e-20)
    depth2 = jnp.stack([norm_d(filtered), w_range / num_samples], axis=-1)
    depth2 = jnp.where(in_box[..., None], depth2, 0.0)  # :143-146
    return depth2, lab


# boundary pass constants (pre_boundary.fs:19-30)
_MAX_COLOR_DIST = 0.5
_MIN_RANGE = 0.65


def boundary(
    depth2: jnp.ndarray, lab: jnp.ndarray, refine: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Silhouette extraction + color-consistent boundary refinement,
    pre_boundary.fs:86-118.

    Returns (depth2' (H, W, 2), silhouette (H, W)).
    Output flags in channel 1: 0 = valid interior, 1 = refine-kept boundary,
    0.1 = invalidated (channel 0 then carries -1), 0 = outside bbox.
    """
    H, W = depth2.shape[:2]
    ks = 2
    # PLANAR taps: identical math on per-channel planes instead of a
    # packed (H, W, 5) array
    d0 = depth2[..., 0]
    q0 = depth2[..., 1]
    L0, A0, B0 = lab[..., 0], lab[..., 1], lab[..., 2]
    pd, pq, pL, pA, pB = (
        jnp.pad(p, ks, mode="edge") for p in (d0, q0, L0, A0, B0)
    )

    # get_color_diff (:37-55): mean LAB distance over valid 5x5 neighbors
    total_dist = jnp.zeros((H, W), lab.dtype)
    cnt = jnp.zeros((H, W), lab.dtype)
    for dy in range(-ks, ks + 1):
        for dx in range(-ks, ks + 1):
            def sl(p):
                return p[ks + dy: ks + dy + H, ks + dx: ks + dx + W]
            v = (sl(pd) > 0.0) & (sl(pq) > _MIN_RANGE)
            dist = jnp.sqrt(
                (L0 - sl(pL)) ** 2 + (A0 - sl(pA)) ** 2
                + (B0 - sl(pB)) ** 2
            )
            total_dist = total_dist + jnp.where(v, dist, 0.0)
            cnt = cnt + v.astype(lab.dtype)
    total_samples = float((2 * ks) * (2 * ks))  # :23 (16, not 25!)
    color_diff = jnp.where(
        cnt < total_samples * 0.5, 1.0, total_dist / jnp.maximum(cnt, 1.0)
    )

    d = depth2[..., 0]
    q = depth2[..., 1]

    outside = d <= 0.0
    unreliable = (~outside) & (q <= _MIN_RANGE)
    kept = unreliable & (color_diff <= _MAX_COLOR_DIST) & bool(refine)
    invalidated = unreliable & ~kept

    new_d = jnp.where(invalidated, -1.0, d)
    new_q = jnp.where(
        outside, 0.0, jnp.where(invalidated, 0.1, jnp.where(kept, 1.0, 0.0))
    )
    sil = jnp.where(outside | unreliable, 0.0, 1.0)
    return jnp.stack([new_d, new_q], axis=-1), sil


def normals(depth2: jnp.ndarray, cv_xyz: jnp.ndarray,
            pixel_model=None) -> jnp.ndarray:
    """Central-difference world-space normals, pre_normal.fs:26-56.

    Input channel 0 of `depth2` is the processed normalized depth;
    invalid (<=0 or >=1) neighbors are replaced by the center depth.
    (Brick marking, the pass's GL side effect, lives in ops/bricks.py.)

    With a pixel_model the 4 neighbor world positions are a + b*d at
    *shifted pixels* — edge-padded slices of the (H, W, 3) model arrays, no
    gathers (vs 32 gather rows per pixel through cv_xyz).
    """
    H, W = depth2.shape[:2]
    d = depth2[..., 0]
    valid = (d > 0.0) & (d < 1.0)

    pad = jnp.pad(d, 1, mode="edge")

    if pixel_model is not None:
        # PLANAR components: identical values per component plane instead
        # of (H, W, 3)-packed math
        ray_a, ray_b = pixel_model[0], pixel_model[1]
        a_pads = [jnp.pad(ray_a[..., j], 1, mode="edge") for j in range(3)]
        b_pads = [jnp.pad(ray_b[..., j], 1, mode="edge") for j in range(3)]

        def world_at(du, dv, dy, dx):
            ds = _shifted(pad, 1, dy, dx, H, W)
            ds = jnp.where((ds <= 0.0) | (ds >= 1.0), d, ds)
            return [
                _shifted(a_pads[j], 1, dy, dx, H, W)
                + _shifted(b_pads[j], 1, dy, dx, H, W) * ds
                for j in range(3)
            ]
    else:
        u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        uu, vv = jnp.meshgrid(u, v)

        def world_at(du, dv, dy, dx):
            ds = _shifted(pad, 1, dy, dx, H, W)
            ds = jnp.where((ds <= 0.0) | (ds >= 1.0), d, ds)
            coords = jnp.stack([uu + du / W, vv + dv / H, ds], axis=-1)
            w3 = trilinear_3d(cv_xyz, coords)
            return [w3[..., j] for j in range(3)]

    world_t = world_at(0.0, 1.0, 1, 0)   # tex_pos + (0, +texSizeInv.y)
    world_b = world_at(0.0, -1.0, -1, 0)
    world_l = world_at(-1.0, 0.0, 0, -1)
    world_r = world_at(1.0, 0.0, 0, 1)

    e1 = [world_b[j] - world_t[j] for j in range(3)]
    e2 = [world_l[j] - world_r[j] for j in range(3)]
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    inv_n = 1.0 / jnp.maximum(
        jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-20
    )
    vf = valid
    return jnp.stack(
        [jnp.where(vf, c * inv_n, 0.0) for c in (nx, ny, nz)], axis=-1
    )


def quality(
    depth2: jnp.ndarray,
    normal: jnp.ndarray,
    cv_xyz: jnp.ndarray,
    camera_position: jnp.ndarray,
    pixel_model=None,
    q_sums=None,                # precomputed (border, w_range) census sums
) -> jnp.ndarray:
    """Per-pixel fusion weight, pre_quality.fs:65-119.

    quality = (1 - border_frac)^6 * (mean range weight)^6 / (depth * 6.5)
              * cos(view angle)^2
    computed over a 13x13 window on *normalized* depth. ``q_sums`` injects
    the window sums computed elsewhere (:func:`quality_sums` layout).
    """
    H, W = depth2.shape[:2]
    d = depth2[..., 0]
    inside = (d > 0.0) & (d < 1.0)

    ks = 6
    num_samples = float((2 * ks + 1) ** 2)
    if q_sums is not None:
        border, w_range = q_sums
    else:
        border, w_range = quality_sums(d)

    lateral_quality = 1.0 - border / num_samples
    q = lateral_quality**6 * (w_range / num_samples) ** 6
    q = q / jnp.maximum(d * 6.5, 1e-20)

    # viewing-angle weight (:43-48, :113-114)
    if pixel_model is not None:
        world_pos = pixel_model[0] + pixel_model[1] * d[..., None]
    else:
        u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        uu, vv = jnp.meshgrid(u, v)
        world_pos = trilinear_3d(cv_xyz, jnp.stack([uu, vv, d], axis=-1))
    to_cam = camera_position - world_pos
    to_cam = to_cam / jnp.maximum(jnp.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-20)
    angle = jnp.sum(to_cam * normal, axis=-1)
    q = q * angle**2

    return jnp.where(inside, q, 0.0)


def preprocess_sensor(
    raw_depth: jnp.ndarray,
    color: jnp.ndarray,
    cv_xyz: jnp.ndarray,
    cv_uv: jnp.ndarray,
    bbox_min: jnp.ndarray,
    bbox_max: jnp.ndarray,
    depth_limits: jnp.ndarray,
    camera_position: jnp.ndarray,
    morph: bool = True,
    bilateral: bool = True,
    refine: bool = True,
    pixel_model=None,
):
    """Full single-sensor chain (order: NetKinectArray.cpp:311-428)."""
    d_m = morph_dilate(raw_depth) if morph else raw_depth
    depth2, lab = bilateral_lab(
        d_m, color, cv_xyz, cv_uv, bbox_min, bbox_max, depth_limits,
        bilateral, pixel_model=pixel_model,
    )
    depth2, sil = boundary(depth2, lab, refine)
    nrm = normals(depth2, cv_xyz, pixel_model=pixel_model)
    qual = quality(depth2, nrm, cv_xyz, camera_position,
                   pixel_model=pixel_model)
    return depth2, lab, sil, nrm, qual, d_m


def lab_colors(
    colors: jnp.ndarray,        # (N, Hc, Wc, 3)
    depth_norm: jnp.ndarray,    # (N, H, W) normalized morphed depth
    pixel_models,               # stacked PixelModels tuple, or None
    cv_uv: jnp.ndarray = None,  # (N, D, Hv, Wv, 2) fallback lookup
) -> jnp.ndarray:
    """(N, H, W, 3) LAB color at depth resolution (pre_depth.fs:129-137).

    Unrolled over sensors with x-pair-packed color rows: 2 gather rows per
    pixel from a per-sensor table instead of 4 corner gathers from a
    batched one."""
    from .raymarch import _pack_pairs_2d, _pair_bilinear

    N, H, W = depth_norm.shape
    Hc, Wc = colors.shape[1:3]
    col8 = _pack_pairs_2d(
        jnp.concatenate([colors, jnp.zeros_like(colors[..., :1])], axis=-1),
        dtype=jnp.bfloat16,
    )
    # degenerate-depth pixels use the far plane (pre_depth.fs:136's z=1.0).
    # The volume path clamps z=1.0 to the last texel plane (GL
    # CLAMP_TO_EDGE); the analytic models extrapolate instead, so evaluate
    # them AT that plane to match the reference's clamped semantics.
    z_far = 1.0 - 0.5 / cv_uv.shape[1] if cv_uv is not None else 1.0
    z = jnp.where(
        (depth_norm <= 0.0) | (depth_norm >= 1.0),
        1.0 if pixel_models is None else z_far,
        depth_norm,
    )
    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    uu, vv = jnp.meshgrid(u, v)
    # model evaluation batched over ALL sensors (elementwise — the
    # per-sensor python loop staged 12+ async slices of the (N, H, W, 2/3)
    # model arrays per frame); only the color gather loops, because each
    # sensor gathers from its own table
    if pixel_models is not None:
        ray_a, ray_b, uv_p, uv_q, uv_r = pixel_models
        ze = z[..., None]
        coords_all = (uv_p + uv_q * ze) / (1.0 + uv_r * ze)  # (N, H, W, 2)
    else:
        coords_all = jnp.stack([
            trilinear_3d(cv_uv[i], jnp.stack([uu, vv, z[i]], axis=-1))
            for i in range(N)
        ])
    out = []
    for i in range(N):
        rgb = _pair_bilinear(col8[i], Hc, Wc, coords_all[i])[..., :3]
        out.append(rgb_to_lab(rgb))
    return jnp.stack(out)


def bilateral_window_sums(depth_m: jnp.ndarray, depth_limits: jnp.ndarray):
    """:func:`bilateral_sums` for all sensors: (N, H, W) metric depth +
    (N, 2) [near, far] -> three (N, H, W) sums. Lowered for CUDA this is
    the Triton kernel of ops/stencil_triton.py (faster than XLA's fusion of
    the fold on the GPU, see PERF.md); everywhere else the jnp fold."""
    from . import stencil_triton

    def fold(d, lim):
        return jax.vmap(bilateral_sums)(d, lim[:, 0], lim[:, 1])

    return jax.lax.platform_dependent(
        depth_m, depth_limits, cuda=stencil_triton.bilateral13, default=fold
    )


def quality_window_sums(depth_norm: jnp.ndarray):
    """:func:`quality_sums` for all sensors, (N, H, W) -> two (N, H, W)
    sums; the Triton kernel when lowered for CUDA, else the jnp fold."""
    from . import stencil_triton

    return jax.lax.platform_dependent(
        depth_norm, cuda=stencil_triton.quality13,
        default=jax.vmap(quality_sums),
    )


def preprocess_frames(
    depths: jnp.ndarray,       # (N, H, W) raw metric depth
    colors: jnp.ndarray,       # (N, Hc, Wc, 3)
    cv_xyz: jnp.ndarray,       # (N, D, Hv, Wv, 3)
    cv_uv: jnp.ndarray,        # (N, D, Hv, Wv, 2)
    bbox_min: jnp.ndarray,
    bbox_max: jnp.ndarray,
    depth_limits: jnp.ndarray,  # (N, 2)
    camera_positions: jnp.ndarray,  # (N, 3)
    morph: bool = True,
    bilateral: bool = True,
    refine: bool = True,
    pixel_models=None,  # calib.sensors.PixelModels (stacked over sensors)
) -> SensorMaps:
    """Staged multi-sensor preprocessing — one fused XLA program for the
    whole chain over all sensors.

    The two 13x13 window reductions (bilateral, quality census) run at the
    batch level (:func:`bilateral_window_sums`, :func:`quality_window_sums`);
    every other pass is vmapped jnp.
    """
    if pixel_models is not None:
        pm = (pixel_models.ray_a, pixel_models.ray_b, pixel_models.uv_p,
              pixel_models.uv_q, pixel_models.uv_r)
        pm_axes = 0
    else:
        pm = None
        pm_axes = None

    d_m = jax.vmap(morph_dilate)(depths) if morph else depths

    bf_sums = bilateral_window_sums(d_m, depth_limits) if bilateral else None

    # LAB color fetch hoisted out of the vmap: per-sensor pair-packed
    # gathers (see lab_colors)
    near = depth_limits[:, 0][:, None, None]
    far = depth_limits[:, 1][:, None, None]
    labs = lab_colors(colors, (d_m - near) / (far - near), pm, cv_uv)

    def front(d, c, cx, cu, dl, pm_, sums, lab_i):
        depth2, lab = bilateral_lab(
            d, c, cx, cu, bbox_min, bbox_max, dl, bilateral,
            pixel_model=pm_, bf_sums=sums, lab_in=lab_i,
        )
        depth2, sil = boundary(depth2, lab, refine)
        nrm = normals(depth2, cx, pixel_model=pm_)
        return depth2, lab, sil, nrm

    depth2, lab, sil, nrm = jax.vmap(
        front,
        in_axes=(0, 0, 0, 0, 0, pm_axes, None if bf_sums is None else 0, 0),
    )(d_m, colors, cv_xyz, cv_uv, depth_limits, pm, bf_sums, labs)

    q_sums = quality_window_sums(depth2[..., 0])
    qual = jax.vmap(quality, in_axes=(0, 0, 0, 0, pm_axes, 0))(
        depth2, nrm, cv_xyz, camera_positions, pm, q_sums
    )

    return SensorMaps(
        depth=depth2, lab=lab, silhouette=sil, normal=nrm, quality=qual,
        raw_depth=d_m, color=colors,
    )
