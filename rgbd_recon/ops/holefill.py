"""Pull-push hole filling (inpaint + colorfill) over a mip pyramid.

Replicates the reference's multi-LOD fill (fillColors,
recon_integration.cpp:280-339) with its two kernels:

  pull  glsl/tsdf_inpaint.fs   LOD l -> l+1: 4x4 window (offsets -1..+2),
        invalid samples (alpha <= 0) dropped; among valid samples only those
        at or behind the average depth contribute (:75-85) — holes fill from
        the far side.
  push  glsl/tsdf_colorfill.fs LOD0 output: walk up the pyramid to the first
        valid level (:36-40); if the base level was invalid, blend the two
        coarser levels bilinearly (:42-52). The final depth is the LOD0
        depth verbatim (:54).

Design difference (documented, intentional): the reference packs all LODs
into one 1.5w x h atlas because GL wants a single texture (ViewLod,
framework/rendering/view_lod.cpp:24-61); here the pyramid is a plain list of
per-LOD arrays — the atlas packing is a GL artifact with no benefit here
(SURVEY.md §7 step 4). The reference's push-blend weight
``distance(pass_TexCoord, floor(pass_TexCoord))`` (tsdf_colorfill.fs:47) —
i.e. the screen-position norm — is reproduced verbatim for parity.

Layout note: all internals are CHANNEL-PLANAR — lists of (H, W) planes —
so the minor (contiguous) dimension is the image W, not the 4-wide channel
axis. The (H, W, 4) public signatures are kept — they split/repack at the
boundary (two cheap relayouts per frame).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

PLANES = 4  # r, g, b, alpha


@lru_cache(maxsize=256)
def _phase_matrix(n_out: int, n_src: int, offset: int) -> np.ndarray:
    """(n_out, n_src) 0/1 selection matrix: out[r] = src[offset + 2r] —
    stride-2 de-interleave as a matmul (in place of a strided slice x[::2]
    on the minor axis; whether the matmul or the slice is cheaper on the
    GPU is an open measurement)."""
    m = np.zeros((n_out, n_src), np.float32)
    rows = np.arange(n_out)
    cols = offset + 2 * rows
    ok = cols < n_src
    m[rows[ok], cols[ok]] = 1.0
    return m


def _pull_planar(
    planes: Sequence[jnp.ndarray], depth: jnp.ndarray
) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """One pull step on planar channels: 5x (H, W) -> 5x (H2, W2).

    planes = [r, g, b, alpha]; exact math of tsdf_inpaint.fs:34-90.
    """
    H, W = depth.shape
    H2, W2 = max(H // 2, 1), max(W // 2, 1)

    # Offsets are -1..+2 around even texels. Split each plane ONCE into its
    # 4 even/odd phase planes via selection matmuls (see _phase_matrix;
    # full precision keeps the selection exact), after which every tap
    # is a contiguous slice of a quarter-size plane — identical values.
    stack = jnp.stack(list(planes) + [depth])           # (C, H, W)
    q = jnp.pad(
        stack, [(0, 0), (1, 2 + 2 * H2 - H), (1, 2 + 2 * W2 - W)],
        mode="edge",
    )
    Hq, Wq = q.shape[1:]
    ph = {}
    for by in (0, 1):
        my = jnp.asarray(_phase_matrix(H2 + 2, Hq, by))
        py = jnp.einsum("hk,ckw->chw", my, q, precision="highest",
                        preferred_element_type=jnp.float32)
        for bx in (0, 1):
            mx = jnp.asarray(_phase_matrix(W2 + 2, Wq, bx))
            ph[(by, bx)] = jnp.einsum("wk,chk->chw", mx, py, precision="highest",
                                      preferred_element_type=jnp.float32)

    def fetch_c(c):
        def fetch(dy, dx):
            # input row 2j + dy maps into phase (dy+1)%2 at offset (dy+1)//2
            sy, by = divmod(dy + 1, 2)
            sx, bx = divmod(dx + 1, 2)
            return ph[(by, bx)][c, sy : sy + H2, sx : sx + W2]

        return fetch

    fr, fg, fb, fa = (fetch_c(i) for i in range(4))
    fd = fetch_c(4)

    sum_d = jnp.zeros((H2, W2), jnp.float32)
    cnt = jnp.zeros((H2, W2), jnp.float32)

    samples = []  # (r, g, b, d, valid) per offset; two-phase like the shader
    for dx in range(-1, 3):
        for dy in range(-1, 3):
            valid = fa(dy, dx) > 0.0
            d = fd(dy, dx)
            sum_d = sum_d + jnp.where(valid, d, 0.0)
            cnt = cnt + valid.astype(jnp.float32)
            samples.append((fr(dy, dx), fg(dy, dx), fb(dy, dx), d, valid))

    depth_av = sum_d / jnp.maximum(cnt, 1.0)

    tot = [jnp.zeros((H2, W2), jnp.float32) for _ in range(3)]
    total_d = jnp.zeros((H2, W2), jnp.float32)
    total_w = jnp.zeros((H2, W2), jnp.float32)
    for r, g, b, d, valid in samples:
        keep = valid & (d >= depth_av)  # :77 — fill from the far side
        tot[0] = tot[0] + jnp.where(keep, r, 0.0)
        tot[1] = tot[1] + jnp.where(keep, g, 0.0)
        tot[2] = tot[2] + jnp.where(keep, b, 0.0)
        total_d = total_d + jnp.where(keep, d, 0.0)
        total_w = total_w + keep.astype(jnp.float32)

    w = jnp.maximum(total_w, 1.0)

    # no valid sample: propagate the center depth; alpha -1 marks a fillable
    # hole, the (0,1,0,0) marker is background (:59-68)
    center_d = fd(0, 0)
    hole = center_d < 1.0
    has = cnt > 0

    out = [
        jnp.where(has, tot[0] / w, 0.0),
        jnp.where(has, tot[1] / w, jnp.where(hole, 0.0, 1.0)),
        jnp.where(has, tot[2] / w, 0.0),
        jnp.where(has, 1.0, jnp.where(hole, -1.0, 0.0)),  # alpha
    ]
    d_out = jnp.where(has, total_d / w, center_d)
    return out, d_out


def pull(
    color: jnp.ndarray, depth: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One pull step: (H, W, 4), (H, W) -> (H//2, W//2, 4), (H//2, W//2).

    tsdf_inpaint.fs:34-90. Thin packed-layout wrapper over the planar core.
    """
    planes, d = _pull_planar(
        [color[..., i] for i in range(PLANES)], depth
    )
    return jnp.stack(planes, axis=-1), d


def _build_pyramid_planar(
    planes0: Sequence[jnp.ndarray], depth0: jnp.ndarray, num_lods: int
) -> Tuple[List[List[jnp.ndarray]], List[jnp.ndarray]]:
    """Repeated pull (the inpaint loop, recon_integration.cpp:286-309)."""
    colors, depths = [list(planes0)], [depth0]
    for _ in range(num_lods - 1):
        if min(depths[-1].shape) <= 1:
            break
        c, d = _pull_planar(colors[-1], depths[-1])
        colors.append(c)
        depths.append(d)
    return colors, depths


def build_pyramid(
    color0: jnp.ndarray, depth0: jnp.ndarray, num_lods: int
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Packed-layout pyramid (compat wrapper)."""
    colors, depths = _build_pyramid_planar(
        [color0[..., i] for i in range(PLANES)], depth0, num_lods
    )
    return [jnp.stack(c, axis=-1) for c in colors], depths


@lru_cache(maxsize=64)
def _nearest_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) 0/1 row-selection matrix: out[i] = in[i * n_in // n_out]
    — the nearest-texel fetch of push() as a linear map."""
    m = np.zeros((n_out, n_in), np.float32)
    src = np.clip(np.arange(n_out) * n_in // n_out, 0, n_in - 1)
    m[np.arange(n_out), src] = 1.0
    return m


@lru_cache(maxsize=64)
def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix reproducing GL bilinear sampling of
    an n_in-texel axis at the n_out pixel centers (sampling.py semantics:
    x = c*n_in - 0.5, taps floor(x), floor(x)+1 clamped to the edge). Exact:
    bilinear sampling is linear in the texel values, so the matrix form is
    bit-equivalent up to f32 summation order."""
    m = np.zeros((n_out, n_in), np.float32)
    c = (np.arange(n_out, dtype=np.float64) + 0.5) / n_out
    x = c * n_in - 0.5
    x0 = np.floor(x)
    fx = x - x0
    i0 = np.clip(x0.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, n_in - 1)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), (1.0 - fx).astype(np.float32))
    np.add.at(m, (rows, i1), fx.astype(np.float32))
    return m


def _resample_matmul(planes: Sequence[jnp.ndarray], my: np.ndarray,
                     mx: np.ndarray) -> List[jnp.ndarray]:
    """[(Hl, Wl)] -> [(H, W)] via separable interpolation matmuls.
    my: (H, Hl), mx: (W, Wl). Replaces per-pixel gathers (4 rows per pixel
    per level) with dense matmuls, run at full f32 precision: TF32 would
    round the interpolated colors and depths to ~3 decimal digits."""
    myj, mxj = jnp.asarray(my), jnp.asarray(mx)
    stackl = jnp.stack(planes)                      # (C, Hl, Wl)
    a = jnp.einsum("hk,ckw->chw", myj, stackl, precision="highest",
                   preferred_element_type=jnp.float32)
    out = jnp.einsum("wk,chk->chw", mxj, a, precision="highest",
                     preferred_element_type=jnp.float32)
    return [out[i] for i in range(len(planes))]


def _push_planar(
    colors: List[List[jnp.ndarray]], depths: List[jnp.ndarray]
) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """Colorfill on planar channels (tsdf_colorfill.fs:30-55)."""
    H, W = depths[0].shape
    L = len(colors)

    # nearest-texel fetch of every level at this pixel (:36-40)
    fetched = [
        colors[0] if l == 0 else _resample_matmul(
            colors[l],
            _nearest_matrix(H, len(colors[l][0])),
            _nearest_matrix(W, colors[l][0].shape[1]),
        )
        for l in range(L)
    ]

    valid = jnp.stack([f[3] > 0.0 for f in fetched])  # (L, H, W)
    # first valid level; if none, stays at L-1
    level = jnp.argmax(valid, axis=0).astype(jnp.int32)
    level = jnp.where(jnp.any(valid, axis=0), level, L - 1)

    def select_level(per_level: List[List[jnp.ndarray]], lvl):
        # per-pixel level selection as an elementwise where-chain (L is
        # small/static) — fuses into the surrounding pass instead of
        # lowering to a full-screen gather row per pixel
        out = list(per_level[L - 1])
        for l in range(L - 2, -1, -1):
            sel = lvl == l
            out = [jnp.where(sel, per_level[l][c], out[c])
                   for c in range(PLANES)]
        return out

    base = select_level(fetched, level)

    # bilinear samples of every level at the pixel's texcoord, for the
    # level>0 blend path (:42-52); level 0 is never selected as a blend
    # source (l1 = level+1 >= 1)
    zeros = [jnp.zeros((H, W), jnp.float32)] * PLANES
    bilin = [zeros] + [
        _resample_matmul(
            colors[l],
            _bilinear_matrix(H, len(colors[l][0])),
            _bilinear_matrix(W, colors[l][0].shape[1]),
        )
        for l in range(1, L)
    ]

    l1 = jnp.clip(level + 1, 0, L - 1)
    l2 = jnp.clip(level + 2, 0, L - 1)
    c1 = select_level(bilin, l1)
    c2 = select_level(bilin, l2)
    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    uu, vv = jnp.meshgrid(u, v)
    # the reference's screen-position weight quirk (:47-48)
    w1 = jnp.sqrt(uu**2 + vv**2)
    w2 = 1.0 - w1
    denom = jnp.where(jnp.abs(w1 + w2) < 1e-20, 1e-20, w1 + w2)
    filled = level > 0
    out = [
        jnp.where(filled, (c1[c] * w1 + c2[c] * w2) / denom, base[c])
        for c in range(PLANES)
    ]
    return out, depths[0]


def push(
    colors: List[jnp.ndarray], depths: List[jnp.ndarray]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Packed-layout colorfill (compat wrapper): returns
    (rgba (H, W, 4), depth (H, W))."""
    out, d = _push_planar(
        [[c[..., i] for i in range(PLANES)] for c in colors], depths
    )
    return jnp.stack(out, axis=-1), d


def fill_colors(
    color0: jnp.ndarray, depth0: jnp.ndarray, num_lods: int = 7
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full pull-push pass (ReconIntegration::fillColors,
    recon_integration.cpp:280-339)."""
    out, d = fill_colors_planar(
        [color0[..., i] for i in range(PLANES)], depth0, num_lods
    )
    return jnp.stack(out, axis=-1), d


def fill_colors_planar(
    planes0: Sequence[jnp.ndarray], depth0: jnp.ndarray, num_lods: int = 7
) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """Planar-layout full pass: [r, g, b, a], depth -> same at full res.
    The form the render pipeline calls (no packed relayout on the hot
    path)."""
    import jax

    colors, depths = _build_pyramid_planar(planes0, depth0, num_lods)
    # each level feeds several push consumers (nearest fetch, bilinear
    # blend, validity chain); without a barrier XLA rematerializes the
    # pull chain into each consumer, ~doubling the whole pass (measured)
    colors, depths = jax.lax.optimization_barrier((colors, depths))
    return _push_planar(colors, depths)
