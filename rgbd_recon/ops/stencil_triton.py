"""13x13 window sums of the bilateral and quality passes as Pallas kernels
for the GPU, through the Triton route.

Each program owns one (sensor, 32x64 output tile). It reads the tile's
6-pixel halo from the edge-padded map as shifted tile loads (served by
L1/L2) and keeps the three (bilateral) or two (quality) accumulators in
registers; nothing is carried between programs. The 13 window rows are a
loop inside the program (the 13 columns are unrolled), which keeps the
Triton program small enough to compile quickly. Accumulation order (dy
outer, dx inner) matches the jnp fold in ops/preprocess.py, and the
bilateral spatial weights come from the same host-computed table.

``ops.preprocess.window_sums`` picks these kernels when the program is
lowered for CUDA and the jnp fold everywhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_KS = 6
_NR = 2 * _KS + 1
_TH, _TW = 32, 64


def _pad_tiles(d: jnp.ndarray):
    """(N, H, W) -> edge-padded (N, Hp + 12, Wp + 12) with Hp, Wp tile
    multiples, so every shifted tile load is in bounds."""
    N, H, W = d.shape
    hp, wp = -(-H // _TH) * _TH, -(-W // _TW) * _TW
    return jnp.pad(
        d, ((0, 0), (_KS, _KS + hp - H), (_KS, _KS + wp - W)), mode="edge"
    ), hp, wp


def _gauss_space_table() -> np.ndarray:
    """(13 * 13,) spatial weights 1 - |(dy, dx)| / 6 (pre_depth.fs:38-41),
    rounded to f32 as the jnp fold's constants are."""
    dy, dx = np.meshgrid(np.arange(-_KS, _KS + 1), np.arange(-_KS, _KS + 1),
                         indexing="ij")
    g = 1.0 - np.sqrt((dx * dx + dy * dy).astype(np.float32)) / _KS
    return g.astype(np.float32).reshape(-1)


def _row_loop(d_ref, r0, c0, body, init):
    """fori over the 13 window rows; ``body(acc, s, r, dx)`` per tap."""
    from jax.experimental import pallas as pl

    def row(r, acc):
        for dx in range(-_KS, _KS + 1):
            s = d_ref[pl.ds(r0 + r, _TH), pl.ds(c0 + _KS + dx, _TW)]
            acc = body(acc, s, r, dx)
        return acc

    return jax.lax.fori_loop(0, _NR, row, init)


def _bilateral_kernel(lim_ref, g_ref, d_ref, bf_ref, w_ref, wr_ref):
    from jax.experimental import pallas as pl

    r0 = pl.program_id(1) * _TH
    c0 = pl.program_id(2) * _TW
    near = lim_ref[0]
    far = lim_ref[1]
    d = d_ref[pl.ds(r0 + _KS, _TH), pl.ds(c0 + _KS, _TW)]
    drm = 0.35 * d / 4.5  # dist_range_max, pre_depth.fs:89-91
    drm_safe = jnp.maximum(drm, 1e-20)

    def tap(acc, s, r, dx):
        bf, w, wr = acc
        gs = g_ref[pl.ds(r * _NR + (dx + _KS), 1)]
        depth_range = jnp.abs(s - d)
        border = (s < near) | (s > far) | (depth_range > drm)
        gauss_range = 1.0 - jnp.minimum(depth_range, drm) / drm_safe
        w_s = jnp.where(border, 0.0, gs * gauss_range)
        return (bf + w_s * s, w + w_s,
                wr + jnp.where(border, 0.0, gauss_range))

    zero = jnp.zeros_like(d)
    bf, w, wr = _row_loop(d_ref, r0, c0, tap, (zero, zero, zero))
    bf_ref[...] = bf
    w_ref[...] = w
    wr_ref[...] = wr


def _quality_kernel(d_ref, border_ref, wr_ref):
    from jax.experimental import pallas as pl

    r0 = pl.program_id(1) * _TH
    c0 = pl.program_id(2) * _TW
    d = d_ref[pl.ds(r0 + _KS, _TH), pl.ds(c0 + _KS, _TW)]
    drm = 0.35 * d  # pre_quality.fs:71-75, max_depth = 1 in normalized units
    drm_safe = jnp.maximum(drm, 1e-20)

    def tap(acc, s, r, dx):
        border, wr = acc
        depth_range = jnp.abs(s - d)
        is_border = (s <= 0.0) | (s >= 1.0) | (depth_range > drm)
        gauss_range = 1.0 - jnp.minimum(depth_range, drm) / drm_safe
        return (border + is_border.astype(d.dtype),
                wr + jnp.where(is_border, 0.0, gauss_range))

    zero = jnp.zeros_like(d)
    border, wr = _row_loop(d_ref, r0, c0, tap, (zero, zero))
    border_ref[...] = border
    wr_ref[...] = wr


def _call(kernel, n_out, padded, hp, wp, per_sensor=(), shared=(),
          interpret=False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    N, Hq, Wq = padded.shape
    out = jax.ShapeDtypeStruct((N, hp, wp), jnp.float32)
    out_spec = pl.BlockSpec((None, _TH, _TW), lambda n, i, j: (n, i, j))
    in_specs = [pl.BlockSpec((None, a.shape[1]), lambda n, i, j: (n, 0))
                for a in per_sensor]
    in_specs += [pl.BlockSpec(a.shape, lambda n, i, j: (0,)) for a in shared]
    in_specs.append(pl.BlockSpec((None, Hq, Wq), lambda n, i, j: (n, 0, 0)))
    return pl.pallas_call(
        kernel,
        grid=(N, hp // _TH, wp // _TW),
        in_specs=in_specs,
        out_specs=(out_spec,) * n_out,
        out_shape=(out,) * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*per_sensor, *shared, padded)


@functools.partial(jax.jit, static_argnames=("interpret",))
def bilateral13(depth_m, depth_limits, interpret: bool = False):
    """(N, H, W) metric depth + (N, 2) [near, far] ->
    (depth_bf_sum, weight_sum, range_weight_sum), each (N, H, W)."""
    N, H, W = depth_m.shape
    padded, hp, wp = _pad_tiles(depth_m)
    res = _call(_bilateral_kernel, 3, padded, hp, wp,
                per_sensor=(depth_limits.astype(jnp.float32),),
                shared=(jnp.asarray(_gauss_space_table()),),
                interpret=interpret)
    return tuple(r[:, :H, :W] for r in res)


@functools.partial(jax.jit, static_argnames=("interpret",))
def quality13(depth_norm, interpret: bool = False):
    """(N, H, W) normalized depth -> (border_count, range_weight_sum)."""
    N, H, W = depth_norm.shape
    padded, hp, wp = _pad_tiles(depth_norm)
    res = _call(_quality_kernel, 2, padded, hp, wp, interpret=interpret)
    return tuple(r[:, :H, :W] for r in res)
