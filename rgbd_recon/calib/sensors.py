"""Runtime calibration container — the device-resident lookup volumes.

Replaces the reference's CalibVolumes (framework/calibration/CalibVolumes.cpp)
which owns per-sensor GL 3D textures bound to fixed texture units. Here the
set is a single pytree of stacked jnp arrays (leading sensor axis) so every
kernel can vmap over sensors and XLA sees one fused gather per lookup.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np
from ..core import pytree

from ..core.camera import SensorRig
from ..core.grid import BoundingBox
from .bake import bake_cv_xyz, bake_cv_uv, bake_cv_xyz_inv_analytic
from .frustum import frustum_from_cv_xyz


@pytree.dataclass
class SensorCalibration:
    """Single-sensor baked calibration (host-side staging)."""

    cv_xyz: jnp.ndarray       # (D, H, W, 3)
    cv_uv: jnp.ndarray        # (D, H, W, 2)
    cv_xyz_inv: jnp.ndarray   # (Dz, Hy, Wx, 4)
    depth_limits: jnp.ndarray  # (2,) near/far meters
    camera_position: jnp.ndarray  # (3,) world


@pytree.dataclass
class CalibrationSet:
    """All sensors, stacked. The runtime equivalent of CalibVolumes +
    CalibrationFiles (+ the bbox UBO, CalibVolumes.cpp:45-49)."""

    cv_xyz: jnp.ndarray        # (N, D, H, W, 3)
    cv_uv: jnp.ndarray         # (N, D, H, W, 2)
    cv_xyz_inv: jnp.ndarray    # (N, Dz, Hy, Wx, 4)
    depth_limits: jnp.ndarray  # (N, 2)
    camera_positions: jnp.ndarray  # (N, 3)
    bbox_min: jnp.ndarray      # (3,)
    bbox_max: jnp.ndarray      # (3,)

    @property
    def num_sensors(self) -> int:
        return self.cv_xyz.shape[0]

    @property
    def bbox(self) -> BoundingBox:
        return BoundingBox(
            min=tuple(np.asarray(self.bbox_min).tolist()),
            max=tuple(np.asarray(self.bbox_max).tolist()),
        )


def build_synthetic_calibration(
    rig: SensorRig,
    bbox: BoundingBox,
    cv_res: Tuple[int, int, int] = (32, 64, 32),
    inv_res: Tuple[int, int, int] = (64, 64, 64),
) -> CalibrationSet:
    """Bake a full calibration set from analytic sensors.

    cv_res is the sensor-space volume resolution (W, H, D) — the reference
    ships 128 x 256 x 128 (SURVEY.md §0); tests use smaller. inv_res is the
    world-grid resolution (X, Y, Z) of the inverse volumes.
    """
    cv_xyz_list, cv_uv_list, inv_list, limits, campos = [], [], [], [], []
    for sensor in rig.sensors:
        cv_xyz = bake_cv_xyz(sensor, cv_res)
        cv_xyz_list.append(cv_xyz)
        cv_uv_list.append(bake_cv_uv(sensor, cv_res))
        inv_list.append(bake_cv_xyz_inv_analytic(sensor, bbox, inv_res))
        limits.append([sensor.depth.near, sensor.depth.far])
        # camera position recovered the reference way — from the frustum
        # apex of the baked volume (CalibVolumes.cpp:224-230) — so that any
        # bake/parse path yields consistent positions.
        campos.append(frustum_from_cv_xyz(cv_xyz).camera_position())

    return CalibrationSet(
        cv_xyz=jnp.asarray(np.stack(cv_xyz_list)),
        cv_uv=jnp.asarray(np.stack(cv_uv_list)),
        cv_xyz_inv=jnp.asarray(np.stack(inv_list)),
        depth_limits=jnp.asarray(np.array(limits, np.float32)),
        camera_positions=jnp.asarray(np.stack(campos)),
        bbox_min=jnp.asarray(np.array(bbox.min, np.float32)),
        bbox_max=jnp.asarray(np.array(bbox.max, np.float32)),
    )


@pytree.dataclass
class PixelModels:
    """Per-depth-pixel closed forms of the calibration volumes.

    For a FIXED pixel (u, v), the baked volumes restrict to 1-D functions of
    normalized depth d:

      cv_xyz(u, v, d): world position — exactly linear in d for a pinhole
        (world = cam + dir * (near + d*(far-near))), and trilinear sampling
        preserves linear functions, so  world ~= ray_a + ray_b * d;
      cv_uv(u, v, d): color texcoord — projective, i.e. first-order
        rational:  uv ~= (uv_p + uv_q * d) / (1 + uv_r * d).

    Fitting these at setup turns every per-frame cv_xyz/cv_uv lookup in the
    preprocess chain (4 trilinear gathers per pixel in the normal pass
    alone) into pure elementwise math.
    For measured (non-pinhole) calibrations the fit residual is reported so
    callers can fall back to volume lookups (PipelineConfig.pixel_ray_model).
    """

    ray_a: jnp.ndarray   # (N, H, W, 3)
    ray_b: jnp.ndarray   # (N, H, W, 3)
    uv_p: jnp.ndarray    # (N, H, W, 2)
    uv_q: jnp.ndarray    # (N, H, W, 2)
    uv_r: jnp.ndarray    # (N, H, W, 2)

    def world(self, d: jnp.ndarray) -> jnp.ndarray:
        """(N, H, W) normalized depth -> (N, H, W, 3) world positions."""
        return self.ray_a + self.ray_b * d[..., None]

    def world_sensor(self, i: int, d: jnp.ndarray) -> jnp.ndarray:
        return self.ray_a[i] + self.ray_b[i] * d[..., None]

    def color_uv_sensor(self, i: int, d: jnp.ndarray) -> jnp.ndarray:
        de = d[..., None]
        return (self.uv_p[i] + self.uv_q[i] * de) / (1.0 + self.uv_r[i] * de)


@pytree.dataclass
class ProjectionModels:
    """Analytic world -> sensor closed forms (the inverse-direction
    counterpart of :class:`PixelModels`).

    For a pinhole sensor, the baked inverse volume cv_xyz_inv
    (calibration_inverter.cpp:99-155) encodes, at world point p:

      (u, v) = (A p + b) / (c . p + 1)   -- projective (shared denominator,
                                            the view-space depth up to scale)
      d      = g . p + h                 -- normalized depth, affine in p

    and the color texcoord cv_uv o cv_xyz_inv composes to the same projective
    form. Fitting these at setup turns the per-hit cv_xyz_inv + cv_uv
    trilinear/nearest gathers of the color blend (tsdf_raymarch.fs:303-338)
    into pure elementwise math. The fit residual is reported so callers fall
    back to volume lookups for measured, non-pinhole calibrations."""

    uv_num: jnp.ndarray    # (N, 2, 3) A
    uv_off: jnp.ndarray    # (N, 2)    b
    uv_den: jnp.ndarray    # (N, 3)    c
    d_lin: jnp.ndarray     # (N, 3)    g
    d_off: jnp.ndarray     # (N,)      h
    cuv_num: jnp.ndarray   # (N, 2, 3) color-texcoord A
    cuv_off: jnp.ndarray   # (N, 2)    b
    cuv_den: jnp.ndarray   # (N, 3)    c

    def uvd(self, i: int, p: jnp.ndarray) -> jnp.ndarray:
        """(..., 3) world -> (..., 3) (u, v, depth_norm) for sensor i."""
        den = jnp.matmul(p, self.uv_den[i], precision="highest") + 1.0
        den = jnp.where(jnp.abs(den) < 1e-8, 1e-8, den)
        uv = (jnp.matmul(p, self.uv_num[i].T, precision="highest")
              + self.uv_off[i]) / den[..., None]
        d = jnp.matmul(p, self.d_lin[i], precision="highest") + self.d_off[i]
        return jnp.concatenate([uv, d[..., None]], axis=-1)

    def color_uv(self, i: int, p: jnp.ndarray) -> jnp.ndarray:
        """(..., 3) world -> (..., 2) color texcoord for sensor i."""
        den = jnp.matmul(p, self.cuv_den[i], precision="highest") + 1.0
        den = jnp.where(jnp.abs(den) < 1e-8, 1e-8, den)
        return (jnp.matmul(p, self.cuv_num[i].T, precision="highest")
                + self.cuv_off[i]) / den[..., None]

    # -- planar forms: (R,) component arrays instead of (R, 3) with a
    #    3-wide minor axis (the hit-path blend evaluates these per sensor
    #    per hit) -------------------------------------------------------

    def uvd_p(self, i: int, px, py, pz):
        """Planar world components -> (u, v, depth_norm) planes."""
        A, b = self.uv_num[i], self.uv_off[i]
        cden = self.uv_den[i]
        den = px * cden[0] + py * cden[1] + pz * cden[2] + 1.0
        den = jnp.where(jnp.abs(den) < 1e-8, 1e-8, den)
        inv = 1.0 / den
        u = (px * A[0, 0] + py * A[0, 1] + pz * A[0, 2] + b[0]) * inv
        v = (px * A[1, 0] + py * A[1, 1] + pz * A[1, 2] + b[1]) * inv
        g, h = self.d_lin[i], self.d_off[i]
        d = px * g[0] + py * g[1] + pz * g[2] + h
        return u, v, d

    def color_uv_p(self, i: int, px, py, pz):
        """Planar world components -> (u, v) color texcoord planes."""
        A, b = self.cuv_num[i], self.cuv_off[i]
        cden = self.cuv_den[i]
        den = px * cden[0] + py * cden[1] + pz * cden[2] + 1.0
        den = jnp.where(jnp.abs(den) < 1e-8, 1e-8, den)
        inv = 1.0 / den
        u = (px * A[0, 0] + py * A[0, 1] + pz * A[0, 2] + b[0]) * inv
        v = (px * A[1, 0] + py * A[1, 1] + pz * A[1, 2] + b[1]) * inv
        return u, v


def derive_projection_models(
    cv_xyz: jnp.ndarray,   # (N, D, Hv, Wv, 3)
    cv_uv: jnp.ndarray,    # (N, D, Hv, Wv, 2)
) -> Tuple["ProjectionModels", float]:
    """Least-squares fit of ProjectionModels from the forward calibration
    volumes; returns (models, max_residual) with the residual measured at a
    held-out denser (u, v, d) grid including the depth endpoints
    (normalized units, all channels)."""
    import numpy as _np

    xyz = _np.asarray(cv_xyz, _np.float64)
    uvv = _np.asarray(cv_uv, _np.float64)
    N, D, Hv, Wv, _ = xyz.shape

    def grid(vol, nu, nv, nd):
        # sample the volume at texel-exact positions (so no interpolation
        # error enters the fit): pick texel centers on a strided subgrid
        iw = _np.linspace(0, Wv - 1, nu).round().astype(int)
        ih = _np.linspace(0, Hv - 1, nv).round().astype(int)
        idd = _np.linspace(0, D - 1, nd).round().astype(int)
        sub = vol[_np.ix_(idd, ih, iw)]
        u = (iw + 0.5) / Wv
        v = (ih + 0.5) / Hv
        d = (idd + 0.5) / D
        dd, vv_, uu = _np.meshgrid(d, v, u, indexing="ij")
        return sub.reshape(-1, vol.shape[-1]), _np.stack(
            [uu.ravel(), vv_.ravel(), dd.ravel()], axis=-1
        )

    def fit_projective(p, target):
        """target = (A p + b) / (c.p + 1): linear system in (A, b, c)."""
        M = p.shape[0]
        ones = _np.ones((M, 1))
        rows = _np.zeros((2 * M, 11))
        rhs = _np.empty(2 * M)
        for ch in range(2):
            r = slice(ch * M, (ch + 1) * M)
            rows[r, ch * 4 : ch * 4 + 3] = p
            rows[r, ch * 4 + 3] = 1.0
            rows[r, 8:11] = -target[:, ch : ch + 1] * p
            rhs[r] = target[:, ch]
        sol, *_ = _np.linalg.lstsq(rows, rhs, rcond=None)
        A = _np.stack([sol[0:3], sol[4:7]])
        b = _np.array([sol[3], sol[7]])
        c = sol[8:11]
        return A, b, c

    out = {k: [] for k in ("uv_num", "uv_off", "uv_den", "d_lin", "d_off",
                           "cuv_num", "cuv_off", "cuv_den")}
    max_res = 0.0
    for i in range(N):
        world, uvd = grid(xyz[i], 9, 9, 7)
        A, b, c = fit_projective(world, uvd[:, :2])
        ph = _np.concatenate([world, _np.ones((world.shape[0], 1))], axis=-1)
        gh, *_ = _np.linalg.lstsq(ph, uvd[:, 2], rcond=None)
        # color texcoord: cv_uv sampled at the SAME sensor-space grid gives
        # the composed world -> color map directly
        cuv_t, _ = grid(uvv[i], 9, 9, 7)
        A2, b2, c2 = fit_projective(world, cuv_t)

        # held-out residual on a denser grid incl. depth endpoints
        world_h, uvd_h = grid(xyz[i], 13, 13, D if D <= 16 else 16)
        den = world_h @ c + 1.0
        uv_m = (world_h @ A.T + b) / den[:, None]
        d_m = world_h @ gh[:3] + gh[3]
        res = _np.abs(_np.concatenate(
            [uv_m - uvd_h[:, :2], (d_m - uvd_h[:, 2])[:, None]], axis=-1
        )).max()
        cuv_h, _ = grid(uvv[i], 13, 13, D if D <= 16 else 16)
        den2 = world_h @ c2 + 1.0
        cuv_m = (world_h @ A2.T + b2) / den2[:, None]
        res = max(res, _np.abs(cuv_m - cuv_h).max())
        max_res = max(max_res, float(res))

        out["uv_num"].append(A)
        out["uv_off"].append(b)
        out["uv_den"].append(c)
        out["d_lin"].append(gh[:3])
        out["d_off"].append(gh[3])
        out["cuv_num"].append(A2)
        out["cuv_off"].append(b2)
        out["cuv_den"].append(c2)

    models = ProjectionModels(
        **{
            k: jnp.asarray(_np.stack(v).astype(_np.float32))
            for k, v in out.items()
        }
    )
    return models, max_res


def derive_pixel_models(
    cv_xyz: jnp.ndarray,   # (N, D, Hv, Wv, 3)
    cv_uv: jnp.ndarray,    # (N, D, Hv, Wv, 2)
    depth_hw: Tuple[int, int],
) -> Tuple["PixelModels", float]:
    """Fit PixelModels at depth-map pixel centers; returns (models,
    max_residual) where the residual is the max |model - trilinear volume|
    over control depths (normalized units, both channels)."""
    from ..ops.sampling import trilinear_3d
    import jax

    H, W = depth_hw
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    base = jnp.asarray(np.stack([uu, vv], axis=-1))

    def at_depth(vol, d):
        coords = jnp.concatenate(
            [base, jnp.full((H, W, 1), d, jnp.float32)], axis=-1
        )
        return trilinear_3d(vol, coords)

    @jax.jit
    def fit(cv_xyz, cv_uv):
        def one(args):
            vol_xyz, vol_uv = args
            d0, d1 = 0.25, 0.75
            w0 = at_depth(vol_xyz, d0)
            w1 = at_depth(vol_xyz, d1)
            ray_b = (w1 - w0) / (d1 - d0)
            ray_a = w0 - ray_b * d0

            # rational fit (p + q d)/(1 + r d) per channel from 3 samples:
            # the system  p + q di - ui r di = ui  is linear in (p, q, r).
            # Solved in closed form; pixels whose uv is (near-)constant in
            # depth make it singular and fall back to the exact linear fit
            # (r = 0) through the end samples.
            d1, d2, d3 = 0.2, 0.5, 0.8
            u1 = at_depth(vol_uv, d1)
            u2 = at_depth(vol_uv, d2)
            u3 = at_depth(vol_uv, d3)
            # eliminate p: (eq2-eq1), (eq3-eq1) in unknowns (q, r)
            a11, a12, b1 = d2 - d1, -(u2 * d2 - u1 * d1), u2 - u1
            a21, a22, b2 = d3 - d1, -(u3 * d3 - u1 * d1), u3 - u1
            det = a11 * a22 - a12 * a21
            ok = jnp.abs(det) > 1e-8
            det_safe = jnp.where(ok, det, 1.0)
            uv_r = jnp.where(ok, (a11 * b2 - a21 * b1) / det_safe, 0.0)
            # a pole of the rational inside the depth range means the pixel's
            # color projection is degenerate there (behind/crossing the color
            # camera plane) — use the linear fallback for those pixels too
            ok = ok & (jnp.minimum(1.0 + uv_r * 0.0, 1.0 + uv_r * 1.0) > 0.1)
            uv_r = jnp.where(ok, uv_r, 0.0)
            uv_q = jnp.where(
                ok, (b1 * a22 - b2 * a12) / det_safe, (u3 - u1) / (d3 - d1)
            )
            uv_p = u1 + (u1 * uv_r - uv_q) * d1

            # residuals at held-out depths, including near the endpoints:
            # the preprocess chain evaluates the models across (0, 1) and —
            # for degenerate-depth pixels — at the far texel plane (the
            # clamped equivalent of pre_depth.fs:136's z = 1.0), so
            # extrapolation error there must be inside the gate too
            D = vol_xyz.shape[0]
            z_far = 1.0 - 0.5 / D
            res = jnp.float32(0.0)
            for d in (0.05, 0.35, 0.65, 0.95, z_far):
                wm = ray_a + ray_b * d
                res = jnp.maximum(res, jnp.max(jnp.abs(wm - at_depth(vol_xyz, d))))
                um = (uv_p + uv_q * d) / (1.0 + uv_r * d)
                res = jnp.maximum(res, jnp.max(jnp.abs(um - at_depth(vol_uv, d))))
            return ray_a, ray_b, uv_p, uv_q, uv_r, res

        return jax.lax.map(one, (cv_xyz, cv_uv))

    ray_a, ray_b, uv_p, uv_q, uv_r, res = fit(cv_xyz, cv_uv)
    return (
        PixelModels(ray_a=ray_a, ray_b=ray_b, uv_p=uv_p, uv_q=uv_q, uv_r=uv_r),
        float(jnp.max(res)),
    )
