"""Sensor-pose refinement: Gauss-Newton over depth-to-TSDF residuals.

New capability beyond the reference (BASELINE.json north star): the
reference trusts its offline calibration; drift between sensors shows up as
doubled surfaces. Here each sensor gets a 6-DoF correction (rotation vector
+ translation) estimated by minimizing the fused TSDF sampled at that
sensor's observed surface points:

  r_ij = TSDF( T_i · x_ij )          x_ij = cv_xyz_i(u_j, v_j, d_ij)
  E = sum_ij  w_ij · r_ij²

Gauss-Newton with Levenberg damping; the 6x6 normal equations per sensor are
built as reductions over pixels (J^T W J, J^T W r). Under the device mesh
(dist/), pixels shard across chips and these small reductions become `psum`s
— the Schur-style reduce-then-solve pattern over collectives; the solve
itself is a trivial 6x6 on every chip.

All Jacobians come from `jax.jacfwd` through the trilinear TSDF sampling —
the whole pipeline is differentiable, so this module is ~100 lines instead
of hand-derived derivative code.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.sampling import trilinear_3d


def _rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (3,) -> rotation matrix (3,3), small-angle safe AND
    differentiable at w = 0 (uses sinc-style coefficients on theta² so no
    sqrt(0) appears in the gradient graph)."""
    theta2 = jnp.sum(w * w)
    small = theta2 < 1e-12
    # double-where: keep sqrt/div off the zero input so the *gradient* of
    # the untaken branch cannot produce NaN (standard JAX where-grad trap)
    safe_t2 = jnp.where(small, 1.0, theta2)
    safe_t = jnp.sqrt(safe_t2)
    # sin(t)/t and (1-cos(t))/t² with stable small-angle expansions
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_t) / safe_t)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_t)) / safe_t2)
    K = jnp.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )
    return jnp.eye(3) + a * K + b * jnp.matmul(K, K, precision="highest")


def apply_pose(params: jnp.ndarray, points: jnp.ndarray,
               center=0.0) -> jnp.ndarray:
    """params (6,) = [rotation vector (3), translation (3)] applied to world
    points (..., 3): x' = R (x - center) + center + t.

    ``center`` should be the scene (bbox) center: rotating about the WORLD
    ORIGIN couples rotation and translation over the ~2 m lever arm of the
    scene, and the solver's zero-correction prior then biases the estimate
    along that coupled valley — measured at reference scale as corrections
    that LOWER the residual while INCREASING the true pose error. About
    the scene center the two blocks are near-orthogonal and the prior
    penalizes physically meaningful magnitudes.

    Full matmul precision: a TF32 product keeps ~3 decimal digits, which
    adds millimeter-scale noise to every transformed point — larger than
    the alignment signal being optimized."""
    R = _rodrigues(params[:3])
    return (
        jnp.matmul(points - center, R.T,
                   precision=jax.lax.Precision.HIGHEST)
        + center + params[3:]
    )


def _surface_points(calib, maps, sensor: int, stride: int = 1):
    """Observed world-space surface points of one sensor + weights.

    Uses the processed depth's valid pixels through cv_xyz — the same
    lookup the integration uses."""
    depth2 = maps.depth[sensor]
    H, W = depth2.shape[:2]
    u = (jnp.arange(0, W, stride, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(0, H, stride, dtype=jnp.float32) + 0.5) / H
    uu, vv = jnp.meshgrid(u, v)
    d = depth2[::stride, ::stride, 0]
    q = maps.quality[sensor, ::stride, ::stride]
    valid = (d > 0.0) & (d < 1.0)
    pts = trilinear_3d(calib.cv_xyz[sensor], jnp.stack([uu, vv, d], axis=-1))
    w = jnp.where(valid, jnp.maximum(q, 1e-4), 0.0)
    return pts.reshape(-1, 3), w.reshape(-1)


def _tsdf_at(volume, bbox_min, bbox_size, world: jnp.ndarray) -> jnp.ndarray:
    norm = (world - bbox_min) / bbox_size
    return trilinear_3d(volume[..., None], norm)[..., 0]


def _obs_at(obs, bbox_min, bbox_size, world: jnp.ndarray) -> jnp.ndarray:
    """Nearest-voxel observer-count sample (counts are piecewise-constant;
    trilinear would blur hard coverage boundaries)."""
    Z, Y, X = obs.shape
    n = (world - bbox_min) / bbox_size
    xi = jnp.clip((n[..., 0] * X).astype(jnp.int32), 0, X - 1)
    yi = jnp.clip((n[..., 1] * Y).astype(jnp.int32), 0, Y - 1)
    zi = jnp.clip((n[..., 2] * Z).astype(jnp.int32), 0, Z - 1)
    return obs.reshape(-1)[(zi * Y + yi) * X + xi]


def _obs_weight(obs, bbox_min, bbox_size, world, min_observers):
    """SOFT contamination weight from the observer count at a point:
    1.0 for a full multi-witness consensus, 0.3 for single-witness regions
    (valid but fragile — the lone witness may itself be imperfect), 0 for
    voxels no other sensor observed. Hard >= 2 masking starves the solver
    where coverage is thin (measured at coarse scales: near-zero active
    sets); zeroing only the unobserved regions plus downweighting fragile
    ones keeps the step well-conditioned AND uncontaminated."""
    c = _obs_at(obs, bbox_min, bbox_size, world)
    full = (c >= min_observers - 0.5).astype(jnp.float32)
    single = ((c >= 0.5) & (c < min_observers - 0.5)).astype(jnp.float32)
    return full + 0.3 * single


def _gradient_trim(J, wm, k: float = 2.0):
    """Zero the weight of points whose TSDF gradient magnitude is an
    outlier. The translation block of J IS the volume gradient (chain
    rule), so |J[:, 3:]| measures it for free. A clean truncated SDF has
    |grad| ~= 1 in band-per-band units everywhere on the surface; the
    TRANSITION zones around unknown (-limit) regions of a leave-one-out
    consensus jump by the full band over one voxel — gradients several
    times larger — and those are exactly the contaminated residuals that
    bias the pose solve (measured at reference scale: the solver walked
    AWAY from the true pose until these were trimmed)."""
    gn = jnp.linalg.norm(J[:, 3:], axis=1)
    m = jnp.sum(gn * wm) / jnp.maximum(jnp.sum(wm), 1e-20)
    return jnp.where(gn < k * m, wm, 0.0)


def _normal_equations(params, pts, w, volume, bbox_min, bbox_size, limit,
                      center=0.0, mask_floor=None, observers=None,
                      min_observers: float = 2.0):
    """(J^T W J (6,6), J^T W r (6,), mean |r|) for one sensor.

    ``observers`` masks residuals to voxels at least ``min_observers``
    OTHER sensors actually observed (contamination-aware consensus):
    surface patches seen by a single — possibly drifted — sensor, and the
    biased transition zones around them, carry no weight."""

    def resid_fn(p):
        moved = apply_pose(p, pts, center)
        r = _tsdf_at(volume, bbox_min, bbox_size, moved)
        # only near-surface samples constrain the pose (|tsdf| < limit
        # means within the truncation band)
        # ASYMMETRIC active set: regions observed only by the sensor
        # being refined are unknown (-limit) in the leave-one-out
        # consensus, and trilinear samples in the TRANSITION zone around
        # them read deep NEGATIVE values that do not vanish at the true
        # pose — measured at reference scale as a bias that drags the
        # solve the wrong way. ``mask_floor`` trims that negative tail
        # (callers set it to -max(band/2, nominal_limit)); positive
        # residuals are always genuine (in front of an observed surface).
        floor = -limit * 0.999 if mask_floor is None else mask_floor
        mask = (r > floor) & (r < limit * 0.999) & (w > 0.0)
        ow = 1.0
        if observers is not None:
            ow = _obs_weight(
                observers, bbox_min, bbox_size, moved, min_observers
            )
        return r, mask, ow

    r, mask, ow = resid_fn(params)
    # forward-mode: 6 JVPs for the (P, 6) Jacobian — reverse mode would run
    # one VJP per residual (P of them)
    J = jax.jacfwd(lambda p: resid_fn(p)[0])(params)  # (P, 6)
    wm = jnp.where(mask, w * ow, 0.0)
    wm = _gradient_trim(J, wm)
    JtWJ = jnp.matmul(J.T, J * wm[:, None], precision="highest")
    JtWr = jnp.matmul(J.T, r * wm, precision="highest")
    denom = jnp.maximum(jnp.sum(wm > 0), 1)
    return JtWJ, JtWr, jnp.sum(jnp.abs(r) * (wm > 0)) / denom


def _normal_equations_mesh(
    params, pts, w, volume, bbox_min, bbox_size, limit, mesh,
    axis_name: str = "z", center=0.0, mask_floor=None,
):
    """(J^T W J, J^T W r, mean |r|) with the POINT axis sharded over the
    mesh: each device reduces its point shard, the 6x6 / 6-vector partials
    meet in `jax.lax.psum` — the Schur-style reduce-then-solve
    pattern promised in the module docstring. ``pts``/``w`` must have their
    leading axis length divisible by the mesh size (pad with w = 0)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(params, pts_l, w_l, volume, bbox_min, bbox_size):
        def resid_fn(p):
            moved = apply_pose(p, pts_l, center)
            r = _tsdf_at(volume, bbox_min, bbox_size, moved)
            # asymmetric active set — see _normal_equations
            floor = -limit * 0.999 if mask_floor is None else mask_floor
            mask = (r > floor) & (r < limit * 0.999) & (w_l > 0.0)
            return r, mask

        r, mask = resid_fn(params)
        J = jax.jacfwd(lambda p: resid_fn(p)[0])(params)
        wm = jnp.where(mask, w_l, 0.0)
        # NOTE: the trim statistic is per-shard here (close enough — the
        # shards are random subsets of the same point population)
        wm = _gradient_trim(J, wm)
        JtWJ = jax.lax.psum(
            jnp.matmul(J.T, J * wm[:, None], precision="highest"), axis_name)
        JtWr = jax.lax.psum(jnp.matmul(J.T, r * wm, precision="highest"), axis_name)
        num = jax.lax.psum(jnp.sum(jnp.abs(r) * (wm > 0)), axis_name)
        den = jax.lax.psum(jnp.sum(wm > 0).astype(jnp.float32), axis_name)
        return JtWJ, JtWr, num / jnp.maximum(den, 1.0)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(params, pts, w, volume, bbox_min, bbox_size)


def leave_one_out_volumes(pipeline, maps, brick_counts,
                          limit=None, return_observers: bool = False):
    """(N, Z, Y, X) stack of TSDF volumes, volume i fused WITHOUT sensor i.

    ``limit`` overrides the truncation band (a traced scalar, so no
    recompile) — pose refinement fuses wide-band volumes so large drifts
    stay inside the band (coarse-to-fine schedule).

    Refining a sensor against the volume its own (misaligned) depth
    contributed to is self-confirming: the doubled surface it created pulls
    its residual toward zero. Each sensor must instead be aligned against
    the consensus of the *other* sensors. Sensor i is neutralised by giving
    it an always-skip depth (sdist >= limit everywhere), a full silhouette
    (no carving) and zero quality.

    ``return_observers`` also returns the (N, Z, Y, X) OBSERVER-COUNT
    stack — how many of the OTHER sensors contributed an in-band sample
    per voxel — used for the contamination-aware consensus mask (forces
    the dense integration path, which carries the counts).
    """
    vols = []
    obs = []
    N = maps.depth.shape[0]
    for i in range(N):
        sel = jnp.arange(N) != i
        m = maps.replace(
            depth=jnp.where(
                sel[:, None, None, None], maps.depth,
                jnp.full_like(maps.depth, -100.0)
            ),
            silhouette=jnp.where(
                sel[:, None, None], maps.silhouette,
                jnp.ones_like(maps.silhouette)
            ),
            quality=jnp.where(
                sel[:, None, None], maps.quality, jnp.zeros_like(maps.quality)
            ),
        )
        # a widened band cannot be represented in the brick-compact
        # volume (only occupied-brick voxels exist there) — take the
        # dense path for wide-band requests
        wide = (
            limit is not None
            and pipeline.compact
            and limit > pipeline.config.tsdf_limit * 1.5
        )
        if return_observers:
            v, o = pipeline.integrate_dense(
                m, limit=limit, return_observers=True
            )
            vols.append(v)
            obs.append(o)
        elif wide:
            vols.append(pipeline.integrate_dense(m, limit=limit))
        else:
            vols.append(pipeline.integrate(m, brick_counts, limit=limit))
    if return_observers:
        return jnp.stack(vols), jnp.stack(obs)
    return jnp.stack(vols)


def refine_poses(
    calib,
    maps,
    volume: jnp.ndarray,
    limit: float,
    iters: int = 5,
    damping: float = 1e-4,
    stride: int = 2,
    volumes: jnp.ndarray = None,
    anchor: bool = False,
    mesh=None,
    axis_name: str = "z",
    init: jnp.ndarray = None,
    mask_floor: float = None,
    observers: jnp.ndarray = None,
    min_observers: float = 2.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Estimate per-sensor pose corrections against the fused TSDF.

    Pass ``volumes`` (N, Z, Y, X) from :func:`leave_one_out_volumes` to
    align each sensor against the other sensors' consensus surface (the
    well-posed form); ``volume`` alone aligns against the joint volume.

    ``anchor`` removes the common (gauge) motion from the corrections.
    Off by default: the zero-correction prior in the solver already pins
    the gauge (and unobserved directions), and mean-subtraction smears a
    single bad sensor's correction across the good ones.

    Pass ``mesh`` (jax.sharding.Mesh) to shard the surface points over the
    devices: the Jacobian build (the dominant cost — 6 JVPs through the
    trilinear TSDF per point) runs per shard and the 6x6/6-vector normal
    equations psum over the mesh (:func:`_normal_equations_mesh`). The LM
    accept/reject cost evaluation stays replicated (one residual pass, a
    ~7x smaller term).

    Returns (poses (N, 6), per-iteration mean abs residual (iters, N)).
    """
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min
    N = maps.depth.shape[0]

    pts_list, w_list = [], []
    for i in range(N):
        p, w = _surface_points(calib, maps, i, stride)
        pts_list.append(p)
        w_list.append(w)
    pts = jnp.stack(pts_list)
    ws = jnp.stack(w_list)
    if mesh is not None:
        # point axis must divide the mesh; pad with zero-weight points
        nd = mesh.shape[axis_name]
        padp = (-pts.shape[1]) % nd
        if padp:
            pts = jnp.pad(pts, ((0, 0), (0, padp), (0, 0)))
            ws = jnp.pad(ws, ((0, 0), (0, padp)))
    vols = volumes if volumes is not None else jnp.broadcast_to(
        volume, (N,) + volume.shape
    )
    # contamination-aware consensus (``observers`` from
    # leave_one_out_volumes(return_observers=True)): a constant-1 stack
    # disables the mask without changing traces
    obs_stack = observers if observers is not None else None

    center = bbox_min + 0.5 * bbox_size

    def active_mask(params, p, w, vol, obs):
        moved = apply_pose(params, p, center)
        r = _tsdf_at(vol, bbox_min, bbox_size, moved)
        # asymmetric active set — see _normal_equations
        floor = -limit * 0.999 if mask_floor is None else mask_floor
        m = ((r > floor) & (r < limit * 0.999) & (w > 0.0)).astype(
            jnp.float32
        )
        if obs is not None:
            m = m * _obs_weight(obs, bbox_min, bbox_size, moved,
                                min_observers)
        return m

    def masked_cost(params, p, w, vol, mask):
        """Cost over a FROZEN active set, with off-band escapes clamped at
        the band limit. Freezing the set per LM step closes the two
        degenerate escapes observed at reference scale: (a) 'improving' by
        pushing points out of the band so they drop from the cost, and
        (b) unobserved (-limit 'unknown') regions — never in the active
        set — dragging weakly-covered sensors around."""
        moved = apply_pose(params, p, center)
        r = _tsdf_at(vol, bbox_min, bbox_size, moved)
        rc = jnp.minimum(jnp.abs(r), limit)
        wm = w * mask
        return jnp.sum(wm * rc * rc) / jnp.maximum(jnp.sum(wm), 1e-20)

    # big arrays (points, weights, volumes, observer stacks — hundreds of
    # MB at reference scale) flow through the jitted functions as explicit
    # ARGUMENTS: closure capture would bake them into the lowered module
    # as constants, which remote-compile transports reject (HTTP 413)
    if obs_stack is not None:
        masks_f = jax.jit(jax.vmap(active_mask))
    else:
        masks_f = jax.jit(jax.vmap(
            lambda params, p, w, vol: active_mask(params, p, w, vol, None)
        ))
    costs_f = jax.jit(jax.vmap(masked_cost))

    def lm_update(params, JtWJ, JtWr, lam_i):
        # Marquardt scaling: damp RELATIVE to each parameter's own
        # curvature (+ a floor tied to the mean curvature) — absolute
        # damping left the surface-tangent null directions of the
        # point-to-TSDF objective nearly free, and well-aligned
        # sensors walked millimeters per step on residual noise
        d = jnp.diag(JtWJ)
        mean_d = jnp.mean(d)
        # zero-correction prior PROJECTED onto near-null directions: the
        # point-to-TSDF objective has directions (translation along the
        # surface, rotation about poorly-constrained axes) where small
        # systematic residuals slide the pose millimeters per step — a
        # Tikhonov pull toward zero pins those. The round-4 ISOTROPIC
        # prior also shrank weak-but-REAL directions: a y-rotation whose
        # only witnesses are small off-axis objects carries ~5-20% of the
        # mean curvature and was halved by the prior (measured at
        # reference scale: 0.4 deg recovered of a 1.0 deg drift).
        # Eigen-split the 6x6: full prior below 2% of the mean curvature,
        # 1% of it elsewhere.
        evals, evecs = jnp.linalg.eigh(JtWJ)
        mu_dir = 0.05 * mean_d * jnp.where(
            evals < 0.02 * mean_d, 1.0, 0.01
        )
        Pmu = jnp.matmul(evecs * mu_dir, evecs.T, precision="highest")
        A = (JtWJ + lam_i * (jnp.diag(d) + mean_d * jnp.eye(6)) + Pmu)
        delta = jnp.linalg.solve(
            A, JtWr + jnp.matmul(Pmu, params, precision="highest"))
        # per-iteration trust region: <= ~0.6 deg / 10 mm
        rot_n = jnp.linalg.norm(delta[:3])
        tr_n = jnp.linalg.norm(delta[3:])
        scale = jnp.minimum(
            1.0,
            jnp.minimum(0.01 / jnp.maximum(rot_n, 1e-12),
                        0.010 / jnp.maximum(tr_n, 1e-12)),
        )
        return params - delta * scale

    if mesh is None:
        if obs_stack is not None:
            @jax.jit
            def candidates(poses, lam, pts, ws, vols, obs_stack):
                def per_sensor(params, p, w, vol, obs, lam_i):
                    JtWJ, JtWr, res = _normal_equations(
                        params, p, w, vol, bbox_min, bbox_size, limit,
                        center, mask_floor, observers=obs,
                        min_observers=min_observers,
                    )
                    return lm_update(params, JtWJ, JtWr, lam_i), res

                return jax.vmap(per_sensor)(
                    poses, pts, ws, vols, obs_stack, lam
                )
        else:
            @jax.jit
            def candidates(poses, lam, pts, ws, vols, obs_stack):
                def per_sensor(params, p, w, vol, lam_i):
                    JtWJ, JtWr, res = _normal_equations(
                        params, p, w, vol, bbox_min, bbox_size, limit,
                        center, mask_floor,
                    )
                    return lm_update(params, JtWJ, JtWr, lam_i), res

                return jax.vmap(per_sensor)(poses, pts, ws, vols, lam)
    else:
        @jax.jit
        def candidates(poses, lam, pts, ws, vols, obs_stack):
            # per-sensor normal equations reduced over the mesh (psum);
            # N is small, so the sensor loop is unrolled in the trace
            cands, ress = [], []
            for i in range(N):
                JtWJ, JtWr, res = _normal_equations_mesh(
                    poses[i], pts[i], ws[i], vols[i], bbox_min, bbox_size,
                    limit, mesh, axis_name, center, mask_floor,
                )
                cands.append(lm_update(poses[i], JtWJ, JtWr, lam[i]))
                ress.append(res)
            return jnp.stack(cands), jnp.stack(ress)

    # Levenberg-Marquardt: per-sensor adaptive damping with accept/reject
    # on the frozen-active-set cost; ``init`` continues from an earlier
    # (coarser-band) round's estimate
    poses = (jnp.zeros((N, 6), jnp.float32) if init is None
             else jnp.asarray(init, jnp.float32))
    lam = jnp.full((N,), jnp.maximum(damping, 1e-2), jnp.float32)
    history = []
    for _ in range(iters):
        if obs_stack is not None:
            mask = masks_f(poses, pts, ws, vols, obs_stack)
        else:
            mask = masks_f(poses, pts, ws, vols)
        cand, res = candidates(poses, lam, pts, ws, vols, obs_stack)
        c_old = costs_f(poses, pts, ws, vols, mask)
        c_new = costs_f(cand, pts, ws, vols, mask)
        better = c_new < c_old
        poses = jnp.where(better[:, None], cand, poses)
        lam = jnp.clip(
            jnp.where(better, lam * 0.3, lam * 10.0), 1e-6, 1e3
        )
        history.append(res)
    if anchor:
        # project out the rig-wide gauge motion (small-angle composition:
        # subtracting the mean rotation vector / translation is exact to
        # first order, and corrections are small by construction)
        poses = poses - jnp.mean(poses, axis=0, keepdims=True)
    return poses, jnp.stack(history)


def apply_pose_corrections(calib, poses: jnp.ndarray):
    """Compose per-sensor 6-DoF corrections into the calibration set —
    closing the refinement loop so the NEXT frame's integration and
    rendering use the aligned poses.

    The forward volume cv_xyz maps (u, v, d) -> world, so its points
    transform directly: world' = R world + t. The color map cv_uv lives in
    sensor space (unchanged). The inverse volume cv_xyz_inv maps world ->
    sensor, so it is RESAMPLED at the inversely-transformed grid:
    cv_xyz_inv'(p) = cv_xyz_inv(R^T (p - t)) — a trilinear warp of the
    (N, Z, Y, X, 4) grid, one-off cost comparable to a render.

    Returns a new CalibrationSet; feed it to TsdfPipeline.update_calibration
    (same shapes -> no recompilation, projections re-bake from the warped
    volumes)."""
    from ..calib.sensors import CalibrationSet

    N = calib.cv_xyz.shape[0]
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min

    @jax.jit
    def go(calib, poses):
        center = bbox_min + 0.5 * bbox_size
        Rs = jnp.stack([_rodrigues(poses[i, :3]) for i in range(N)])
        # x' = R (x - c) + c + t  ==  R x + (c + t - R c): fold the
        # center-relative rotation into an equivalent origin-form affine
        ts = (
            poses[:, 3:] + center
            - jnp.einsum("nij,j->ni", Rs, center,
                         precision=jax.lax.Precision.HIGHEST)
        )
        # full-precision matmuls: a TF32 product would put ~millimeter
        # errors into every calibration coordinate
        cv_xyz = (
            jnp.einsum("nij,ndhwj->ndhwi", Rs, calib.cv_xyz,
                       precision=jax.lax.Precision.HIGHEST)
            + ts[:, None, None, None, :]
        )
        campos = jnp.einsum("nij,nj->ni", Rs, calib.camera_positions,
                            precision=jax.lax.Precision.HIGHEST) + ts

        Zi, Yi, Xi = calib.cv_xyz_inv.shape[1:4]
        zi = (jnp.arange(Zi, dtype=jnp.float32) + 0.5) / Zi
        yi = (jnp.arange(Yi, dtype=jnp.float32) + 0.5) / Yi
        xi = (jnp.arange(Xi, dtype=jnp.float32) + 0.5) / Xi
        zz, yy, xx = jnp.meshgrid(zi, yi, xi, indexing="ij")
        p_world = (
            jnp.stack([xx, yy, zz], axis=-1) * bbox_size + bbox_min
        )

        def warp(inv, R, t):
            q = jnp.matmul(p_world - t, R,
                           precision=jax.lax.Precision.HIGHEST)  # R^T (p-t)
            q_norm = (q - bbox_min) / bbox_size
            return trilinear_3d(inv, q_norm)

        cv_xyz_inv = jax.vmap(warp)(calib.cv_xyz_inv, Rs, ts)
        return cv_xyz, campos, cv_xyz_inv

    cv_xyz, campos, cv_xyz_inv = go(calib, poses)
    return CalibrationSet(
        cv_xyz=cv_xyz,
        cv_uv=calib.cv_uv,
        cv_xyz_inv=cv_xyz_inv,
        depth_limits=calib.depth_limits,
        camera_positions=campos,
        bbox_min=calib.bbox_min,
        bbox_max=calib.bbox_max,
    )


def pose_residual_stats(calib, maps, volume, limit, poses=None, stride=2,
                        volumes=None, observers=None,
                        min_observers: float = 2.0):
    """Mean |TSDF| at observed surface points (alignment quality metric).

    Pass ``volumes`` (N, Z, Y, X) to score each sensor against the
    leave-one-out consensus instead of the joint volume; ``observers``
    restricts the mean to multi-observer consensus voxels (the
    contamination-aware form), so sensors are ranked on directly
    comparable, well-defined residuals."""
    N = maps.depth.shape[0]
    if poses is None:
        poses = jnp.zeros((N, 6), jnp.float32)
    bbox_min = calib.bbox_min
    bbox_size = calib.bbox_max - calib.bbox_min
    center = bbox_min + 0.5 * bbox_size
    out = []
    for i in range(N):
        vol = volumes[i] if volumes is not None else volume
        pts, w = _surface_points(calib, maps, i, stride)
        moved = apply_pose(poses[i], pts, center)
        r = _tsdf_at(vol, bbox_min, bbox_size, moved)
        # saturation-aware: points pushed outside the truncation band count
        # at the band limit instead of being excluded — otherwise a badly
        # misaligned pose looks artificially good because its off-surface
        # points drop out of the mean
        mask = w > 0
        if observers is not None:
            mask = mask & (
                _obs_at(observers[i], bbox_min, bbox_size, moved)
                >= min_observers - 0.5
            )
        denom = jnp.maximum(jnp.sum(mask), 1)
        out.append(
            jnp.sum(jnp.minimum(jnp.abs(r), limit) * mask) / denom
        )
    return jnp.stack(out)
