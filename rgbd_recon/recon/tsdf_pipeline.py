"""The flagship reconstruction pipeline: preprocess -> integrate -> raymarch.

Equivalent of the reference's mode-1 path (ReconIntegration,
framework/reconstruction/recon_integration.cpp) plus the per-frame driver
logic of kinect_client.cpp:583-716 (draw3d), as one functional, jittable
step:

  frames --preprocess (5-pass chain)--> sensor maps
         --brick marking (scatter-add)--> occupancy mask
         --TSDF integration (masked dense)--> volume
         --raymarch + blend + shade--> image
         --pull-push colorfill--> final frame

Everything below `step()` is pure: state (the TSDF volume) flows in and out
explicitly, so the same step works single-chip, vmapped, or sharded by
dist/ over a device mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import pytree

from ..calib.sensors import CalibrationSet
from ..core.config import PipelineConfig
from ..core.grid import BoundingBox, BrickGrid, VolumeGrid
from ..ops import bricks as brick_ops
from ..ops import holefill, raymarch, tsdf
from ..ops.preprocess import SensorMaps, preprocess_frames
from ..ops.sampling import trilinear_3d
from ..sensors.frames import FrameSet


def _dilate1(m: jnp.ndarray, ax: int) -> jnp.ndarray:
    """1-step boolean dilation along one axis, shift-and-pad semantics (no
    wraparound across volume faces)."""
    sl_lo = [slice(None)] * m.ndim
    sl_lo[ax] = slice(1, None)
    sl_hi = [slice(None)] * m.ndim
    sl_hi[ax] = slice(None, -1)
    pad_lo = [(0, 0)] * m.ndim
    pad_lo[ax] = (0, 1)
    pad_hi = [(0, 0)] * m.ndim
    pad_hi[ax] = (1, 0)
    return (
        m
        | jnp.pad(m[tuple(sl_lo)], pad_lo)
        | jnp.pad(m[tuple(sl_hi)], pad_hi)
    )


def _dilate3(m: jnp.ndarray) -> jnp.ndarray:
    """1-step Chebyshev (box) dilation: one shift-or pass per axis."""
    for ax in range(m.ndim):
        m = _dilate1(m, ax)
    return m


def _brick_any(mask: jnp.ndarray, vol_shape, brick_vox: int) -> jnp.ndarray:
    """(Z, Y, X) bool -> (Bz, By, Bx) bool: any-pooling to brick grid."""
    (Bz, By, Bx), padded = tsdf.brick_layout(vol_shape, brick_vox)
    Z, Y, X = vol_shape
    v = brick_vox
    m = jnp.pad(
        mask, [(0, padded[0] - Z), (0, padded[1] - Y), (0, padded[2] - X)]
    )
    return m.reshape(Bz, v, By, v, Bx, v).any(axis=(1, 3, 5))


@pytree.dataclass
class RenderOutput:
    """Final render + debug maps (the reference's screen + texture viewer)."""

    color: jnp.ndarray        # (H, W, 3) final shaded image
    depth: jnp.ndarray        # (H, W) window depth [0,1]
    hit: jnp.ndarray          # (H, W) bool surface mask
    num_samples: jnp.ndarray  # (H, W) raymarch step counts (stats image)
    # (4,) int32 [active blocks beyond block capacity, phase-2 rays beyond
    # continuation capacity, hits beyond hit-shading capacity, surface
    # bricks beyond the oct hit-table capacity] — nonzero means pixels
    # were dropped (or shaded with fallback values) this frame (the silent
    # truncations flagged in round 2 made observable)
    overflow: jnp.ndarray = None


@pytree.dataclass
class CamParams:
    """Render-camera pose as ARRAYS so camera motion (navigation, stereo
    eyes, feedback channel) never retriggers compilation — the equivalent of
    the reference's per-frame gluLookAt updates (kinect_client.cpp:612-673).
    Projection parameters (fov/near/far) and the image size stay static."""

    eye_w: jnp.ndarray    # (3,) world-space eye
    rot: jnp.ndarray      # (3, 3) camera-to-world rotation (GL convention)
    eye_vol: jnp.ndarray  # (3,) eye in volume-normalized coords

    @classmethod
    def from_camera(cls, camera: raymarch.ViewCamera, bbox: BoundingBox):
        eye = np.asarray(camera.eye, np.float32)
        return cls(
            eye_w=jnp.asarray(eye),
            rot=jnp.asarray(camera.rotation()),
            eye_vol=jnp.asarray(bbox.normalize(eye)),
        )

    @classmethod
    def from_matrix(cls, mat, bbox: BoundingBox):
        """Pose from a 4x4 camera-to-world matrix (GL convention: camera
        looks along -z) — the form the feedback channel delivers
        (FeedbackReceiver cyclops/model mats, kinect_client.cpp:637-673)."""
        m = np.asarray(mat, np.float32)
        eye = m[:3, 3]
        return cls(
            eye_w=jnp.asarray(eye),
            rot=jnp.asarray(m[:3, :3]),
            eye_vol=jnp.asarray(bbox.normalize(eye)),
        )


class TsdfPipeline:
    """Builds and owns the jitted step functions for one scene setup.

    The constructor captures everything *static* (grids, resolutions,
    config) in Python; all device arrays — the calibration set and the
    precomputed projections — flow through the jitted functions as explicit
    pytree ARGUMENTS, never as closure captures. Closure-captured arrays are
    baked into the lowered module as constants; at reference scale
    (cv_xyz_inv alone is ~280 MB for 4 sensors) that makes the program
    unserializable and wastes device memory. Public methods supply the pipeline's own
    arrays, so callers keep the simple `fuse(frames)` surface.
    """

    def __init__(
        self,
        calib: CalibrationSet,
        config: PipelineConfig = None,
        bbox: BoundingBox = None,
    ):
        self.config = config or PipelineConfig()
        self.bbox = bbox or calib.bbox
        self.calib = calib
        # the TSDF truncation limit flows through every jitted program as a
        # TRACED scalar, so set_tsdf_limit() swaps it without a recompile
        # (the reference's tsdf slider, recon_integration.cpp:341-345)
        self._limit = jnp.float32(self.config.tsdf_limit)
        # bumped by shape-changing reconfiguration (voxel/brick size);
        # renderers rebuild their traced program lazily when stale
        self._generation = 0
        self._jit_cache = {}
        self._pixel_models_cache = {}
        self._build_grids()
        self._rebuild_jits()

    def _build_grids(self):
        """(Re)derive the volume/brick grids and projection bakes from the
        current config + calibration — everything with a shape."""
        self.volume_grid = VolumeGrid(bbox=self.bbox, voxel_size=self.config.voxel_size)
        self.brick_grid = BrickGrid(
            bbox=self.bbox,
            brick_size=self.config.brick_size,
            min_voxels=self.config.min_voxels_per_brick,
        )
        # Brick-compact integration (ops/tsdf.py, integrate_bricks) needs the
        # brick edge to be an integer number of voxels — true for the
        # reference defaults (10 cm bricks / 1 cm voxels).
        ratio = self.config.brick_size / self.config.voxel_size
        self.brick_vox = int(round(ratio))
        self.compact = (
            self.config.bricking
            and abs(ratio - self.brick_vox) < 1e-6
            and self.brick_vox >= 1
            and tsdf.brick_layout(self.volume_grid.shape, self.brick_vox)[0]
            == self.brick_grid.shape
        )

        # frame-invariant per-voxel projections (ops/tsdf.py): one gather at
        # setup instead of one per frame
        if self.compact:
            self.projections = tsdf.bake_projections_bricks(
                self.calib.cv_xyz_inv, self.volume_grid.shape, self.brick_vox
            )
        elif self.config.precompute_projections:
            self.projections = tsdf.bake_projections(
                self.calib.cv_xyz_inv, self.volume_grid.shape
            )
        else:
            self.projections = None

    def _jit_key(self):
        """Config fields the stage traces depend on (toggles + shapes).
        Cached jit wrappers per key make toggle flips instant once each
        variant has compiled — the equivalent of the reference re-running
        processTextures()+integrate() on any GUI toggle
        (kinect_client.cpp:362-376)."""
        c = self.config
        return (
            c.morph, c.bilateral, c.processed, c.refine, c.mark_stride,
            c.bricking, c.pixel_ray_model, c.carve_sil_threshold,
            c.phantom_hull, c.integrate_taps, c.brick_capacity,
            c.min_voxels_per_brick,
            self.volume_grid.shape, self.brick_vox, self.compact,
        )

    def _rebuild_jits(self):
        key = self._jit_key()
        if key not in self._jit_cache:
            self._jit_cache[key] = (
                jax.jit(self._preprocess_impl),
                jax.jit(self._integrate_impl),
                jax.jit(self._fuse_impl),
            )
        self._preprocess, self._integrate, self._fuse = self._jit_cache[key]

    def _get_pixel_models(self, depth_hw):
        """Per-pixel calibration closed forms for this depth resolution
        (calib.sensors.PixelModels), derived once and cached. Returns None
        when disabled or when the fit residual exceeds ~1 depth pixel."""
        if not self.config.pixel_ray_model:
            return None
        key = tuple(depth_hw)
        if key not in self._pixel_models_cache:
            from ..calib.sensors import derive_pixel_models

            models, residual = derive_pixel_models(
                self.calib.cv_xyz, self.calib.cv_uv, key
            )
            # residual is in normalized (u,v,d)/world units; ~2e-3 is about
            # one pixel at reference sensor resolution
            if residual > 2e-3:
                print(
                    f"pixel-ray model residual {residual:.2e} too large; "
                    "falling back to calibration-volume lookups"
                )
                models = None
            self._pixel_models_cache[key] = models
        return self._pixel_models_cache[key]

    # -- stages (pure over their array arguments) ---------------------------

    def _preprocess_impl(
        self, calib: CalibrationSet, pixel_models, frames: FrameSet
    ) -> Tuple[SensorMaps, jnp.ndarray]:
        c = self.config
        maps = preprocess_frames(
            frames.depths,
            frames.colors,
            calib.cv_xyz,
            calib.cv_uv,
            calib.bbox_min,
            calib.bbox_max,
            calib.depth_limits,
            calib.camera_positions,
            morph=c.morph,
            bilateral=c.bilateral and c.processed,
            refine=c.refine,
            pixel_models=pixel_models,
        )
        # the maps feed several consumers (mark, and integrate when traced
        # as one program); barrier against XLA recomputing the stencil
        # chain per consumer (the rematerialization pathology measured in
        # holefill/bake)
        maps = jax.lax.optimization_barrier(maps)
        counts = self._mark_bricks(calib, pixel_models, maps)
        return maps, counts

    def _mark_bricks(
        self, calib: CalibrationSet, pixel_models, maps: SensorMaps
    ) -> jnp.ndarray:
        """Brick occupancy from valid depth pixels (the pre_normal.fs side
        effect, glsl/pre_normal.fs:32-34 + inc_bricks.glsl:40-58).

        With ``config.mark_stride`` > 1, only every stride-th pixel scatters
        and contributes stride^2 counts — a stride^2-cheaper scatter whose
        counters stay on the reference scale (a 10 cm brick's footprint is
        hundreds of pixels, so subsampled counts cross the >10 threshold for
        the same bricks except at extreme grazing angles). Stride 1 is the
        reference-exact mode.
        """
        N, H, W = maps.depth.shape[:3]
        s = max(int(self.config.mark_stride), 1)
        d_all = maps.depth[..., 0]
        if s > 1:
            d_all = d_all[:, s // 2::s, s // 2::s]
        valids = (d_all > 0.0) & (d_all < 1.0)
        if pixel_models is not None:
            ray_a, ray_b = pixel_models.ray_a, pixel_models.ray_b
            if s > 1:
                ray_a = ray_a[:, s // 2::s, s // 2::s]
                ray_b = ray_b[:, s // 2::s, s // 2::s]
            # per-component planes, stacked only for the scatter's index
            # math
            worlds = jnp.stack(
                [ray_a[..., j] + ray_b[..., j] * d_all for j in range(3)],
                axis=-1,
            )
        else:
            u = (jnp.arange(W, dtype=jnp.float32)[s // 2::s] + 0.5) / W
            v = (jnp.arange(H, dtype=jnp.float32)[s // 2::s] + 0.5) / H
            uu, vv = jnp.meshgrid(u, v)

            def world_of(cv_xyz_i, d):
                return trilinear_3d(cv_xyz_i, jnp.stack([uu, vv, d], axis=-1))

            worlds = jax.vmap(world_of)(calib.cv_xyz, d_all)
        counts = brick_ops.mark_bricks(
            worlds,
            valids,
            calib.bbox_min,
            self.config.brick_size,
            self.brick_grid.res,
        )
        return counts * (s * s)

    def _voxel_mask(self, brick_counts: jnp.ndarray):
        c = self.config
        if not c.bricking:
            return None
        occ = brick_ops.occupied_mask(brick_counts, c.min_voxels_per_brick)
        return brick_ops.expand_mask_to_voxel_grid(
            occ,
            self.volume_grid.shape,
            tuple(float(s) for s in self.bbox.size),
            c.brick_size,
        )

    def _integrate_impl(
        self,
        calib: CalibrationSet,
        projections,
        maps: SensorMaps,
        brick_counts: jnp.ndarray,
        limit,
    ) -> jnp.ndarray:
        c = self.config
        if self.compact:
            ids = tsdf.occupied_brick_ids(
                brick_counts, c.min_voxels_per_brick, c.brick_capacity
            )
            return tsdf.integrate_bricks(
                projections,
                ids,
                maps.depth[..., 0],
                maps.quality,
                maps.silhouette,
                limit,
                self.volume_grid.shape,
                self.brick_vox,
                carve_sil_threshold=c.carve_sil_threshold,
                phantom_hull=c.phantom_hull,
                taps=c.integrate_taps,
            )
        return tsdf.integrate(
            self.volume_grid.shape,
            calib.cv_xyz_inv,
            maps.depth[..., 0],
            maps.quality,
            maps.silhouette,
            limit,
            voxel_mask=self._voxel_mask(brick_counts),
            projections=projections,
            carve_sil_threshold=c.carve_sil_threshold,
            phantom_hull=c.phantom_hull,
        )

    def _fuse_impl(
        self, calib: CalibrationSet, projections, pixel_models,
        frames: FrameSet, limit,
    ) -> Tuple[jnp.ndarray, SensorMaps, jnp.ndarray]:
        maps, counts = self._preprocess_impl(calib, pixel_models, frames)
        volume = self._integrate_impl(calib, projections, maps, counts, limit)
        return volume, maps, counts

    # -- public API --------------------------------------------------------

    def preprocess(self, frames: FrameSet):
        pm = self._get_pixel_models(frames.depths.shape[1:3])
        return self._preprocess(self.calib, pm, frames)

    def integrate(self, maps: SensorMaps, brick_counts: jnp.ndarray,
                  limit=None) -> jnp.ndarray:
        """``limit`` overrides the truncation band for this call only (a
        traced scalar — no recompile); pose refinement fuses wide-band
        volumes for its coarse-to-fine schedule."""
        return self._integrate(
            self.calib, self.projections, maps, brick_counts,
            self._limit if limit is None else jnp.float32(limit),
        )

    def integrate_dense(self, maps: SensorMaps, limit=None,
                        return_observers: bool = False):
        """Dense (unbricked, unmasked) integration at an arbitrary
        truncation band. Pose refinement uses this for its wide-band
        coarse-to-fine volumes: the compact fast path materializes only
        occupied-brick voxels, which cannot represent a band wider than
        ~one brick — sampled there, a wide-band TSDF reads the clear
        value almost everywhere and Gauss-Newton walks on garbage.

        ``return_observers`` also returns the per-voxel observer-count
        volume (ops/tsdf.py integrate) for the contamination-aware
        consensus."""
        key = "_integrate_dense_obs_jit" if return_observers \
            else "_integrate_dense_jit"
        if not hasattr(self, key):
            shape = self.volume_grid.shape
            c = self.config

            def impl(calib, maps, limit, _obs=return_observers):
                return tsdf.integrate(
                    shape, calib.cv_xyz_inv, maps.depth[..., 0],
                    maps.quality, maps.silhouette, limit,
                    voxel_mask=None, projections=None,
                    carve_sil_threshold=c.carve_sil_threshold,
                    phantom_hull=c.phantom_hull, return_observers=_obs,
                )

            setattr(self, key, jax.jit(impl))
        return getattr(self, key)(
            self.calib, maps,
            self._limit if limit is None else jnp.float32(limit),
        )

    def fuse(self, frames: FrameSet):
        """One fused frame update: preprocess + mark + integrate.

        Dispatched as the two stage programs rather than one monolithic jit:
        XLA's fusion search on the combined stencil-chain + volume-integrate
        program takes ~10x longer to compile for no measured runtime win
        (intermediates stay on device either way). `fuse_single_program()`
        exposes the monolith for callers that want one dispatch.
        """
        pm = self._get_pixel_models(frames.depths.shape[1:3])
        maps, counts = self._preprocess(self.calib, pm, frames)
        volume = self._integrate(
            self.calib, self.projections, maps, counts, self._limit
        )
        return volume, maps, counts

    def fuse_single_program(self, frames: FrameSet):
        """The whole frame update as ONE jitted XLA program."""
        pm = self._get_pixel_models(frames.depths.shape[1:3])
        return self._fuse(
            self.calib, self.projections, pm, frames, self._limit
        )

    # -- runtime reconfiguration (recon_integration.cpp:341-354, 468-484;
    #    kinect_client.cpp:362-376) ---------------------------------------

    def set_tsdf_limit(self, limit: float) -> None:
        """Live truncation-limit change WITHOUT recompiling: the limit is a
        traced scalar in every stage program. (The render step size adapts
        with it; the static march step BOUND is sized from the construction
        limit, so halving the limit at runtime may leave grazing rays
        unfinished — visible in RenderOutput.overflow[1].)"""
        self.config.tsdf_limit = float(limit)
        self._limit = jnp.float32(limit)

    def set_voxel_size(self, voxel_size: float) -> None:
        """Rebuild the volume grid + projection bakes at a new resolution
        (shapes change, so affected programs recompile — like the
        reference rebuilding the volume, recon_integration.cpp:341-354)."""
        self.reconfigure(voxel_size=float(voxel_size))

    def set_brick_size(self, brick_size: float) -> None:
        self.reconfigure(brick_size=float(brick_size))

    def reconfigure(self, **updates) -> None:
        """Apply config updates (voxel_size, brick_size, processing
        toggles, ...) and re-derive everything affected. Shape-preserving
        toggle flips reuse cached compiled variants (instant after their
        first use); shape changes re-bake grids/projections and invalidate
        outstanding renderers (they rebuild lazily on next call)."""
        shape_keys = {"voxel_size", "brick_size", "bricking",
                      "min_voxels_per_brick"}
        reshape = False
        for k, v in updates.items():
            if not hasattr(self.config, k):
                raise AttributeError(f"unknown config field {k}")
            if getattr(self.config, k) != v:
                setattr(self.config, k, v)
                reshape = reshape or k in shape_keys
        if "tsdf_limit" in updates:
            self._limit = jnp.float32(self.config.tsdf_limit)
        if reshape:
            self._build_grids()
            self.__dict__.pop("_integrate_dense_jit", None)
            self.__dict__.pop("_integrate_dense_obs_jit", None)
        self._rebuild_jits()
        self._generation += 1

    def update_calibration(self, calib: CalibrationSet) -> None:
        """Swap in a new calibration set (e.g. pose-refined by
        refine.pose_ba.apply_pose_corrections) and re-bake everything
        derived from it. Shapes are unchanged, so the jitted step functions
        do NOT recompile — only the baked projection/model arrays refresh
        (sub-second)."""
        self.calib = calib
        if self.compact:
            self.projections = tsdf.bake_projections_bricks(
                calib.cv_xyz_inv, self.volume_grid.shape, self.brick_vox
            )
        elif self.config.precompute_projections:
            self.projections = tsdf.bake_projections(
                calib.cv_xyz_inv, self.volume_grid.shape
            )
        self._pixel_models_cache = {}
        if hasattr(self, "_projection_models"):
            del self._projection_models

    def refine_sensor_poses(self, maps: SensorMaps, brick_counts,
                            iters: int = 5, apply: bool = True,
                            rounds: int = 1, frames: FrameSet = None,
                            worst_only: bool = True,
                            band_schedule=(4.0, 2.0, 1.0)):
        """Estimate per-sensor 6-DoF corrections against the leave-one-out
        consensus surfaces and (optionally) apply them to the calibration —
        the full drift-correction loop (north-star capability; the
        reference trusts its offline calibration and shows drift as doubled
        surfaces).

        ``rounds`` > 1 alternates refine -> apply -> re-fuse (pass
        ``frames``): a misaligned sensor contaminates the others'
        leave-one-out consensus, so one shot is biased; alternating
        minimization converges.

        ``worst_only`` applies only the correction of the sensor with the
        highest consensus residual each round — and only when that
        residual stands clearly above the rig's median (1.25x), so a
        healthy rig is never 'corrected' on voxelization noise. For the
        typical failure (ONE sensor drifted), this is the well-posed
        form: the outlier is aligned against the mutually-consistent
        others, while correcting everyone at once lets the outlier's
        contamination and the rig-wide gauge smear corrections across
        good sensors.

        ``band_schedule`` widens the truncation band of the per-round
        leave-one-out volumes (coarse-to-fine): a drift near the band
        limit leaves most surface points OUTSIDE the band, biasing the
        active set and stalling Gauss-Newton; a 4x band captures the
        whole displacement smoothly, later rounds tighten for precision.
        The band is a traced scalar, so wide-band fusion costs no
        recompilation.

        Returns (poses of the LAST round (N, 6), residual history)."""
        from ..refine import pose_ba

        # consume the schedule from the END: rounds=1 refines at the
        # nominal band; rounds >= len(schedule) walks coarse-to-fine
        n_rounds = max(rounds, 1)
        sched = list(band_schedule) if band_schedule else [1.0]
        if n_rounds <= len(sched):
            sched = sched[len(sched) - n_rounds:]
        else:
            sched = [sched[0]] * (n_rounds - len(sched)) + sched

        poses = history = None
        total = None
        applied_sensor = -1
        for r in range(n_rounds):
            band = self.config.tsdf_limit * float(sched[r])
            # contamination-aware consensus: per-voxel observer counts
            # (how many OTHER sensors saw each voxel) so residuals and
            # rankings only use surface patches with >= 2 independent
            # witnesses — regions only the drifted sensor hallucinated,
            # and the biased transition zones around them, carry no
            # weight (the round-4 failure mode for ~30 mm drifts)
            vols, obs = pose_ba.leave_one_out_volumes(
                self, maps, brick_counts, limit=band,
                return_observers=True,
            )
            # a leave-one-out consensus has N-1 potential witnesses:
            # 2-sensor rigs can only ever have single-observer voxels
            n_obs = min(2.0, float(self.calib.num_sensors - 1))
            poses, history = pose_ba.refine_poses(
                self.calib, maps, None, band, iters=iters,
                volumes=vols, init=None if apply else total,
                # trim unknown-region contamination at half band, but
                # never tighter than the nominal limit (1x rounds keep
                # the classic saturation-excluding mask)
                mask_floor=-max(band * 0.5, self.config.tsdf_limit * 0.999),
                observers=obs, min_observers=n_obs,
            )
            if worst_only:
                # rank at the NOMINAL clamp, saturation-aware, WITHOUT
                # the observer mask (it would exclude exactly the
                # displaced points that mark a sensor as misaligned —
                # measured: a 3 cm drift ranked as healthy with the mask)
                res = pose_ba.pose_residual_stats(
                    self.calib, maps, None, self.config.tsdf_limit,
                    volumes=vols,
                )
                res_h = np.asarray(res)
                worst = int(np.argmax(res_h))
                sel = (jnp.arange(poses.shape[0]) == worst)[:, None]
                poses = jnp.where(sel, poses, 0.0)
                if apply:
                    # destructive path: three gates.
                    # (1) margin — the worst sensor must stand clearly
                    #     above the rig's noise floor, so a healthy rig
                    #     is never 'corrected' on voxelization noise;
                    #     bypassed for the sensor corrected LAST round
                    #     (continuity: once flagged and moved, its
                    #     touch-up rounds need no re-flagging — the
                    #     residual drift no longer stands out).
                    # (2) improvement — the candidate must LOWER the
                    #     worst sensor's own consensus residual by >= 5%.
                    #     Gauss-Newton on a drift far outside the band
                    #     can run away (measured: a 31.6 mm drift
                    #     'corrected' to 127.9 mm before this gate); a
                    #     runaway never passes the improvement check, so
                    #     the pipeline degrades to no-correction instead
                    #     of corrupting the rig.
                    margin = (
                        res_h[worst] > 1.12 * float(np.median(res_h))
                        or worst == applied_sensor
                    )
                    res_after = np.asarray(pose_ba.pose_residual_stats(
                        self.calib, maps, None, self.config.tsdf_limit,
                        poses=poses, volumes=vols,
                    ))
                    improve = res_after[worst] < 0.95 * res_h[worst]
                    if margin and improve:
                        applied_sensor = worst
                    else:
                        poses = jnp.zeros_like(poses)
            if not apply:
                # estimate-only: accumulate through the band schedule
                # (poses already include ``total`` via init)
                total = poses
                continue
            self.update_calibration(
                pose_ba.apply_pose_corrections(self.calib, poses)
            )
            if r + 1 < n_rounds:
                if frames is None:
                    break
                _, maps, brick_counts = self.fuse(frames)
        return poses, history

    def diagnostics(self, brick_counts: jnp.ndarray,
                    render_out: "RenderOutput" = None) -> dict:
        """Host-side overflow/occupancy report for one frame: occupied brick
        count vs the compact-integration capacity, plus the render path's
        block/hit capacity drops. Any nonzero ``*_dropped`` means geometry
        or pixels were lost to a fixed capacity this frame — raise
        ``brick_capacity`` / ``ray_compaction`` / ``hit_compaction``."""
        c = self.config
        n_occ = int(
            np.asarray(
                jnp.sum((brick_counts > c.min_voxels_per_brick).astype(jnp.int32))
            )
        )
        out = {
            "occupied_bricks": n_occ,
            "brick_capacity": c.brick_capacity,
            "bricks_dropped": max(0, n_occ - c.brick_capacity)
            if self.compact else 0,
        }
        if render_out is not None and render_out.overflow is not None:
            ov = np.asarray(render_out.overflow)
            out["blocks_dropped"] = int(ov[0])
            out["phase2_rays_dropped"] = int(ov[1])
            out["hits_dropped"] = int(ov[2])
            if ov.shape[0] > 3:
                out["oct_bricks_dropped"] = int(ov[3])
        return out

    # -- render --------------------------------------------------------------

    def _get_projection_models(self):
        """Analytic world->sensor models (calib.sensors.ProjectionModels),
        fitted once; None when disabled or when the fit residual exceeds
        ~2e-3 normalized units (≈ one sensor pixel) — non-pinhole rigs then
        blend through the calibration volumes instead."""
        if not self.config.projection_model:
            return None
        if not hasattr(self, "_projection_models"):
            from ..calib.sensors import derive_projection_models

            models, residual = derive_projection_models(
                self.calib.cv_xyz, self.calib.cv_uv
            )
            if residual > 2e-3:
                print(
                    f"projection-model residual {residual:.2e} too large; "
                    "blending through calibration volumes"
                )
                models = None
            self._projection_models = models
        return self._projection_models

    def _shade_hits(self, packed, hit, hit_pos, maps, calib, proj_models,
                    cam: CamParams, near: float, far: float, limit=None,
                    clamp_floor=None, oct=None):
        """Normal + color + shading at hit positions (any batch shape).
        Returns (rgba, depth_win). The submitFragment half of the raymarch
        shader (tsdf_raymarch.fs:116-142). With ``oct`` (the compact
        cell-corner table), the surface normal is the analytic gradient of
        the trilinear field — one 8-wide row gather instead of six taps."""
        c = self.config
        bbox_sz = jnp.asarray(np.asarray(self.bbox.size, np.float32))
        dbg = set(filter(None, c.debug_skip.split(",")))

        if "grad" in dbg:
            grad = jnp.zeros_like(hit_pos).at[..., 2].set(1.0)
        elif oct is not None:
            g, gvalid = oct.gradient_p(
                hit_pos[..., 0], hit_pos[..., 1], hit_pos[..., 2]
            )
            grad = -g / jnp.maximum(
                jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-20
            )
            # hits anchored outside the oct table (surface bricks beyond
            # capacity — observable via RenderOutput.overflow[3]) would
            # otherwise shade with slot 0's unrelated corners: fall back
            # to a toward-camera normal (flat shading) instead of garbage.
            # The fallback is built in volume-gradient space (scaled by
            # bbox) so the world-space transform below yields a unit
            # toward-camera world normal.
            w = cam.eye_w - (hit_pos * bbox_sz + calib.bbox_min)
            fb = w * bbox_sz
            fb = fb / jnp.maximum(
                jnp.linalg.norm(fb, axis=-1, keepdims=True), 1e-20
            )
            grad = jnp.where(gvalid[..., None], grad, fb)
        else:
            grad = raymarch.gradient_normal(
                packed, hit_pos, limit, mode=c.march_mode,
                clamp_floor=clamp_floor,
            )
        # volume-space gradient -> world via inverse-transpose of the
        # (diagonal) vol_to_world scale (recon_integration.cpp:200)
        n_world = grad / bbox_sz
        n_world = n_world / jnp.maximum(
            jnp.linalg.norm(n_world, axis=-1, keepdims=True), 1e-20
        )

        world_pos = hit_pos * bbox_sz + calib.bbox_min
        # f32 matmuls at full precision: TF32 would round view depth to
        # ~1e-3 of its value, several voxels at the far end of the box
        view_pos = jnp.matmul(world_pos - cam.eye_w, cam.rot, precision="highest")
        view_normal = jnp.matmul(n_world, cam.rot, precision="highest")

        if "blend" in dbg:
            rgba = jnp.full(hit_pos.shape[:-1] + (4,), 0.7, jnp.float32)
        elif c.shade_mode == 3:
            rgb = raymarch.blend_cameras(
                hit_pos, calib.cv_xyz_inv, maps.depth[..., 0], maps.quality,
                limit,
            )
            rgba = jnp.concatenate(
                [rgb, jnp.ones_like(rgb[..., :1])], axis=-1
            )
        else:
            if c.blend_mode in ("normal_deviation", "best_two"):
                # the reference's blendColors2 variants
                # (tsdf_raymarch.fs:266-301)
                rgba = raymarch.blend_colors_normal(
                    hit_pos, world_pos, grad, proj_models,
                    calib.cv_xyz_inv, calib.cv_uv, maps.color,
                    maps.depth[..., 0], maps.normal, limit,
                    variant=(
                        "best_two" if c.blend_mode == "best_two"
                        else "deviation"
                    ),
                )
            elif proj_models is not None:
                rgba = raymarch.blend_colors_analytic(
                    world_pos, proj_models, maps.color, maps.depth[..., 0],
                    maps.quality, limit,
                    # reuse the integrate-taps fidelity knob: parity
                    # configs set "bilinear" and get the exact fetch
                    dq_taps=c.integrate_taps,
                )
            else:
                blend = (
                    raymarch.blend_colors_fast
                    if c.march_mode == "nearest"
                    else raymarch.blend_colors
                )
                rgba = blend(
                    hit_pos, calib.cv_xyz_inv, calib.cv_uv, maps.color,
                    maps.depth[..., 0], maps.quality, limit,
                )
            shaded = raymarch.shade(
                view_pos, view_normal, rgba[..., :3],
                shade_mode=c.shade_mode, world_normal=n_world,
            )
            rgba = jnp.concatenate([shaded, rgba[..., 3:]], axis=-1)

        view_z = jnp.maximum(-view_pos[..., 2], near * 1.001)
        depth_win = jnp.clip(
            (1.0 / near - 1.0 / view_z) / (1.0 / near - 1.0 / far),
            0.0, 1.0,
        )
        depth_win = jnp.where(hit, depth_win, 1.0)
        rgba = jnp.where(hit[..., None], rgba, 0.0)
        return rgba, depth_win

    def _surface_brick_mask(self, volume):
        """(Bz, By, Bx) bool: bricks whose 1-voxel-dilated neighborhood
        contains a positive TSDF voxel — exactly the bricks where a march
        sample (nearest or trilinear) can read a positive density, i.e.
        where ray-surface crossings can occur. Much tighter than the marked
        occupancy mask (which includes silhouette-carve-only bricks that
        rays previously marched through end to end finding nothing)."""
        v = self.brick_vox
        # 1-voxel dilation per axis (shift-and-pad — no face wraparound):
        # trilinear interpolation reaches at most one voxel beyond a
        # positive sample
        return _brick_any(_dilate3(volume > 0.0), self.volume_grid.shape, v)

    def make_render_fn(self, camera: raymarch.ViewCamera,
                       max_steps: Optional[int] = None):
        """Build the raw render function for ``camera``'s PROJECTION (image
        size, fov, near/far — static); its POSE flows in per call as
        :class:`CamParams` arrays.

        Returns ``(render, cam0)`` where
        ``render(volume, maps, brick_counts, calib, cam, proj_models)`` is
        pure and unjitted — the form the dist/ layer traces inside its own
        sharded step (all large arrays are arguments, nothing big is
        captured) — and ``cam0`` is the CamParams of the given camera.
        """
        c = self.config
        H, W = camera.height, camera.width
        near, far = float(camera.near), float(camera.far)
        tan_half = float(np.tan(np.radians(camera.fov_y) * 0.5))
        aspect = W / H
        bbox_size = np.asarray(self.bbox.size, np.float32)
        vol_shape = self.volume_grid.shape
        brick_vox = self.brick_vox

        if max_steps is None:
            # worst case: volume diagonal at limit/2 normalized steps
            max_steps = int(np.ceil(np.sqrt(3.0) / (c.tsdf_limit * 0.5)))
        sd = c.tsdf_limit * 0.5

        pack_dtype = (
            jnp.bfloat16 if c.march_dtype == "bfloat16" else None
        )
        # grazing silhouette rays march near-parallel to the surface for
        # hundreds of potential steps; bound the block march and the last
        # tail stage (unfinished rays fall out as background — extreme
        # grazers only; the reference's while(true) pays the full cost)
        blk_budget = min(max_steps, 64)
        tail_budget = (
            min(max_steps, c.march_tail_budget)
            if c.march_tail_budget > 0
            else min(max_steps, 10 * max(c.march_phase1_steps, 8) + 32)
        )
        ds = max(int(c.interval_downsample), 1)
        Hp, Wp = -(-H // ds) * ds, -(-W // ds) * ds
        Hb, Wb = Hp // ds, Wp // ds
        B2 = ds * ds
        NB = Hb * Wb
        # degenerate-small images (fewer than 4 blocks per axis): one coarse
        # ray per block undersamples thin geometry — march densely instead
        use_blocks = (
            c.skip_space and c.bricking and c.ray_compaction > 0.0
            and Hb >= 4 and Wb >= 4
        )

        # coarse scan step: fraction of the smallest normalized brick edge
        # (default 0.75). The scan targets the 1-brick-dilated
        # surface-brick set, whose in-set run along any crossing ray is
        # >= one full brick edge, so any step <= 1.0 brick cannot cross it
        # unsampled; beyond 1.0 the detection guarantee breaks.
        if not (0.0 < c.interval_step_frac <= 1.0):
            raise ValueError(
                "interval_step_frac must be in (0, 1]: the dilated-set "
                f"detection guarantee breaks beyond 1.0 (got "
                f"{c.interval_step_frac})"
            )
        h_min = 1.0 / max(vol_shape)
        brick_norm = brick_vox * h_min
        step_len = c.interval_step_frac * brick_norm
        n_scan = int(np.ceil(np.sqrt(3.0) / step_len)) + 2

        def ray_dirs(cam: CamParams, hh, ww):
            """PLANAR unit volume-space directions: a tuple of three
            (hh, ww) component planes, from iota (camera pose is data, not
            a compile-time constant). Planar rather than one array with
            a 3-wide minor axis."""
            xs = ((jnp.arange(ww, dtype=jnp.float32) + 0.5) / W * 2.0 - 1.0)
            ys = 1.0 - (jnp.arange(hh, dtype=jnp.float32) + 0.5) / H * 2.0
            xx, yy = jnp.meshgrid(xs * tan_half * aspect, ys * tan_half)
            # dirs_world[j] = dirs_cam . rot_row_j with dirs_cam z = -1
            dv = [
                (xx * cam.rot[j, 0] + yy * cam.rot[j, 1] - cam.rot[j, 2])
                / float(bbox_size[j])
                for j in range(3)
            ]
            inv_n = jax.lax.rsqrt(dv[0] ** 2 + dv[1] ** 2 + dv[2] ** 2)
            return tuple(d * inv_n for d in dv)

        def surface_aabb(occ):
            """Normalized-coordinate AABB of the occupied bricks (dynamic,
            on device) — bounds the coarse scan to the geometry instead of
            the whole unit cube."""
            Bz, By, Bx = occ.shape
            Z, Y, X = vol_shape

            def lohi(any_ax, n, vox_per, true_n):
                idx = jnp.arange(n)
                lo = jnp.min(jnp.where(any_ax, idx, n))
                hi = jnp.max(jnp.where(any_ax, idx, -1))
                return (
                    lo.astype(jnp.float32) * vox_per / true_n,
                    jnp.minimum((hi + 1).astype(jnp.float32) * vox_per / true_n, 1.0),
                )

            zlo, zhi = lohi(occ.any(axis=(1, 2)), Bz, brick_vox, Z)
            ylo, yhi = lohi(occ.any(axis=(0, 2)), By, brick_vox, Y)
            xlo, xhi = lohi(occ.any(axis=(0, 1)), Bx, brick_vox, X)
            return (jnp.stack([xlo, ylo, zlo]), jnp.stack([xhi, yhi, zhi]))

        def scan_intervals(occ, bsafe, cam: CamParams, dirs_c):
            """Per-coarse-ray (s_first, s_last, s0, s1) arc lengths where
            ``first`` is the first sample inside the 1-brick-DILATED
            surface-brick set (the conservative march start) and ``last``
            the last sample inside an actual SURFACE brick (the far bound;
            -inf when the ray crossed only the dilated shell -> inactive)
            — the array-program re-design of the rasterized brick-hull
            depth peel (drawDepthLimits, recon_integration.cpp:409-429 +
            glsl/bricks.{vs,gs,fs}).

            All samples of all rays are fetched in ONE parallel gather and
            reduced along the sample axis, instead of a serialized
            while-loop scan with one dependent gather per step. Sample
            spacing is
            capped at interval_step_frac (validated <= 1.0) of the
            conservative brick edge: the dilated in-set run along any
            crossing ray is >= one brick edge, so it cannot be crossed
            unsampled; spans shorter than the sample budget are sampled
            proportionally finer."""
            Bz, By, Bx = occ.shape
            Z, Y, X = vol_shape
            # scan field coding: -1 surface brick, 0 dilated shell, +1 far.
            # Broadcast to 2-wide rows, the row width of every other
            # gather table here; this gather is ~1M rows per frame.
            field = jnp.where(
                occ, -1.0, jnp.where(bsafe == 0.0, 0.0, 1.0)
            ).reshape(-1)
            field2 = jnp.broadcast_to(field[:, None], (field.shape[0], 2))
            box_min, box_max = surface_aabb(occ)

            dcx, dcy, dcz = dirs_c

            def slab(c0, d, lo, hi):
                inv = 1.0 / d
                tb = inv * (lo - c0)
                tt = inv * (hi - c0)
                return jnp.minimum(tb, tt), jnp.maximum(tb, tt)

            l0, h0 = slab(cam.eye_vol[0], dcx, box_min[0], box_max[0])
            l1, h1 = slab(cam.eye_vol[1], dcy, box_min[1], box_max[1])
            l2, h2 = slab(cam.eye_vol[2], dcz, box_min[2], box_max[2])
            s0 = jnp.maximum(jnp.maximum(l0, l1), l2)
            s1 = jnp.minimum(jnp.minimum(h0, h1), h2)
            valid = (s0 <= s1) & (s1 > 0.0)
            s0 = jnp.maximum(s0, 0.0)
            s1 = jnp.where(valid, s1, -1.0)

            ks = jnp.arange(n_scan, dtype=jnp.float32)
            spacing = jnp.minimum((s1 - s0) / (n_scan - 1), step_len)
            t = s0[..., None] + ks * spacing[..., None]     # (..., n_scan)
            bx = jnp.clip(
                ((cam.eye_vol[0] + dcx[..., None] * t) * X).astype(jnp.int32)
                // brick_vox, 0, Bx - 1)
            by = jnp.clip(
                ((cam.eye_vol[1] + dcy[..., None] * t) * Y).astype(jnp.int32)
                // brick_vox, 0, By - 1)
            bz = jnp.clip(
                ((cam.eye_vol[2] + dcz[..., None] * t) * Z).astype(jnp.int32)
                // brick_vox, 0, Bz - 1)
            s = field2[(bz * By + by) * Bx + bx][..., 0]    # one gather
            inside = valid[..., None] & (t <= s1[..., None])
            tgt = (s < 0.5) & inside
            surf = (s < -0.5) & inside
            big = jnp.float32(np.inf)
            first = jnp.min(jnp.where(tgt, t, big), axis=-1)
            last = jnp.max(jnp.where(surf, t, -big), axis=-1)
            # first sample inside an actual SURFACE brick: any crossing in
            # a SAMPLED surface brick lies at >= fsurf - one brick edge
            # (the sample is within 0.75 brick of the crossing along the
            # ray), so the march can skip the shell run-up before it. A
            # crossing in a corner-clipped brick with no sample has the
            # same exposure as the existing far bound (``last`` is also
            # sample-based); 3x3 pooling adds conservatism.
            fsurf = jnp.min(jnp.where(surf, t, big), axis=-1)
            return first, last, fsurf, s0, jnp.where(valid, s1, 0.0)

        def pool3(x, op):
            p = jnp.pad(x, 1, mode="edge")
            out = x
            for dy in (0, 1, 2):
                for dx in (0, 1, 2):
                    out = op(out, p[dy: dy + x.shape[0], dx: dx + x.shape[1]])
            return out

        num_lods = c.num_lods

        def finalize(rgba, depth_win, hit_img, num_img, overflow):
            if c.colorfill:
                # planar channels: W in lanes, not the 4-wide C axis
                filled, depth_out = holefill.fill_colors_planar(
                    [rgba[..., i] for i in range(4)], depth_win, num_lods
                )
                rgb_planes = filled[:3]
            else:
                rgb_planes = [rgba[..., i] for i in range(3)]
                depth_out = depth_win
            # background compositing: the reference relies on the colorfill
            # pass writing gl_FragDepth = 1.0 for empty pixels, which fails
            # the GL_LESS depth test against the cleared buffer
            # (tsdf_inpaint.fs:35, view clear) — equivalent dense mask here.
            shown = depth_out < 1.0
            color = jnp.stack(
                [jnp.where(shown, p, 0.0) for p in rgb_planes], axis=-1
            )
            return RenderOutput(
                color=color, depth=depth_out, hit=hit_img,
                num_samples=num_img, overflow=overflow,
            )

        def fine_safe_field(pos_mask):
            """Voxel-level Chebyshev clearance (0..skip_fine_rounds) to the
            1-dilated positive set — pure local stencil, so the dist/ layer
            can run it per shard on halo-extended slabs."""
            fine_reach = _dilate3(pos_mask)
            fine_safe = (~fine_reach).astype(jnp.float32)
            for _ in range(c.skip_fine_rounds - 1):
                fine_reach = _dilate3(fine_reach)
                fine_safe = fine_safe + (~fine_reach).astype(jnp.float32)
            return fine_safe

        def brick_safe_field(occ):
            """Brick-level Chebyshev clearance to the surface-brick set:
            bsafe[b] = min(D-1, rounds) for a brick at Chebyshev brick
            distance D. Drives both the sphere-traced scan and the
            far-field skip sentinels (a voxel in a brick at distance D is
            >= (D-1)*brick_vox + 1 voxels from any surface voxel)."""
            reach = occ
            bsafe = jnp.zeros(occ.shape, jnp.float32)
            for _ in range(c.skip_brick_rounds):
                reach = _dilate3(reach)
                bsafe = bsafe + (~reach).astype(jnp.float32)
            return bsafe

        def sentinel_volume(volume, fine_safe, bsafe, limit, z0=0, zl=None):
            """Bake skip sentinels -(2 + safe*h_min) into the volume. The
            near field comes from a few dense dilations (exactly safe for
            nearest sampling: a step of (d-1) voxel extents from a voxel
            at Chebyshev distance d cannot reach a positive voxel), the
            far field broadcast from the brick clearance — O(bricks)
            instead of the 36 dense dilations of round 3. ``z0``/``zl``
            select a z-slab of the brick field (dist/ shards call this per
            shard)."""
            (Bz, By, Bx), padded = tsdf.brick_layout(vol_shape, brick_vox)
            Z, Y, X = vol_shape
            bsv = (bsafe * brick_vox)[:, None, :, None, :, None]
            bs_vox = jnp.broadcast_to(
                bsv, (bsafe.shape[0], brick_vox, By, brick_vox, Bx, brick_vox)
            ).reshape(bsafe.shape[0] * brick_vox, By * brick_vox,
                      Bx * brick_vox)[:, :Y, :X]
            if zl is not None:
                bs_vox = jax.lax.dynamic_slice_in_dim(bs_vox, z0, zl, 0)
            else:
                bs_vox = bs_vox[:Z]
            safe_field = jnp.maximum(fine_safe, bs_vox)
            # INTEGER sentinel encoding -(2 + steps): exact in bf16; the
            # march rescales by sentinel_scale = h_min at decode
            return jnp.where(
                safe_field > 0.0, -(2.0 + safe_field), volume
            )

        skip_ = c.march_empty_skip and c.march_mode == "nearest"
        # half-pair march table: fast path only, brick-aligned even dims
        use_half = (
            skip_ and brick_vox >= 2
            and all(s % brick_vox == 0 for s in vol_shape)
            and vol_shape[2] % 2 == 0
        )
        # compact cell-corner hit table (rides the half-pair layout).
        # Gated on surface_skip: the marked-occupancy mask used otherwise
        # can both overflow the oct capacity and miss dilated-positive
        # bricks at faces, so hits would systematically anchor off-table.
        use_oct = use_half and c.oct_hit_table and c.surface_skip
        # 1.2x headroom over the integrate capacity: the surface-brick set
        # (dilated positives) tracks the occupied set closely, and the
        # build's row writes are the bake's dominant cost (drops are
        # observable via RenderOutput.overflow[3])
        oct_capacity = -(-int(1.2 * c.brick_capacity) // 8) * 8

        def build_oct(volume, occ, limit):
            """Compact cell-corner table from the RAW fused volume (exact
            reference field values — no sentinels to clamp away)."""
            return raymarch.build_oct_bricks(
                volume, occ, brick_vox, oct_capacity, limit,
                dtype=pack_dtype or jnp.float32,
            )

        def bake(volume, brick_counts, limit):
            """volume -> (PackedVolume, OctVolume | None, surface-brick
            mask, brick clearance field, sentinel clamp floor). The
            single-device form of the march-volume bake; dist/ reproduces
            it shard-wise with halo exchange."""
            dil1 = _dilate3(volume > 0.0)
            if c.surface_skip:
                occ = _brick_any(dil1, vol_shape, brick_vox)
            else:
                occ = brick_ops.occupied_mask(
                    brick_counts, c.min_voxels_per_brick
                )
            bsafe = brick_safe_field(occ)
            if skip_:
                vol_m = sentinel_volume(
                    volume, fine_safe_field(volume > 0.0), bsafe, limit
                )
                packed = raymarch.PackedVolume.from_volume(
                    vol_m, dtype=pack_dtype, half=use_half
                )
                oct = build_oct(volume, occ, limit) if use_oct else None
                # the packed table feeds MANY gather consumers (march
                # stages, refine, shading); without a barrier XLA clones
                # the whole dilation-bake chain into each of them (the
                # same rematerialization pathology measured in holefill)
                barrier = [packed.pairs, occ, bsafe]
                if oct is not None:
                    barrier += [oct.rows, oct.slots]
                barrier = jax.lax.optimization_barrier(tuple(barrier))
                pairs, occ, bsafe = barrier[:3]
                packed = raymarch.PackedVolume(
                    pairs=pairs, shape=packed.shape, half=packed.half
                )
                if oct is not None:
                    oct = raymarch.OctVolume(
                        rows=barrier[3], slots=barrier[4],
                        shape=oct.shape, brick_vox=oct.brick_vox,
                    )
                return packed, oct, occ, bsafe, -limit
            packed = raymarch.PackedVolume.from_volume(volume)
            pairs, occ, bsafe = jax.lax.optimization_barrier(
                (packed.pairs, occ, bsafe)
            )
            return (raymarch.PackedVolume(pairs=pairs, shape=packed.shape),
                    None, occ, bsafe, None)

        def render_blocks(volume, maps: SensorMaps, brick_counts, calib,
                          cam: CamParams, proj_models, limit):
            """Block-compacted staged surface march: the hot path.

            Stages: (1) sphere-traced brick scan -> per-block march
            intervals; (2) one coarse density march per active block ->
            3x3-pooled hit brackets; (3) bracketed fine march of all rays
            in active blocks; (4) narrowing tail stages for unfinished
            rays (grazing silhouette rays are the long tail); (5)
            hit-compacted secant refine + shading.
            """
            baked = bake(volume, brick_counts, limit)
            return render_from_baked(
                baked, maps, calib, cam, proj_models, limit
            )

        def render_from_baked(baked, maps: SensorMaps, calib,
                              cam: CamParams, proj_models, limit):
            """March + shade + fill from an already-baked march volume —
            the entry the dist/ layer uses after its shard-wise bake."""
            Z, Y, X = vol_shape
            skip = skip_
            packed, oct, occ, bsafe, floor = baked
            chunked = c.march_chunk > 0 and c.march_mode == "nearest"

            def do_march(pos0, dirs, budget, length, resume=None,
                         chunk=None):
                """March dispatch: chunked parallel gathers when ``chunk``
                is set (dense bracketed work: the whole window is one wide
                gather at the streaming rate), the serial sentinel loop
                otherwise (sparse long-distance work: per-step jumps cover
                far more ground per sample). Returns (hit, num, state)
                with state = (t, prev_t, prev, lo_t, hi_t, hit_t)."""
                if chunked and chunk:
                    return raymarch.march_chunked(
                        packed, pos0, dirs, limit, budget, length,
                        chunk=min(chunk, budget),
                        sentinel_skip=skip, sentinel_scale=h_min,
                        resume=resume,
                    )
                hit, _, num, st = raymarch.march(
                    packed, cam.eye_vol, dirs, limit, budget,
                    (pos0, length), mode=c.march_mode, resume=resume,
                    refine_nearest=False, sentinel_skip=skip,
                    sentinel_scale=h_min, return_state=True,
                )
                return hit, num, st

            dn = ray_dirs(cam, Hp, Wp)          # 3x (Hp, Wp) planes
            dirs_c = tuple(d[ds // 2::ds, ds // 2::ds] for d in dn)

            # interval scan at HALF block resolution (one ray per 2x2
            # blocks = 8x8 pixels): the 3x3 pooling below then covers a
            # +-1 coarse-cell = +-2 block neighborhood of every block, so
            # the conservative guarantee is preserved with 4x fewer scan
            # rays; the per-block density march re-tightens the brackets
            sc = 2
            first_c, last_c, fsurf_c, s0_c, s1_c = scan_intervals(
                occ, bsafe, cam, tuple(d[::sc, ::sc] for d in dirs_c)
            )

            def upc(xc, op):
                # conservative block interval: 3x3 min/max pooling over
                # coarse rays (including the box entry/exit, so a fine ray
                # near the block corner is never clamped to its neighbor's
                # box — the round-2 t_near/t_far broadcast bug), then
                # nearest upsample back to the block grid
                p = pool3(xc, op)
                r = jnp.repeat(jnp.repeat(p, sc, axis=0), sc, axis=1)
                return r[:Hb, :Wb]

            first = upc(first_c, jnp.minimum)
            last = upc(last_c, jnp.maximum)
            fsurf = upc(fsurf_c, jnp.minimum)
            s0p = upc(s0_c, jnp.minimum)
            s1p = upc(s1_c, jnp.maximum)
            # scan discretization guard: the true dilated-set entry is at
            # most one scan step before the first in-set sample, and the
            # earliest surface voxel is at least ~the shell crossing past
            # the entry
            pad = 0.75 * step_len
            found = jnp.isfinite(first) & jnp.isfinite(last)
            # skip the shell run-up: no crossing can precede the first
            # surface-brick sample by more than a brick edge (see
            # scan_intervals) — tangent rays otherwise crawl through long
            # shell-only stretches before reaching the surface bricks
            s_start = jnp.maximum(
                jnp.maximum(first - pad, fsurf - brick_norm - pad), s0p
            )
            s_end = jnp.minimum(last + step_len + pad, s1p)
            length = jnp.where(found, jnp.maximum(s_end - s_start, 0.0), 0.0)
            s_start = jnp.where(found, s_start, 0.0)

            # block compaction: fixed-capacity gather of active 4x4 pixel
            # blocks (bookkeeping is 16x cheaper than per-ray compaction and
            # all per-ray fetches become wide contiguous rows)
            flags = (length > 0.0).reshape(NB)
            # floor of 2048 blocks: small images are simply fully covered
            # (the fractional cap is a large-image economy)
            capB = min(NB, max(-(-int(NB * c.ray_compaction) // 8) * 8, 2048))
            (blk_idx,) = jnp.nonzero(flags, size=capB, fill_value=NB)
            safe = jnp.minimum(blk_idx, NB - 1)
            live_b = blk_idx < NB

            # ---- coarse density march: one center ray per active block --
            dirs_cb = tuple(d.reshape(NB)[safe] for d in dirs_c)
            sstart_c = jnp.where(live_b, s_start.reshape(NB)[safe], 0.0)
            len_c = jnp.where(live_b, length.reshape(NB)[safe], 0.0)
            pos0_c = tuple(
                cam.eye_vol[i] + dirs_cb[i] * sstart_c for i in range(3)
            )
            bhit, _, bst = do_march(
                pos0_c, dirs_cb, blk_budget, len_c
            )
            blo = sstart_c + bst[3]
            bhi = sstart_c + bst[4]

            # 3x3-pooled per-block hit brackets on the full block grid
            big_f = jnp.float32(np.inf)
            hit_g = jnp.zeros((NB,), jnp.float32).at[blk_idx].set(
                bhit.astype(jnp.float32), mode="drop").reshape(Hb, Wb)
            lo_g = jnp.full((NB,), big_f).at[blk_idx].set(
                jnp.where(bhit, blo, big_f), mode="drop").reshape(Hb, Wb)
            hi_g = jnp.full((NB,), -big_f).at[blk_idx].set(
                jnp.where(bhit, bhi, -big_f), mode="drop").reshape(Hb, Wb)
            all9 = pool3(hit_g, jnp.minimum) > 0.5
            lo9 = pool3(lo_g, jnp.minimum)
            hi9 = pool3(hi_g, jnp.maximum)
            margin = c.bracket_margin_steps * sd
            # trust the bracket only when every neighboring block ray hit,
            # the bracket is narrow, and it starts close to the interval
            # entry (a large gap means foreground geometry could hide
            # between the coarse rays -> full-interval march); rays that
            # miss inside the bracket continue to the full interval in the
            # tail stages, so bracketing cannot drop geometry behind it
            bracket_ok = (
                all9
                & ((hi9 - lo9) < c.bracket_max_steps * sd)
                & ((lo9 - s_start) < 2.0 * brick_norm + pad)
            )
            if c.bracket_per_block:
                # each block's OWN coarse-ray bracket, widened by the 3x3
                # depth spread (the local surface slope bound): much
                # narrower than the pooled union on sloped surfaces, so
                # the chunked fine march covers it in one ~12-sample
                # chunk. Guards above still use the pooled values.
                spread = 0.125 * (hi9 - lo9)
                blo_b = jnp.where(jnp.isfinite(lo_g), lo_g, s_start)
                bhi_b = jnp.where(jnp.isfinite(hi_g), hi_g, s_end)
                b_lo = blo_b - margin - spread
                b_hi = bhi_b + margin + spread
            else:
                b_lo = lo9 - margin
                b_hi = hi9 + margin
            f_start = jnp.where(
                bracket_ok, jnp.maximum(b_lo, s_start), s_start
            )
            len_brkt = jnp.where(
                found & bracket_ok,
                jnp.maximum(jnp.minimum(b_hi, s_end) - f_start, 0.0),
                length,
            )
            len_full = jnp.maximum(
                jnp.where(found, s_end - f_start, 0.0), 0.0
            )

            # ---- fine march: all rays of active blocks ------------------
            sstart_b = jnp.where(live_b, f_start.reshape(NB)[safe], 0.0)
            lbrkt_b = jnp.where(live_b, len_brkt.reshape(NB)[safe], 0.0)
            lfull_b = jnp.where(live_b, len_full.reshape(NB)[safe], 0.0)

            R = capB * B2

            def to_rays(plane):
                blocks = (
                    plane.reshape(Hb, ds, Wb, ds)
                    .transpose(0, 2, 1, 3)
                    .reshape(NB, B2)
                )
                return blocks[safe].reshape(R)

            dn_f = tuple(to_rays(d) for d in dn)
            sstart_f = jnp.broadcast_to(
                sstart_b[:, None], (capB, B2)).reshape(R)
            pos0_f = tuple(
                cam.eye_vol[i] + dn_f[i] * sstart_f for i in range(3)
            )
            len_brkt_f = jnp.broadcast_to(
                lbrkt_b[:, None], (capB, B2)).reshape(R)
            len_full_f = jnp.broadcast_to(
                lfull_b[:, None], (capB, B2)).reshape(R)

            # Per-ray constants + march state kept as PACKED 8-wide rows
            # across every compaction boundary: the tail/hit compactions
            # then cost ONE wide-row gather (and one wide scatter) instead
            # of 8+ narrow ones.
            ray8 = jnp.stack(
                [pos0_f[0], pos0_f[1], pos0_f[2],
                 dn_f[0], dn_f[1], dn_f[2], len_full_f, len_brkt_f],
                axis=-1,
            )

            overflow2 = jnp.int32(0)
            if c.march_phase1_steps > 0 and skip:
                p1 = c.march_phase1_steps
                hit, num, st = do_march(
                    pos0_f, dn_f, p1, len_brkt_f, chunk=p1
                )
                st8 = jnp.stack(
                    [st[0], st[1], st[2], st[3], st[4], st[5],
                     hit.astype(jnp.float32), num.astype(jnp.float32)],
                    axis=-1,
                )
                # narrowing tail stages over the FULL interval: stage 1
                # catches bracket-miss and ordinary edge rays, stage 2 runs
                # the few grazing rays to exhaustion
                budget_used = p1
                # tails stay SERIAL: their work is sparse long-distance
                # travel where per-step sentinel jumps cover ~an order of
                # magnitude more ground per sample than dense chunks
                stages = ((3, 3 * p1), (10, tail_budget))
                for divisor, budget in stages:
                    steps = min(budget, max_steps - budget_used)
                    if steps <= 0:
                        break
                    unfinished = (
                        (st8[:, 6] < 0.5)
                        & (st8[:, 0] <= ray8[:, 6])
                        & (ray8[:, 6] > 0.0)
                    )
                    cap_t = max(-(-R // divisor // 8) * 8, min(R, 1024))
                    (idx2,) = jnp.nonzero(
                        unfinished, size=cap_t, fill_value=R
                    )
                    safe2 = jnp.minimum(idx2, R - 1)
                    rg = ray8[safe2]
                    sg = st8[safe2]
                    len2 = jnp.where(idx2 < R, rg[:, 6], 0.0)
                    hit2, num2, st2 = do_march(
                        (rg[:, 0], rg[:, 1], rg[:, 2]),
                        (rg[:, 3], rg[:, 4], rg[:, 5]), steps, len2,
                        resume=(sg[:, 0], sg[:, 1], sg[:, 2]),
                    )
                    budget_used += steps
                    new8 = jnp.stack(
                        [st2[0], st2[1], st2[2], st2[3], st2[4], st2[5],
                         hit2.astype(jnp.float32),
                         sg[:, 7] + num2.astype(jnp.float32)],
                        axis=-1,
                    )
                    st8 = st8.at[idx2].set(new8, mode="drop")
                    overflow2 = jnp.maximum(
                        overflow2,
                        jnp.sum(unfinished.astype(jnp.int32)) - cap_t,
                    )
            else:
                hit, num, st = do_march(
                    pos0_f, dn_f, max_steps, len_full_f
                )
                st8 = jnp.stack(
                    [st[0], st[1], st[2], st[3], st[4], st[5],
                     hit.astype(jnp.float32), num.astype(jnp.float32)],
                    axis=-1,
                )

            hit = st8[:, 6] > 0.5
            num = st8[:, 7].astype(jnp.int32)

            # hit compaction: normals/color/shading run on the hit set only
            hit_frac = c.hit_compaction if c.hit_compaction > 0.0 else 1.0
            capH = min(R, -(-int(R * hit_frac) // 8) * 8)
            (hit_idx,) = jnp.nonzero(hit, size=capH, fill_value=R)
            safeH = jnp.minimum(hit_idx, R - 1)
            live_h = hit_idx < R
            rh = ray8[safeH]
            sh = st8[safeH]
            pos0_h = (rh[:, 0], rh[:, 1], rh[:, 2])
            dn_h = (rh[:, 3], rh[:, 4], rh[:, 5])
            hit_pos_h = jnp.stack(
                [rh[:, i] + rh[:, 3 + i] * sh[:, 5] for i in range(3)],
                axis=-1,
            )
            # secant refinement at the crossing bracket, paid per HIT
            # (trilinear samples — exact for parity mode too: the secant of
            # the same bracket on the same field). Rays whose trilinear
            # bracket does not confirm the crossing keep the march's own
            # secant position (the reference's unrefined behavior). The
            # compact oct table evaluates the RAW fused field (one 8-wide
            # row per sample) when available.
            if "refine" in c.debug_skip:
                hp = hit_pos_h
            elif oct is not None:
                hp = raymarch.oct_refine_crossing(
                    oct, pos0_h, dn_h, sh[:, 3], sh[:, 4],
                    live_h, hit_pos_h, limit,
                    # widened re-bracket only where the march bracketed the
                    # nearest-tap field; the trilinear march's bracket IS
                    # the trilinear field's, keep the exact endpoint secant
                    widen_steps=(
                        c.refine_widen_steps
                        if c.march_mode == "nearest" else 0.0
                    ),
                    widen_samples=c.refine_widen_samples,
                )
            else:
                hp = raymarch.refine_crossing(
                    packed, pos0_h, dn_h, sh[:, 3], sh[:, 4],
                    live_h, hit_pos_h,
                    clamp_floor=floor,
                )

            rgba_h, depth_h = self._shade_hits(
                packed, live_h, hp, maps, calib, proj_models, cam, near, far,
                limit=limit, clamp_floor=floor, oct=oct,
            )

            # Pack every per-ray output channel into ONE (R, 8) buffer and
            # do ONE hit-set scatter + ONE block scatter: the previous 3
            # hit scatters + 4 full-screen unblock scatters cost a
            # scatter pass each; the block scatter's rows here are
            # B2*8 = 128 values wide.
            hit6 = jnp.concatenate(
                [rgba_h, depth_h[:, None],
                 live_h.astype(jnp.float32)[:, None]],
                axis=-1,
            )
            buf6 = jnp.zeros((R, 6), jnp.float32).at[hit_idx].set(
                hit6, mode="drop"
            )
            buf8 = jnp.concatenate(
                [buf6, st8[:, 7:8], jnp.zeros((R, 1), jnp.float32)],
                axis=-1,
            )

            img8_full = jnp.zeros((NB, B2, 8), jnp.float32).at[blk_idx].set(
                buf8.reshape(capB, B2, 8), mode="drop"
            )
            img8 = (
                img8_full.reshape(Hb, Wb, ds, ds, 8)
                .transpose(0, 2, 1, 3, 4)
                .reshape(Hp, Wp, 8)[:H, :W]
            )
            rgba_img = img8[..., :4]
            hit_img = img8[..., 5] > 0.5
            # depth default is background (1.0); the packed buffer's zero
            # fill maps back through the hit mask
            depth_img = jnp.where(hit_img, img8[..., 4], 1.0)
            num_img = img8[..., 6].astype(jnp.int32)

            oct_over = (
                jnp.maximum(
                    jnp.sum(occ.astype(jnp.int32)) - oct_capacity, 0
                )
                if oct is not None else jnp.int32(0)
            )
            overflow = jnp.stack([
                jnp.maximum(jnp.sum(flags.astype(jnp.int32)) - capB, 0),
                overflow2,
                jnp.maximum(jnp.sum(hit.astype(jnp.int32)) - capH, 0),
                oct_over,
            ])
            return finalize(rgba_img, depth_img, hit_img, num_img, overflow)

        def render_dense(volume, maps: SensorMaps, brick_counts, calib,
                         cam: CamParams, proj_models, limit):
            """Full-screen march without compaction: the parity/debug path
            (also used when bricking or space skipping is disabled)."""
            packed = raymarch.PackedVolume.from_volume(volume)
            dn = ray_dirs(cam, H, W)
            hit, hit_pos, num = raymarch.march(
                packed, cam.eye_vol, dn, limit, max_steps, None,
                mode=c.march_mode,
            )
            rgba, depth_win = self._shade_hits(
                packed, hit, hit_pos, maps, calib, proj_models, cam, near, far,
                limit=limit,
            )
            overflow = jnp.zeros((4,), jnp.int32)
            return finalize(rgba, depth_win, hit, num, overflow)

        render = render_blocks if use_blocks else render_dense
        # building blocks for the dist/ layer: shard-wise bake with halo
        # exchange, then march from the gathered baked volume
        render.bake = bake
        render.render_from_baked = (
            render_from_baked if use_blocks else None
        )
        render.fine_safe_field = fine_safe_field
        render.brick_safe_field = brick_safe_field
        render.sentinel_volume = sentinel_volume
        render.uses_sentinels = skip_
        render.use_blocks = use_blocks
        render.pack_dtype = pack_dtype if skip_ else None
        # oct hit-table hooks for the dist/ layer: march tables use the
        # half-pair layout iff the oct table serves the hit path
        render.march_half = use_half
        render.build_oct = build_oct if use_oct else None
        cam0 = CamParams.from_camera(camera, self.bbox)
        return render, cam0

    def make_renderer(
        self,
        camera: raymarch.ViewCamera,
        max_steps: Optional[int] = None,
        jit_compile: bool = True,
    ):
        """Returns render(volume, maps, brick_counts=None, camera=None) ->
        RenderOutput, jitted by default. The camera POSE is threaded through
        as arrays (CamParams), so per-frame navigation (OrbitNavigator,
        stereo eyes, the feedback channel) re-renders without recompiling;
        pass ``camera=`` per call to move the view. The renderer tracks the
        pipeline's reconfiguration generation: after reconfigure()/
        set_voxel_size() it rebuilds its traced program lazily on the next
        call, so existing renderer handles stay valid."""
        state = {"gen": None, "inner": None, "cam0": None}

        def _ensure():
            if state["gen"] != self._generation:
                render, cam0 = self.make_render_fn(camera, max_steps)
                state["inner"] = jax.jit(render) if jit_compile else render
                state["cam0"] = cam0
                state["gen"] = self._generation

        def renderer(volume, maps: SensorMaps, brick_counts=None,
                     camera_pose=None):
            _ensure()
            if camera_pose is None:
                cam = state["cam0"]
            elif isinstance(camera_pose, CamParams):
                cam = camera_pose
            else:
                cam = CamParams.from_camera(camera_pose, self.bbox)
            # calib + models resolved per call so update_calibration()
            # (pose refinement, runtime reconfig) takes effect without
            # rebuilding renderers
            pm = self._get_projection_models()
            return state["inner"](
                volume, maps, brick_counts, self.calib, cam, pm, self._limit
            )

        return renderer
