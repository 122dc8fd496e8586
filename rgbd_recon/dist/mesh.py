"""Device-mesh distribution of the reconstruction pipeline.

The reference is a single-GPU application; multi-chip scaling is this
framework's new capability (SURVEY.md §2.10, BASELINE.md north star). The
spatial analogue of the reference's brick decomposition becomes the sharding
unit — and since round 4 the sharded step runs the same BRICK-COMPACT fast
path as a single chip:

  - per-voxel projection bakes and the TSDF volume are sharded over brick
    z-slabs (`P('z')`, brick-aligned so each device owns whole bricks),
  - each device compacts ITS OWN occupied bricks (per-shard `nonzero`) and
    integrates only those — zero communication in the fusion step,
  - the march-volume bake (voxel-level Chebyshev skip field) runs as a
    per-shard stencil on halo-extended slabs (`dist.halo.halo_exchange_z`
    — ppermute to the neighbouring devices),
  - the brick-level clearance field is computed on the all-gathered brick
    occupancy (8.8k bools at reference scale — replicating it is free),
  - the march itself runs from the gathered baked volume: XLA gathers
    require device-local operands and rays traverse every z-slab, so the
    sentinel volume is all-gathered once per frame (an explicit,
    documented collective; ray hand-off between devices becomes worthwhile
    only for volumes that no longer fit one device's memory),
  - sensor maps and calibration stay replicated at reference scale
    (4 sensors / 1 host); many-sensor rigs shard the preprocess chain
    over the SENSOR axis instead (dist/preprocess.py — per-device
    stencil chains, psum'd brick histograms, all-gathered maps).

All shardings are expressed with `jax.sharding.NamedSharding` /
`shard_map` under `jit` (GSPMD), so the same code runs on one device, on
several GPUs of a host, or on the CPU 8-device test mesh. The mesh is 1-D:
it follows the z-slab decomposition alone, since every GPU of a host
reaches every other at the same rate.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .halo import halo_exchange_z


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "z") -> Mesh:
    """1-D mesh over the first n available devices. In a multi-controller
    run (jax.distributed.initialize), jax.devices() already spans every
    process, so the same call builds the host-spanning global mesh."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def _is_multiprocess(mesh: Mesh) -> bool:
    pi = jax.process_index()
    return any(d.process_index != pi for d in mesh.devices.flat)


def _put(x, sharding):
    """jax.device_put that also works when the sharding's mesh spans
    multiple PROCESSES (multi-controller): every process holds the same
    host value (deterministic construction), so each contributes its
    addressable shards via make_array_from_callback. Single-process
    meshes take the plain device_put fast path."""
    mesh = sharding.mesh
    if not _is_multiprocess(mesh):
        return jax.device_put(x, sharding)

    def put_leaf(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, sharding, lambda idx: a[idx]
        )

    return jax.tree_util.tree_map(put_leaf, x)


def _pad_to_multiple(arr: jnp.ndarray, axis: int, m: int):
    """Pad an axis to a multiple of m (sharded axes must divide evenly)."""
    size = arr.shape[axis]
    rem = (-size) % m
    if rem == 0:
        return arr, 0
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return jnp.pad(arr, pad), rem


def shard_pipeline_step(pipeline, camera, mesh: Mesh, axis_name: str = "z"):
    """Build a sharded full step: frames -> (volume, render output).

    Dispatches to the brick-compact sharded path (the fast path, matching
    single-chip defaults) whenever the pipeline itself is compact; falls
    back to the dense Z-sharded integration otherwise.
    """
    if pipeline.compact:
        return shard_compact_step(pipeline, camera, mesh, axis_name)
    return _shard_dense_step(pipeline, camera, mesh, axis_name)


def shard_compact_step(pipeline, camera, mesh: Mesh, axis_name: str = "z"):
    """Brick-compact sharded step (see module docstring).

    Parity: bit-identical to the single-device compact path as long as no
    per-shard brick capacity overflows (each shard gets the FULL
    brick_capacity, so the sharded step is strictly more permissive).
    """
    from ..ops import tsdf as tsdf_ops
    from ..ops.raymarch import PackedVolume
    from ..recon.tsdf_pipeline import _brick_any

    cfg = pipeline.config
    v = pipeline.brick_vox
    Nd = mesh.shape[axis_name]
    Z, Y, X = pipeline.volume_grid.shape
    (Bz, By, Bx), _padded = tsdf_ops.brick_layout((Z, Y, X), v)
    Bzl = -(-Bz // Nd)
    Bz_pad = Bzl * Nd
    Zl = Bzl * v
    N = pipeline.calib.num_sensors
    Kf = cfg.skip_fine_rounds

    repl = NamedSharding(mesh, P())
    shz = NamedSharding(mesh, P(axis_name))

    # z-major brick-slab sharding of the projection bake: (N, Bz_pad,
    # By*Bx, V, 4); padded slabs carry valid=-1 so they integrate to the
    # clear value
    proj = pipeline.projections
    Vv = proj.shape[2]
    projz = proj.reshape(N, Bz, By * Bx, Vv, 4)
    if Bz_pad > Bz:
        padrows = jnp.zeros((N, Bz_pad - Bz, By * Bx, Vv, 4), proj.dtype)
        padrows = padrows.at[..., 3].set(-1.0)
        projz = jnp.concatenate([projz, padrows], axis=1)
    projz = _put(projz, NamedSharding(mesh, P(None, axis_name)))

    calib = _put(pipeline.calib, repl)
    render_fn, cam0 = pipeline.make_render_fn(camera)
    cam0 = _put(cam0, repl)
    proj_models = pipeline._get_projection_models()
    if proj_models is not None:
        proj_models = _put(proj_models, repl)
    # each shard gets the full capacity -> never less permissive than the
    # single-device step
    cap_local = cfg.brick_capacity
    use_baked = (
        getattr(render_fn, "render_from_baked", None) is not None
        and render_fn.uses_sentinels
        and cfg.surface_skip
    )

    def local_integrate(proj_l, counts_l, depths, quals, sils, limit):
        # proj_l: (N, Bzl, By*Bx, V, 4); counts_l: (Bzl, By, Bx)
        ids = tsdf_ops.occupied_brick_ids(
            counts_l, cfg.min_voxels_per_brick, cap_local
        )
        return tsdf_ops.integrate_bricks(
            proj_l.reshape(N, Bzl * By * Bx, Vv, 4), ids, depths, quals,
            sils, limit, (Zl, Y, X), v,
            carve_sil_threshold=cfg.carve_sil_threshold,
            phantom_hull=cfg.phantom_hull, taps=cfg.integrate_taps,
        )

    def local_fine(ext_l):
        # halo-extended slab (Zl + 2*Kf, Y, X) -> exact local clearance
        return render_fn.fine_safe_field(ext_l)[Kf:-Kf]

    def local_occ(fine_l):
        # fine clearance == 0 exactly on the 1-dilated positive set
        occ_l = _brick_any(fine_l == 0.0, (Zl, Y, X), v)
        gathered = jax.lax.all_gather(occ_l, axis_name)
        return gathered.reshape(Bz_pad, By, Bx)

    def local_sentinels(vol_l, fine_l, bsafe, limit):
        idx = jax.lax.axis_index(axis_name)
        return render_fn.sentinel_volume(
            vol_l, fine_l, bsafe, limit, z0=idx * Zl, zl=Zl
        )

    sh = P(axis_name)

    def step(frames, calib, cam, pm, projz, limit):
        maps, counts = pipeline._preprocess_impl(calib, pm, frames)
        counts_p = jnp.pad(counts, ((0, Bz_pad - Bz), (0, 0), (0, 0)))

        vol_pad = shard_map(
            local_integrate, mesh=mesh,
            in_specs=(P(None, axis_name), sh, P(), P(), P(), P()),
            out_specs=sh, check_vma=False,
        )(projz, counts_p, maps.depth[..., 0], maps.quality,
          maps.silhouette, limit)

        volume = jax.lax.with_sharding_constraint(vol_pad[:Z], shz)

        if use_baked:
            pos = vol_pad > 0.0
            if Kf < Zl:
                ext = halo_exchange_z(
                    pos, mesh, halo=Kf, axis_name=axis_name
                )
                fine = shard_map(
                    local_fine, mesh=mesh, in_specs=(sh,), out_specs=sh,
                    check_vma=False,
                )(ext)
            else:
                # ghost width exceeds the local slab (tiny volumes/many
                # shards): single-hop halo exchange cannot source the
                # ghosts — compute the fine field from the gathered mask
                # (identical math; such volumes are small by construction)
                fine = jax.lax.with_sharding_constraint(
                    render_fn.fine_safe_field(
                        jax.lax.with_sharding_constraint(pos, repl)
                    ),
                    shz,
                )
            occ_pad = shard_map(
                local_occ, mesh=mesh, in_specs=(sh,), out_specs=P(),
                check_vma=False,
            )(fine)
            bsafe_pad = render_fn.brick_safe_field(occ_pad)
            vol_m_pad = shard_map(
                local_sentinels, mesh=mesh,
                in_specs=(sh, sh, P(), P()), out_specs=sh,
                check_vma=False,
            )(vol_pad, fine, bsafe_pad, limit)
            # explicit gather of the baked march volume: gather operands
            # must be device-local and rays traverse every z-slab
            vol_m = jax.lax.with_sharding_constraint(vol_m_pad[:Z], repl)
            oct = None
            if render_fn.build_oct is not None:
                # the oct table wants the RAW fused field: gather it
                # explicitly (f32, ~35 MB at reference scale — a second
                # documented collective). Reconstructing it from the
                # sentinel-coded march volume by clamping to -limit is NOT
                # exact in general: multi-sensor weighted fusion (or
                # tsdf_limit >> voxel_size) can leave raw values in
                # (-limit, 0) at sentinel-coded voxels, which would make
                # the oct secant/gradient diverge from the single-device
                # path and break the bitwise parity contract.
                vol_raw = jax.lax.with_sharding_constraint(
                    vol_pad[:Z], repl
                )
                oct = render_fn.build_oct(vol_raw, occ_pad[:Bz], limit)
            baked = (
                PackedVolume.from_volume(
                    vol_m, dtype=render_fn.pack_dtype,
                    half=render_fn.march_half,
                ),
                oct, occ_pad[:Bz], bsafe_pad[:Bz], -limit,
            )
            out = render_fn.render_from_baked(
                baked, maps, calib, cam, proj_models, limit
            )
        else:
            out = render_fn(
                jax.lax.with_sharding_constraint(volume, repl), maps,
                counts, calib, cam, proj_models, limit,
            )
        out = out.replace(
            color=jax.lax.with_sharding_constraint(
                out.color, NamedSharding(mesh, P(axis_name))
            )
        )
        return volume, out

    jitted = jax.jit(step)

    def run(frames):
        pm = pipeline._get_pixel_models(frames.depths.shape[1:3])
        if pm is not None:
            pm = _put(pm, repl)
        frames_g = (
            _put(frames, repl) if _is_multiprocess(mesh) else frames
        )
        return jitted(frames_g, calib, cam0, pm, projz,
                      float(pipeline.config.tsdf_limit))

    def lower(frames):
        """jax.stages.Lowered of the sharded step — lets callers inspect
        the compiled HLO's collectives."""
        pm = pipeline._get_pixel_models(frames.depths.shape[1:3])
        if pm is not None:
            pm = _put(pm, repl)
        return jitted.lower(frames, calib, cam0, pm, projz,
                            float(pipeline.config.tsdf_limit))

    run.lower = lower
    return run


def _shard_dense_step(pipeline, camera, mesh: Mesh, axis_name: str = "z"):
    """Dense Z-sharded integration (non-compact configs: fractional
    brick/voxel ratios, bricking disabled).

    - voxel grid + output volume: sharded over Z (`P('z')` on axis 0)
    - sensor maps / calibration: replicated
    - render rays: sharded over image rows
    """
    n = mesh.devices.size
    vol_sharding = NamedSharding(mesh, P(axis_name))
    ray_sharding = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    cfg = pipeline.config
    Z, Y, X = pipeline.volume_grid.shape
    padz = (-Z) % n
    vol_shape_p = (Z + padz, Y, X)
    bbox_size = tuple(float(s) for s in pipeline.bbox.size)

    calib = _put(pipeline.calib, repl)
    render_fn, cam0 = pipeline.make_render_fn(camera)
    cam0 = _put(cam0, repl)
    proj_models = pipeline._get_projection_models()
    if proj_models is not None:
        proj_models = _put(proj_models, repl)

    from ..ops import bricks as brick_ops
    from ..ops import tsdf as tsdf_ops

    def step(frames, calib, cam, pixel_models):
        maps, counts = pipeline._preprocess_impl(calib, pixel_models, frames)

        mask = None
        if cfg.bricking:
            occ = brick_ops.occupied_mask(counts, cfg.min_voxels_per_brick)
            mask = brick_ops.expand_mask_to_voxel_grid(
                occ, (Z, Y, X), bbox_size, cfg.brick_size
            )
            if padz:
                mask = jnp.pad(mask, ((0, padz), (0, 0), (0, 0)))
        # voxel centers over the padded grid, normalized by the TRUE
        # resolution: padded rows project outside every frustum and keep
        # the clear value, then get cropped below
        voxel_pos = tsdf_ops.voxel_centers(vol_shape_p, true_shape=(Z, Y, X))
        voxel_pos = jax.lax.with_sharding_constraint(voxel_pos, vol_sharding)
        volume_p = tsdf_ops.integrate(
            voxel_pos, calib.cv_xyz_inv,
            maps.depth[..., 0], maps.quality, maps.silhouette,
            cfg.tsdf_limit, voxel_mask=mask,
            carve_sil_threshold=cfg.carve_sil_threshold,
            phantom_hull=cfg.phantom_hull,
        )
        volume_p = jax.lax.with_sharding_constraint(volume_p, vol_sharding)
        volume = volume_p[:Z] if padz else volume_p
        out = render_fn(volume, maps, counts, calib, cam, proj_models,
                        jnp.float32(cfg.tsdf_limit))
        out = out.replace(
            color=jax.lax.with_sharding_constraint(out.color, ray_sharding)
        )
        return volume, out

    jitted = jax.jit(step)

    def run(frames):
        pm = pipeline._get_pixel_models(frames.depths.shape[1:3])
        if pm is not None:
            pm = _put(pm, repl)
        return jitted(frames, calib, cam0, pm)

    return run
