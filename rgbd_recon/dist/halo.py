"""Halo exchange for Z-sharded volumes.

The raymarch gradient (ops/raymarch.gradient_normal) and any future sharded
stencil over a Z-sharded TSDF volume need one-voxel (or wider) ghost slabs
from the neighboring shards. This is the SURVEY.md §7.6 halo-exchange
primitive: a `shard_map` whose body sends boundary slabs to the left/right
neighbor with `jax.lax.ppermute` (XLA hands these to NCCL on GPUs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def halo_exchange_z(volume: jnp.ndarray, mesh: Mesh, halo: int = 1,
                    axis_name: str = "z") -> jnp.ndarray:
    """Exchange halos along the sharded Z axis.

    Args:
      volume: (Z, ...) array whose axis 0 is sharded over `axis_name`.
      halo: ghost width in voxels.

    Returns a (Z + 2*halo*n_shards ... no —) per-shard augmented array of
    global shape (Z + 2*halo*num_shards, ...) where each local shard gained
    `halo` ghost slabs on each side (edge-clamped at the global boundary).
    Use `crop_halo_z` to drop them after the stencil.
    """
    n = mesh.shape[axis_name]

    def body(local):
        idx = jax.lax.axis_index(axis_name)
        top = local[:halo]       # first slabs -> left neighbor's bottom ghost
        bot = local[-halo:]      # last slabs  -> right neighbor's top ghost

        # receive from the left: their bottom slabs
        from_left = jax.lax.ppermute(
            bot, axis_name, [(i, (i + 1) % n) for i in range(n)]
        )
        # receive from the right: their top slabs
        from_right = jax.lax.ppermute(
            top, axis_name, [(i, (i - 1) % n) for i in range(n)]
        )
        # global edges: clamp (replicate own edge slab) instead of wrapping
        from_left = jnp.where(idx == 0, local[:halo], from_left)
        from_right = jnp.where(idx == n - 1, local[-halo:], from_right)
        return jnp.concatenate([from_left, local, from_right], axis=0)

    spec = P(axis_name)
    return shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(volume)


def crop_halo_z(volume_with_halo: jnp.ndarray, mesh: Mesh, halo: int = 1,
                axis_name: str = "z") -> jnp.ndarray:
    """Drop the ghost slabs added by halo_exchange_z."""
    def body(local):
        return local[halo:-halo]

    spec = P(axis_name)
    return shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(volume_with_halo)
