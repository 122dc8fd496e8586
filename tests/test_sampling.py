"""GL-parity tests for the sampling primitives against tiny NumPy oracles."""

import jax.numpy as jnp
import numpy as np

from rgbd_recon.ops.sampling import bilinear_2d, nearest_2d, trilinear_3d


def _oracle_trilinear(vol, p):
    """Scalar NumPy oracle implementing GL LINEAR + clamp-to-edge."""
    D, H, W, C = vol.shape
    x = p[0] * W - 0.5
    y = p[1] * H - 0.5
    z = p[2] * D - 0.5
    x0, y0, z0 = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
    fx, fy, fz = x - x0, y - y0, z - z0

    def at(zz, yy, xx):
        return vol[
            np.clip(zz, 0, D - 1), np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)
        ]

    out = np.zeros(C, np.float64)
    for dz, wz in ((0, 1 - fz), (1, fz)):
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                out += wz * wy * wx * at(z0 + dz, y0 + dy, x0 + dx)
    return out


def test_trilinear_matches_oracle(rng):
    vol = rng.standard_normal((5, 7, 6, 3)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, size=(50, 3)).astype(np.float32)
    got = np.asarray(trilinear_3d(jnp.asarray(vol), jnp.asarray(pts)))
    want = np.stack([_oracle_trilinear(vol, p) for p in pts])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_trilinear_texel_centers_exact(rng):
    """Sampling exactly at texel centers returns the stored value."""
    vol = rng.standard_normal((4, 4, 4, 2)).astype(np.float32)
    coords = []
    vals = []
    for z in range(4):
        for y in range(4):
            for x in range(4):
                coords.append([(x + 0.5) / 4, (y + 0.5) / 4, (z + 0.5) / 4])
                vals.append(vol[z, y, x])
    got = np.asarray(trilinear_3d(jnp.asarray(vol), jnp.asarray(coords, np.float32)))
    np.testing.assert_allclose(got, np.stack(vals), rtol=1e-5, atol=1e-6)


def test_trilinear_batch_shapes(rng):
    vol = rng.standard_normal((3, 4, 5, 1)).astype(np.float32)
    pts = rng.uniform(0, 1, size=(2, 6, 7, 3)).astype(np.float32)
    out = trilinear_3d(jnp.asarray(vol), jnp.asarray(pts))
    assert out.shape == (2, 6, 7, 1)


def test_bilinear_matches_trilinear_slice(rng):
    """A 2D bilinear lookup equals a 3D lookup on a single-slice volume at
    the central depth coordinate."""
    img = rng.standard_normal((6, 8, 3)).astype(np.float32)
    pts2 = rng.uniform(0, 1, size=(30, 2)).astype(np.float32)
    vol = img[None]
    pts3 = np.concatenate([pts2, np.full((30, 1), 0.5, np.float32)], axis=-1)
    got2 = np.asarray(bilinear_2d(jnp.asarray(img), jnp.asarray(pts2)))
    got3 = np.asarray(trilinear_3d(jnp.asarray(vol), jnp.asarray(pts3)))
    np.testing.assert_allclose(got2, got3, rtol=1e-5, atol=1e-6)


def test_nearest(rng):
    img = rng.standard_normal((4, 4, 1)).astype(np.float32)
    got = np.asarray(
        nearest_2d(jnp.asarray(img), jnp.asarray([[0.26, 0.74]], np.float32))
    )
    np.testing.assert_allclose(got[0, 0], img[2, 1, 0])


def test_clamp_to_edge(rng):
    vol = rng.standard_normal((3, 3, 3, 1)).astype(np.float32)
    got = np.asarray(
        trilinear_3d(jnp.asarray(vol), jnp.asarray([[-0.5, -0.5, -0.5]], np.float32))
    )
    np.testing.assert_allclose(got[0, 0], vol[0, 0, 0, 0], rtol=1e-5)
