"""Core layer tests: grids, bricks, config parsing, synthetic scenes."""

import numpy as np

from rgbd_recon.core.config import PipelineConfig, format_conf, parse_conf, parse_ks
from rgbd_recon.core.grid import BoundingBox, BrickGrid, VolumeGrid
from rgbd_recon.sensors.synthetic import (
    SyntheticScene,
    default_test_rig,
    render_rig_frames,
)

BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))


def test_volume_grid_resolution():
    # reference default: 2 x 2.2 x 2 m at 1 cm -> 200 x 220 x 200 (~8.8M)
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.01)
    assert grid.res == (200, 220, 200)
    assert grid.shape == (200, 220, 200)
    assert grid.num_voxels == 200 * 220 * 200


def test_voxel_centers():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.5)
    c = grid.voxel_centers_normalized()
    assert c.shape == grid.shape + (3,)
    # first center at half voxel
    np.testing.assert_allclose(c[0, 0, 0], [0.5 / grid.res[0], 0.5 / grid.res[1], 0.5 / grid.res[2]])


def test_brick_grid():
    bricks = BrickGrid(bbox=BBOX, brick_size=0.1)
    assert bricks.res == (20, 22, 20)
    idx = bricks.brick_index_of(np.array([[-1.0, 0.0, -1.0], [0.999, 2.199, 0.999]]))
    np.testing.assert_array_equal(idx[0], [0, 0, 0])
    np.testing.assert_array_equal(idx[1], [19, 21, 19])


def test_voxel_to_brick_map():
    grid = VolumeGrid(bbox=BBOX, voxel_size=0.1)
    bricks = BrickGrid(bbox=BBOX, brick_size=0.5)
    m = bricks.voxel_to_brick_map(grid)
    assert m.shape == grid.shape
    assert m.min() >= 0 and m.max() < bricks.num_bricks
    # voxel 0 is in brick 0; last voxel in last brick
    assert m[0, 0, 0] == 0
    assert m[-1, -1, -1] == bricks.num_bricks - 1


def test_parse_conf_types():
    conf = parse_conf(
        """
        # comment
        recon_mode: 1
        voxel_size: 0.01
        bilateral: true
        processed: false
        kinect_list: 1,2,3
        """
    )
    assert conf["recon_mode"] == 1
    assert abs(conf["voxel_size"] - 0.01) < 1e-9
    assert conf["bilateral"] is True
    assert conf["processed"] is False
    assert conf["kinect_list"] == [1, 2, 3]


def test_pipeline_config_roundtrip():
    cfg = PipelineConfig(voxel_size=0.02, bricking=False, recon_mode=2)
    text = format_conf(cfg)
    cfg2 = PipelineConfig.from_conf(parse_conf(text))
    assert cfg2.voxel_size == cfg.voxel_size
    assert cfg2.bricking == cfg.bricking
    assert cfg2.recon_mode == cfg.recon_mode


def test_parse_ks():
    scene = parse_ks(
        """kinect 23.yml
kinect 24.yml
bbx -1.2 0.0 -1.2 1.2 2.4 1.2
"""
    )
    assert scene.calib_files == ["23.yml", "24.yml"]
    assert scene.bbox.min == (-1.2, 0.0, -1.2)
    assert scene.bbox.max == (1.2, 2.4, 1.2)


def test_synthetic_scene_sdf():
    scene = SyntheticScene(spheres=[((0.0, 1.0, 0.0), 0.5)])
    assert scene.sdf(np.array([0.0, 1.0, 0.0])) < 0
    np.testing.assert_allclose(scene.sdf(np.array([0.0, 2.0, 0.0])), 0.5, atol=1e-6)


def test_synthetic_render_depth_accuracy():
    """Raycast depth must satisfy: unprojecting (u,v,depth) lands on the
    SDF zero set."""
    scene = SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.4)])
    rig = default_test_rig(num_sensors=2, bbox=BBOX)
    frames = render_rig_frames(scene, rig)
    assert frames.num_sensors == 2
    d = np.asarray(frames.depths[0])
    hit = d > 0
    assert hit.sum() > 20  # sphere visible
    cam = rig.sensors[0].depth
    H, W = d.shape
    jj, ii = np.nonzero(hit)
    uv = np.stack([(ii + 0.5) / W, (jj + 0.5) / H], axis=-1).astype(np.float32)
    world = cam.unproject(uv, d[jj, ii])
    sd = scene.sdf(world)
    assert np.abs(sd).max() < 5e-3


def test_pytree_dataclass_leaves_round_trip():
    """core.pytree.dataclass: array fields are leaves that flatten and
    unflatten unchanged; replace() returns a new frozen instance."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from rgbd_recon.core import pytree

    @pytree.dataclass
    class Pair:
        a: jnp.ndarray
        b: jnp.ndarray = None

    p = Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_array_equal(np.asarray(q.a), np.asarray(p.a))
    np.testing.assert_array_equal(np.asarray(q.b), np.asarray(p.b))
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(np.asarray(doubled.b), 2.0)
    r = p.replace(b=None)
    assert r.b is None and p.b is not None
    assert len(jax.tree_util.tree_leaves(r)) == 1
    try:
        p.a = jnp.zeros(3)
    except dataclasses.FrozenInstanceError:
        pass
    else:
        raise AssertionError("pytree dataclasses must be frozen")


def test_pytree_dataclass_static_fields_stay_static():
    """static_field values are treedef metadata: a jitted function sees
    them as Python values, and a new value retraces instead of being
    traced."""
    import jax
    import jax.numpy as jnp

    from rgbd_recon.core import pytree

    @pytree.dataclass
    class Scaled:
        x: jnp.ndarray
        scale: int = pytree.static_field(default=2)

    traces = []

    @jax.jit
    def f(s):
        traces.append(s.scale)
        assert isinstance(s.scale, int)  # not a tracer
        return s.x * s.scale

    assert len(jax.tree_util.tree_leaves(Scaled(jnp.ones(2), 3))) == 1
    np.testing.assert_allclose(np.asarray(f(Scaled(jnp.ones(2), 3))), 3.0)
    f(Scaled(jnp.zeros(2), 3))
    assert traces == [3]
    np.testing.assert_allclose(np.asarray(f(Scaled(jnp.ones(2), 5))), 5.0)
    assert traces == [3, 5]


def _with_cache_config(fn):
    import jax

    keep = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", keep)


def test_compile_cache_honors_env_var(tmp_path, monkeypatch):
    import jax

    from rgbd_recon.core.cache import enable_compile_cache

    target = tmp_path / "xla_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))

    def run():
        used = enable_compile_cache()
        assert used == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()

    _with_cache_config(run)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import os

    import jax

    import rgbd_recon
    from rgbd_recon.core.cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(
        os.path.abspath(rgbd_recon.__file__)))

    def run():
        used = enable_compile_cache()
        assert used == os.path.join(checkout, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == used

    _with_cache_config(run)
