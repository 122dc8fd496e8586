from .render import (
    save_image,
    load_image,
    colorize_depth,
    colorize_normals,
    sensor_map_gallery,
    tsdf_slice_image,
)
from .stereo import (
    StereoCamera,
    compose_anaglyph,
    compose_side_by_side,
    make_stereo_renderer,
)
from .navigation import OrbitNavigator

__all__ = [
    "save_image",
    "load_image",
    "colorize_depth",
    "colorize_normals",
    "sensor_map_gallery",
    "tsdf_slice_image",
    "StereoCamera",
    "compose_anaglyph",
    "compose_side_by_side",
    "make_stereo_renderer",
    "OrbitNavigator",
]
