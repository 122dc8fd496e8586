"""Stereo output modes — mono / anaglyph / side-by-side.

Replicates the reference's three display modes (source/kinect_client.cpp
draw3d :612-673):

  mono          one eye at the cyclops position
  anaglyph      two passes with glColorMask(R / GB) and eyes separated by
                +-eyesep/2 (kinect_client.cpp:626-649; the color mask is the
                Reconstruction base class's setColorMaskMode,
                framework/reconstruction/reconstruction.cpp)
  side-by-side  two viewports, screen/cyclops matrices from the feedback
                channel (kinect_client.cpp:651-673, gloost::StereoCamera)

This module renders the scene twice with laterally displaced eye
positions and composes channels/viewports on device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..ops.raymarch import ViewCamera

# reference default eye separation (gloost StereoCamera usage in
# kinect_client.cpp:631,636: +-0.0325 -> 6.5 cm interocular)
DEFAULT_EYE_SEPARATION = 0.065


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Cyclops camera + eye separation (gloost::StereoCamera equivalent)."""

    cyclops: ViewCamera
    eye_separation: float = DEFAULT_EYE_SEPARATION

    def eye_camera(self, side: float) -> ViewCamera:
        """side = -1 left, +1 right: displace the eye along the camera's
        right axis by side * eyesep / 2, keeping the look target."""
        rot = self.cyclops.rotation()
        right = rot[:, 0]
        off = right * (side * self.eye_separation * 0.5)
        eye = np.asarray(self.cyclops.eye, np.float32) + off
        tgt = np.asarray(self.cyclops.target, np.float32) + off
        return dataclasses.replace(
            self.cyclops, eye=tuple(eye.tolist()), target=tuple(tgt.tolist())
        )

    @property
    def left(self) -> ViewCamera:
        return self.eye_camera(-1.0)

    @property
    def right(self) -> ViewCamera:
        return self.eye_camera(+1.0)


def compose_anaglyph(left_rgb: jnp.ndarray, right_rgb: jnp.ndarray) -> jnp.ndarray:
    """Red channel from the left eye, green+blue from the right — exactly
    the reference's two glColorMask passes (kinect_client.cpp:626-649:
    mask mode 1 = red for the left eye, mode 2 = cyan for the right)."""
    return jnp.concatenate([left_rgb[..., :1], right_rgb[..., 1:3]], axis=-1)


def compose_side_by_side(left_rgb: jnp.ndarray, right_rgb: jnp.ndarray) -> jnp.ndarray:
    """Left|right viewport split (kinect_client.cpp:651-673)."""
    return jnp.concatenate([left_rgb, right_rgb], axis=1)


def make_stereo_renderer(
    make_renderer: Callable[[ViewCamera], Callable],
    camera: StereoCamera,
    mode: str = "anaglyph",
):
    """Wrap a per-camera renderer factory into a stereo renderer.

    Args:
      make_renderer: camera -> render(*state) -> RenderOutput (or a tuple
        whose first element is the image) — e.g. TsdfPipeline.make_renderer.
      mode: 'mono' | 'anaglyph' | 'side-by-side'.

    Returns render(*state) -> (H, W or 2W, 3) image.
    """
    if mode == "mono":
        render = make_renderer(camera.cyclops)

        def mono(*state):
            return _image_of(render(*state))

        return mono

    render_l = make_renderer(camera.left)
    render_r = make_renderer(camera.right)
    compose = compose_anaglyph if mode == "anaglyph" else compose_side_by_side
    if mode not in ("anaglyph", "side-by-side"):
        raise ValueError(f"unknown stereo mode {mode!r}")

    def stereo(*state):
        return compose(_image_of(render_l(*state)), _image_of(render_r(*state)))

    return stereo


def _image_of(out) -> jnp.ndarray:
    if hasattr(out, "color"):
        return out.color
    if isinstance(out, tuple):
        return out[0]
    return out
