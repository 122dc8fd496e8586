"""Frame containers — the wire-format-equivalent of one synchronized
multi-sensor capture.

Mirrors the reference's per-frame payload (NetKinectArray.cpp:511-542: one
ZMQ message = timestamp + N x [color, depth]) as a pytree of stacked device
arrays. Color is float32 in [0,1] (the reference uploads RGB8/DXT textures;
GLSL reads them as normalized floats), depth is float32 meters.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import pytree


@pytree.dataclass
class FrameSet:
    """One synchronized frame from N sensors."""

    colors: jnp.ndarray   # (N, Hc, Wc, 3) float32 [0,1]
    depths: jnp.ndarray   # (N, H, W) float32 meters
    timestamp: jnp.ndarray  # () float64/float32 seconds

    @property
    def num_sensors(self) -> int:
        return self.colors.shape[0]

    @property
    def depth_size(self):
        return self.depths.shape[1:3]

    @property
    def color_size(self):
        return self.colors.shape[1:3]
