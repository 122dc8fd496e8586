"""Offline visualization — the GUI texture viewer's equivalents.

The reference shows every intermediate map in ImGui windows
(kinect_client.cpp:486-518) and visualizes the TSDF volume as colored voxel
points (ReconCalibs, framework/reconstruction/recon_calibs.cpp). Headless
equivalents: PNG dumps of sensor maps, normal/depth colorizations, and TSDF
slice images with the same sign-coloring convention as calib_vis.fs
(red outside / green inside / blue at +limit).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_image(path, array) -> None:
    """Save a float [0,1] (H,W,3|1) or uint8 array as an 8-bit RGB PNG
    (standard library only: zlib + struct)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    H, W = a.shape[:2]
    # filter type 0 (None) on every scanline
    raw = np.concatenate(
        [np.zeros((H, 1), np.uint8), a.reshape(H, W * 3)], axis=1
    ).tobytes()
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def load_image(path) -> np.ndarray:
    """Read back a PNG written by :func:`save_image` -> (H, W, 3) uint8.
    Not a general decoder: 8-bit RGB, unfiltered scanlines only."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    W, H, depth, ctype, _, _, interlace = hdr
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + 3 * W)
    if (depth, ctype, interlace) != (8, 2, 0) or rows[:, 0].any():
        raise ValueError(f"{path}: not an unfiltered 8-bit RGB PNG")
    return rows[:, 1:].reshape(H, W, 3).copy()


def colorize_depth(depth, lo=None, hi=None) -> np.ndarray:
    """Normalized grayscale of a depth map; invalid (<=0) shown red."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if lo is None:
        lo = d[valid].min() if valid.any() else 0.0
    if hi is None:
        hi = d[valid].max() if valid.any() else 1.0
    g = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    img = np.stack([g, g, g], axis=-1)
    img[~valid] = [0.6, 0.1, 0.1]
    return img


def colorize_normals(normals) -> np.ndarray:
    """World normals -> RGB in [0,1] (the standard n*0.5+0.5 view)."""
    return np.asarray(normals) * 0.5 + 0.5


def sensor_map_gallery(maps, out_dir, sensor: int = 0) -> list:
    """Dump one sensor's full map set (the texture-viewer set:
    color, lab, processed depth, quality, normal, silhouette)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []

    def w(name, img):
        p = out / f"sensor{sensor}_{name}.png"
        save_image(p, img)
        written.append(p)

    w("color", np.asarray(maps.color[sensor]))
    lab = np.asarray(maps.lab[sensor])
    w("lab", (lab - lab.min()) / max(lab.max() - lab.min(), 1e-9))
    w("depth", colorize_depth(np.asarray(maps.depth[sensor][..., 0])))
    q = np.asarray(maps.quality[sensor])
    w("quality", q / max(q.max(), 1e-9))
    w("normal", colorize_normals(np.asarray(maps.normal[sensor])))
    w("silhouette", np.asarray(maps.silhouette[sensor]))
    return written


def tsdf_slice_image(volume, axis: int = 0, index: int = None, limit: float = 0.01):
    """Color a TSDF slice like calib_vis.fs: red where carved/outside
    (-limit), blue where empty (+limit), green band near the surface."""
    v = np.asarray(volume)
    if index is None:
        index = v.shape[axis] // 2
    sl = np.take(v, index, axis=axis)
    img = np.zeros(sl.shape + (3,), np.float32)
    t = np.clip(sl / limit, -1.0, 1.0)
    img[..., 0] = np.clip(-t, 0, 1)          # inside/carved -> red
    img[..., 2] = np.clip(t, 0, 1)           # far outside -> blue
    img[..., 1] = np.clip(1.0 - np.abs(t), 0, 1)  # surface band -> green
    return img
