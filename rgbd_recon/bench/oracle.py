"""Analytic-sphere surface oracle for rendered frames.

The benchmark scene is one sphere, so every hit pixel's true ray-surface
distance has a closed form. ``sphere_surface_rmse_mm`` inverts the render's
window depth back to a distance along the ray and reports the RMSE against
the analytic surface (BASELINE.md "tight geometric error parity").
"""

from __future__ import annotations

import numpy as np


def sphere_surface_rmse_mm(render_out, camera, center, radius):
    """(RMSE in mm, pixel count) of hit depth against a sphere.

    ``render_out`` is a RenderOutput, ``camera`` the ViewCamera it was
    rendered with."""
    hit = np.asarray(render_out.hit)
    depth_win = np.asarray(render_out.depth)
    n, f = camera.near, camera.far
    # invert the window-depth mapping to view z
    view_z = 1.0 / (1.0 / n - depth_win * (1.0 / n - 1.0 / f))
    dirs = camera.ray_directions_world()       # (H, W, 3), view z = -1
    eye = np.asarray(camera.eye, np.float32)
    oc = eye - np.asarray(center, np.float32)
    b = np.sum(dirs * oc, axis=-1)
    a = np.sum(dirs * dirs, axis=-1)
    disc = b * b - a * (np.dot(oc, oc) - radius**2)
    ok = hit & (disc > 0.0)
    t_true = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    # dirs has unit view-z component, so the ray parameter equals view z
    err = (view_z - t_true)[ok] * np.linalg.norm(dirs[ok], axis=-1)
    err = err[np.isfinite(err)]
    return float(np.sqrt(np.mean(err**2)) * 1000.0), int(ok.sum())
