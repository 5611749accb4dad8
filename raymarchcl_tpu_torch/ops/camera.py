"""Camera: look-at ray generation and the turntable eye position.

Counterpart of `raymarchcl_tpu/ops/camera.py` (reference:
renderer.cl:456-465 cameraRayLookat, core.clj:150-152 compute-eyepos).
Reference quirk kept: `fov` is a LINEAR view-plane scale (no tan()), and
viewCoord.y is flipped and scaled by invAspect.
"""

from __future__ import annotations

import math

import numpy as np

from .vecmath import V3, cross, normalize


def camera_ray_lookat(opts, state):
    """Per-pixel primary rays from sampling.init_render_state's state.
    Returns (pos: V3, dir: V3)."""
    eye = state["eye_pos"]
    t, u = opts.targetPos, opts.up
    forward = normalize(V3(t[0] - eye.x, t[1] - eye.y, t[2] - eye.z))
    right = normalize(cross(forward, V3(u[0], u[1], u[2])))
    w, h = opts.resolution
    vcx = state["px"] / w * opts.fov - opts.fov * 0.5
    vcy = (state["py"] / h * opts.fov - opts.fov * 0.5) * (-opts.invAspect)
    upv = cross(right, forward)
    rdir = normalize(right * vcx + upv * vcy + forward)
    return eye, rdir


def compute_eyepos(theta, dist, y):
    """Orbit camera position: (0, y, dist) rotated about +y by theta degrees
    (core.clj:150-152)."""
    a = math.radians(theta)
    return np.array([dist * math.sin(a), y, dist * math.cos(a)], dtype=np.float32)
