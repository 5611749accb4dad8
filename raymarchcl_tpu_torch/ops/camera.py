"""Camera: look-at ray generation and the turntable eye position.

Counterpart of `raymarchcl_tpu/ops/camera.py` (reference:
renderer.cl:456-465 cameraRayLookat, core.clj:150-152 compute-eyepos).
Reference quirk kept: `fov` is a LINEAR view-plane scale (no tan()), and
viewCoord.y is flipped and scaled by invAspect.
"""

from __future__ import annotations

import math

import numpy as np

from .vecmath import V3, cross, fma, normalize


def camera_ray_lookat(opts, state):
    """Per-pixel primary rays from sampling.init_render_state's state.
    Returns (pos: V3, dir: V3)."""
    eye = state["eye_pos"]
    t, u = opts.targetPos, opts.up
    forward = normalize(V3(t[0] - eye.x, t[1] - eye.y, t[2] - eye.z))
    right = normalize(cross(forward, V3(u[0], u[1], u[2])))
    vcx, vcy = view_coords(opts, state)
    upv = cross(right, forward)
    rdir = normalize(right * vcx + upv * vcy + forward)
    return eye, rdir


def view_coords(opts, state):
    """The view-plane coordinates of the jittered pixel, (px / w * fov -
    fov / 2, (py / h * fov - fov / 2) * -invAspect), in the order XLA:CPU
    compiles them in the JAX package: the division by the constant w is a
    product with its float32 reciprocal, the two scalar factors are
    multiplied first, and the difference is fused, fma(px, fov * (1/w),
    -fov/2). Bit-equal to the JAX package's on every pixel, where the
    expression as written differs in the last bit on many of them."""
    sx, sy, half = view_scales(opts)
    vcx = fma(state["px"], sx, -half)
    vcy = fma(state["py"], sy, -half) * (-opts.invAspect)
    return vcx, vcy


def view_scales(opts):
    """The frame's factors of view_coords in float32, as python floats:
    (fov * (1/w), fov * (1/h), fov * 0.5). K2 reads them from its
    parameter block."""
    f32 = np.float32
    fov = f32(opts.fov)
    w, h = opts.resolution
    return (float(fov * (f32(1.0) / f32(w))), float(fov * (f32(1.0) / f32(h))),
            float(fov * f32(0.5)))


def compute_eyepos(theta, dist, y):
    """Orbit camera position: (0, y, dist) rotated about +y by theta degrees
    (core.clj:150-152)."""
    a = math.radians(theta)
    return np.array([dist * math.sin(a), y, dist * math.cos(a)], dtype=np.float32)
