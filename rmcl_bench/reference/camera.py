"""Look-at primary rays (renderer.cl:456-465): `fov` is a linear
view-plane scale, viewCoord.y flipped and scaled by invAspect; the view
coordinate is fma(px, fov * (1/w), -fov/2)."""

from __future__ import annotations

import numpy as np

from .vecmath import V3, cross, fma, normalize


def view_scales(opts):
    f32 = np.float32
    fov = f32(opts.fov)
    w, h = opts.resolution
    return (float(fov * (f32(1.0) / f32(w))), float(fov * (f32(1.0) / f32(h))),
            float(fov * f32(0.5)))


def camera_ray_lookat(opts, state):
    eye = state["eye_pos"]
    t, u = opts.targetPos, opts.up
    forward = normalize(V3(t[0] - eye.x, t[1] - eye.y, t[2] - eye.z))
    right = normalize(cross(forward, V3(u[0], u[1], u[2])))
    sx, sy, half = view_scales(opts)
    vcx = fma(state["px"], sx, -half)
    vcy = fma(state["py"], sy, -half) * (-opts.invAspect)
    upv = cross(right, forward)
    return eye, normalize(right * vcx + upv * vcy + forward)
