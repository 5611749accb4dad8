"""Render pipeline: spp accumulation, tonemap and ARGB pack.

Counterpart of the plain path of `raymarchcl_tpu/ops/render.py`: the
reference's progressive blend (renderer.cl:478-494, `pixels = mix(pixels,
col*exposure, frameBlend)` over `iter` sequential passes, core.clj:82-90)
and TonemapImage (renderer.cl:496-508). All passes of a frame and the pack
are one K2 launch on a CUDA device (ops/kernels/render_pass.py: K1's pack
is the epilogue of the last pass); `pack_argb` packs an accum on its own
(K1, ops/kernels/tonemap.py). On the CPU both run their plain versions.

The accumulation is the reference's exponentially-weighted blend with
frameBlend = 1/iter from a zeroed buffer, not an arithmetic mean.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import tonemap as k_tonemap
from .kernels.render_pass import render_pass, render_passes  # noqa: F401  (blend in place)
from .kernels.tonemap import tonemap  # noqa: F401  (re-export)

# Per-pass time step of the still-image path (core.clj:105) and of the
# animation's update path (core.clj:116).
TIME_STEP_INIT = 0.333
TIME_STEP_ANIM = 0.3333


def render_accum(vol, opts, mc_tables, times, accum, accel=None):
    """All spp passes in order (core.clj:83-90); pass p uses times[p] and
    mc_tables[p]. Updates accum in place and returns it."""
    return render_passes(vol, opts, mc_tables, times, accum, accel)


def pack_argb(opts, accum):
    """Tonemap + pack to 0xAARRGGBB: (N, 3) -> (N,) int32 holding the bits."""
    return k_tonemap.tonemap_pack(accum, opts.gamma)


def render_image(vol, opts, mc_tables, times=None, accum=None, accel=None):
    """End-to-end frame: spp passes + tonemap.

    vol: flat uint8 (rx*ry*rz,); mc_tables: float32 (P, T, 4) on vol's
    device; accel: the volume's brick table (ops/accel.build_accel) or None,
    the same image either way. Returns (argb (H, W) uint32 numpy, accum
    (N, 3) float32 tensor). `accum` may be passed back in to continue
    refining (core.clj:194-208).
    """
    n_passes = mc_tables.shape[0]
    if times is None:
        times = torch.arange(n_passes, dtype=torch.float32) * TIME_STEP_INIT
    if accum is None:
        accum = torch.zeros((opts.num_pixels, 3), dtype=torch.float32, device=vol.device)
    argb = torch.empty(opts.num_pixels, dtype=torch.int32, device=accum.device)
    render_passes(vol, opts, mc_tables, times, accum, accel, argb)
    w, h = opts.resolution
    return argb.cpu().numpy().view(np.uint32).reshape(h, w), accum
