"""User-facing entry points, kwarg-compatible with the JAX package's api.

`test_render` mirrors `(rm/test-render :width .. :iter .. :mat ..)`
(reference: core.clj:154-179); `test_anim` mirrors `(rm/test-anim w h iter
res mat & vname)` (core.clj:181-213), including the accumulation buffer
that persists across frames (temporal blending) and the 0.3333 per-pass
time step of the animation's update path (core.clj:116 vs :105). Every
entry point takes the torch `device` to render on, the CUDA card unless
the caller asks for "cpu"; tensors of the frame live there. The volume's
own resolution always wins over a separately passed vres.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np
import torch

from .convert import volume_on
from .io import imageio, voxio
from .models import generators
from .ops import render as render_mod
from .ops.accel import build_accel
from .ops.camera import compute_eyepos
from .ops.sampling import make_mc_tables
from .options import render_options
from .runtime import check_device

VOLUME_CACHE_DIR = os.environ.get(
    "RAYMARCHCL_TPU_VOLUME_DIR", os.path.join(os.path.dirname(__file__), "..", "volumes")
)


def default_volume(vres, kind="gyroid", cache=True):
    """Procedural volume -> (flat uint8 numpy array, (rx, ry, rz)), cached
    on disk as `.vox` (stands in for the reference's gyroid .vox,
    core.clj:146)."""
    if isinstance(vres, (int, np.integer)):
        vres = (int(vres),) * 3
    rx, ry, rz = vres
    path = os.path.join(VOLUME_CACHE_DIR, f"{kind}-{rx}x{ry}x{rz}.vox")
    if cache and os.path.isfile(path):
        return voxio.load_volume(path)
    gen = {"gyroid": generators.make_gyroid_volume,
           "terrain": generators.make_terrain}[kind]
    vox = gen({"vres": list(vres)})
    if cache:
        os.makedirs(VOLUME_CACHE_DIR, exist_ok=True)
        voxio.save_volume(path, vres, vox)
    return vox, tuple(vres)


def load_or_generate_volume(vname, vres, kind="gyroid"):
    """The `.vox` file `vname`, or the procedural volume at `vres`:
    (flat uint8 numpy array, (rx, ry, rz))."""
    if vname:
        return voxio.load_volume(vname)
    return default_volume(vres, kind=kind)


def build_accel_for(volume, opts):
    """The volume's brick table (ops/accel.py), for dense-shell volumes
    (gyroid) and sparse mesh volumes alike; the rows land on the volume
    tensor's device (the CPU for a numpy volume). The image is the same
    with or without it."""
    return build_accel(volume, opts.voxelRes, opts.isoVal)


def render_frame(volume, vres, *, iter=1, seed=0, times=None, accum=None, accel=True,
                 device="cuda", **opt_kwargs):
    """Render a frame from an explicit volume (numpy or tensor) on `device`.

    accel=True builds the brick table (ops/accel.py) and marches over it;
    the image is the same either way. Returns (argb (H, W) uint32 numpy,
    accum (N, 3) tensor on device)."""
    device = check_device(device)
    opts = render_options(vres=list(vres), iter=iter, **opt_kwargs)
    mc_tables = make_mc_tables(iter, seed=seed, device=device)
    vol = volume_on(volume, device)
    acc = build_accel_for(vol, opts) if accel else None
    return render_mod.render_image(vol, opts, mc_tables, times=times, accum=accum,
                                   accel=acc)


# Reduced march budgets for interactive iteration (the reference's workflow
# is REPL-driven look development, README.org:26-38): quarter budgets of
# the reference defaults (core.clj:54-61), rendered by the same engine. A
# preview is a legitimate render of a cheaper configuration.
PREVIEW_BUDGETS = dict(maxIter=32, maxVoxelIter=48, shadowIter=32, aoIter=2)


def preview_overrides(opt_kwargs, iter=1):
    """PREVIEW_BUDGETS under any explicit user overrides, and the spp (at
    least 1)."""
    merged = dict(PREVIEW_BUDGETS)
    merged.update(opt_kwargs)
    return merged, max(1, iter)


def test_render(width=640, height=360, iter=1, vres=256, mat="metal", vname=None,
                out_path="foo.png", theta=135, dist=2.25, seed=0, verbose=True,
                preview=False, device="cuda", accel=True, **opt_kwargs):
    """Still-image entry point (reference: core.clj:154-179 incl. defaults:
    the `metal` preset with its 3 reflection bounces). preview=True renders
    with PREVIEW_BUDGETS."""
    check_device(device)
    if preview:
        opt_kwargs, iter = preview_overrides(opt_kwargs, iter)
    volume, actual_vres = load_or_generate_volume(vname, vres)
    t0 = _time.perf_counter()
    argb, _ = render_frame(
        volume, actual_vres, iter=iter, seed=seed, device=device, accel=accel,
        width=width, height=height, mat=mat,
        eyepos=compute_eyepos(theta, dist, 0.35),  # core.clj:165
        targetpos=[0, -0.4, 0],  # core.clj:166
        **opt_kwargs,
    )
    dt = _time.perf_counter() - t0
    if verbose:
        print(f"rendered {width}x{height} @ {iter} spp in {dt:.3f}s")
    if out_path:
        imageio.save_png(argb, out_path)
    return argb


def test_anim(width, height, iter, res, mat, vname=None, out_dir="export", frames=35,
              seed=0, verbose=True, device="cuda"):
    """Turntable of `frames` frames (reference: core.clj:181-213): camera
    path theta 0->350, y 0.44->0.45, fov 115, target y -0.15. The MC tables
    and the brick table are built once; the accumulation buffer is
    deliberately NOT cleared between frames (temporal blending,
    core.clj:194-208). Writes out_dir/frame-NNNN.png and returns the
    paths."""
    device = check_device(device)
    volume, actual_vres = load_or_generate_volume(vname, (res, res, res))
    os.makedirs(out_dir, exist_ok=True)
    mc_tables = make_mc_tables(iter, seed=seed, device=device)
    vol = volume_on(volume, device)
    times = torch.arange(iter, dtype=torch.float32) * render_mod.TIME_STEP_ANIM
    accum = acc = None
    paths = []
    for frame in range(frames):
        t0 = _time.perf_counter()
        t = frame / frames  # map-interval frame 0 35 -> [0, 34/35)
        opts = render_options(
            width=width, height=height, vres=list(actual_vres), iter=iter, mat=mat,
            fov=115.0, targetpos=[0, -0.15, 0],
            eyepos=compute_eyepos(t * 350.0, 2.25, 0.44 + t * (0.45 - 0.44)),
        )
        if accum is None:
            accum = torch.zeros((opts.num_pixels, 3), dtype=torch.float32, device=device)
            acc = build_accel_for(vol, opts)
        argb, accum = render_mod.render_image(vol, opts, mc_tables, times, accum, accel=acc)
        out = os.path.join(out_dir, f"frame-{frame:04d}.png")
        imageio.save_png(argb, out)
        paths.append(out)
        if verbose:
            print(f"rendered frame #{frame} in {_time.perf_counter() - t0:.4f}s")
    return paths
