"""User-facing entry points, kwarg-compatible with the JAX package's api.

`test_render` mirrors `(rm/test-render :width .. :iter .. :mat ..)`
(reference: core.clj:154-179). Every entry point takes the torch `device`
to render on, the CUDA card unless the caller asks for "cpu"; tensors of
the frame live there. The volume's own resolution always wins over a
separately passed vres.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np
import torch

from .convert import volume_from_numpy
from .io import imageio, voxio
from .models import generators
from .ops import render as render_mod
from .ops.accel import build_accel
from .ops.camera import compute_eyepos
from .ops.sampling import make_mc_tables
from .options import render_options

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


def _check_device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to render on the CPU")
    return dev


def render_frame(volume, vres, *, iter=1, seed=0, times=None, accum=None, accel=True,
                 device="cuda", **opt_kwargs):
    """Render a frame from an explicit volume (numpy or tensor) on `device`.

    accel=True builds the brick table (ops/accel.py) and marches over it;
    the image is the same either way. Returns (argb (H, W) uint32 numpy,
    accum (N, 3) tensor on device)."""
    device = _check_device(device)
    opts = render_options(vres=list(vres), iter=iter, **opt_kwargs)
    mc_tables = make_mc_tables(iter, seed=seed, device=device)
    if isinstance(volume, torch.Tensor):
        vol = volume.to(device=device, dtype=torch.uint8).reshape(-1)
    else:
        vol = volume_from_numpy(volume, device)
    acc = build_accel(vol, opts.voxelRes, opts.isoVal) if accel else None
    return render_mod.render_image(vol, opts, mc_tables, times=times, accum=accum,
                                   accel=acc)


def test_render(width=640, height=360, iter=1, vres=256, mat="metal", vname=None,
                out_path="foo.png", theta=135, dist=2.25, seed=0, verbose=True,
                device="cuda", accel=True, **opt_kwargs):
    """Still-image entry point (reference: core.clj:154-179 incl. defaults:
    the `metal` preset with its 3 reflection bounces)."""
    _check_device(device)
    if vname:
        volume, actual_vres = voxio.load_volume(vname)
    else:
        volume, actual_vres = default_volume(vres)
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
