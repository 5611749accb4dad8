"""K2: one spp pass of the renderer, blended into accum
(reference: RenderImage, renderer.cl:478-494).

On the TPU this pass is jnp code lowered by XLA (`raymarchcl_tpu/ops`:
sampling, camera, march, shade and render.render_pass); there is no Pallas
source. On the H100 it is one hand-written CUDA kernel with one thread per
pixel, csrc/render_pass.cu, which notes what bounds it. Its plain version is
`render_pass_plain`, built from this package's ops modules. Both march over
the brick table (ops/accel.py) when one is given, with the same result as
without it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel import Accel, brick_dims, row_words
from ..camera import camera_ray_lookat
from ..sampling import init_render_state
from ..shade import REFLECTIONS_NOT_PORTED, ao_step_dist, ao_trunc_steps, scene_color
from ..vecmath import fma
from . import build

LAUNCHES = 0  # kernel launches by render_pass (plain-version calls excluded)

MAX_AO_PROBES = 16
MAX_LIGHTS = 4

_f, _i = ctypes.c_float, ctypes.c_int


class RmclParams(ctypes.Structure):
    """Mirror of `struct RmclParams` in csrc/rmcl_common.cuh."""

    _fields_ = [
        ("width", _i), ("height", _i),
        ("rx", _i), ("ry", _i), ("rz", _i), ("rxy", _i),
        ("maxIter", _i), ("maxVoxelIter", _i), ("shadowIter", _i), ("aoIter", _i),
        ("numLights", _i), ("isoVal", _i),
        ("edge", _i), ("brickShift", _i), ("nbx", _i), ("nby", _i), ("rowWords", _i),
        ("aoSteps", _i), ("aoTrunc", _i * MAX_AO_PROBES), ("aoD", _f * MAX_AO_PROBES),
        ("marchScale", _f), ("aoScale", _f), ("shadowBaseStep", _f),
        ("invNumLights", _f), ("voxelSize", _f),
        ("bmin", _f * 3), ("bmax", _f * 3), ("vb", _f * 3), ("vb2", _f * 3),
        ("invS", _f * 3),
        ("eyePos", _f * 3), ("targetPos", _f * 3), ("up", _f * 3),
        ("sky1", _f * 3), ("sky2", _f * 3),
        ("invAspect", _f), ("time", _f), ("fov", _f), ("maxDist", _f),
        ("startDist", _f), ("eps", _f), ("aoAmp", _f), ("groundY", _f),
        ("shadowBias", _f), ("lightScatter", _f), ("minLightAtt", _f),
        ("exposure", _f), ("dof", _f), ("frameBlend", _f), ("fogPow", _f),
        ("flareAmp", _f),
        ("lightPos", (_f * 4) * 4), ("lightColor", (_f * 4) * 4),
        ("matAlbedo", (_f * 4) * 4), ("matR0", _f * 4), ("matSmooth", _f * 4),
    ]


def make_params(opts, accel: Accel | None = None) -> RmclParams:
    """The kernel's parameter block; derived constants in float32 exactly
    as the plain version computes them. The brick fields stay 0 without a
    brick table."""
    if opts.reflectIter > 0:
        raise NotImplementedError(REFLECTIONS_NOT_PORTED)
    if not 1 <= opts.numLights <= MAX_LIGHTS:
        raise ValueError(f"numLights must be in [1, {MAX_LIGHTS}], got {opts.numLights}")
    if not 0 <= opts.aoIter < MAX_AO_PROBES:
        raise ValueError(f"aoIter must be in [0, {MAX_AO_PROBES}), got {opts.aoIter}")
    f32 = np.float32
    p = RmclParams()
    p.width, p.height = opts.resolution
    p.rx, p.ry, p.rz, p.rxy = opts.voxelRes
    for k in ("maxIter", "maxVoxelIter", "shadowIter", "aoIter", "numLights", "isoVal"):
        setattr(p, k, getattr(opts, k))
    if accel is not None:
        p.edge, p.brickShift = accel.edge, accel.edge.bit_length() - 1
        p.nbx, p.nby, _ = brick_dims(opts.voxelRes, accel.edge)
        p.rowWords = row_words(accel.edge)
    p.aoSteps = opts.maxVoxelIter // 2
    for i in range(opts.aoIter + 1):
        p.aoTrunc[i] = ao_trunc_steps(opts, p.aoSteps, i)
        p.aoD[i] = float(ao_step_dist(opts, i))
    p.marchScale = float(f32(1.0 / (opts.maxVoxelIter * 0.5)))
    p.aoScale = float(f32(1.0 / (p.aoSteps * 0.5)))
    f_min = min(a * b for a, b in zip(opts.invVoxelScale, opts.voxelBounds2))
    p.shadowBaseStep = float(f32((2.0 / opts.maxVoxelIter) * f_min))
    p.invNumLights = float(f32(1.0) / f32(opts.numLights))
    p.voxelSize = float(f32(opts.voxelSize))
    for dst, src in (("bmin", opts.voxelBoundsMin), ("bmax", opts.voxelBoundsMax),
                     ("vb", opts.voxelBounds), ("vb2", opts.voxelBounds2),
                     ("invS", opts.invVoxelScale), ("eyePos", opts.eyePos),
                     ("targetPos", opts.targetPos), ("up", opts.up),
                     ("sky1", opts.skyColor1), ("sky2", opts.skyColor2)):
        getattr(p, dst)[:] = [float(v) for v in np.asarray(src, np.float32)]
    for k in ("invAspect", "time", "fov", "maxDist", "startDist", "eps", "aoAmp",
              "groundY", "shadowBias", "lightScatter", "minLightAtt", "exposure",
              "dof", "frameBlend", "fogPow", "flareAmp"):
        setattr(p, k, float(getattr(opts, k)))
    for dst, src in (("lightPos", opts.lightPos), ("lightColor", opts.lightColor),
                     ("matAlbedo", opts.mat_albedo)):
        rows = src.numpy()
        for r in range(4):
            getattr(p, dst)[r][:] = [float(v) for v in rows[r]]
    p.matR0[:] = [float(v) for v in opts.mat_r0.numpy()]
    p.matSmooth[:] = [float(v) for v in opts.mat_smoothness.numpy()]
    return p


def render_pass_plain(vol, opts, table, accum, accel: Accel | None = None) -> torch.Tensor:
    """Plain version: the pass's blended accum (a new tensor)."""
    ids = torch.arange(opts.num_pixels, device=accum.device)
    state = init_render_state(opts, table, ids)
    ray_pos, ray_dir = camera_ray_lookat(opts, state)
    col = scene_color(vol, opts, table, state, ray_pos, ray_dir, accel)
    col_a = (col * opts.exposure).to_array()
    return fma(col_a - accum, opts.frameBlend, accum)


def _check(vol, opts, table, accum, accel):
    rx, ry, rz, _ = opts.voxelRes
    if vol.dtype != torch.uint8 or vol.shape != (rx * ry * rz,):
        raise ValueError(f"vol must be flat uint8 of {rx * ry * rz} voxels, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if table.dtype != torch.float32 or table.shape != (opts.mcTableLength, 4):
        raise ValueError(f"table must be ({opts.mcTableLength}, 4) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if accum.dtype != torch.float32 or accum.shape != (opts.num_pixels, 3):
        raise ValueError(f"accum must be ({opts.num_pixels}, 3) float32, got "
                         f"{tuple(accum.shape)} {accum.dtype}")
    if not (vol.is_contiguous() and table.is_contiguous() and accum.is_contiguous()):
        raise ValueError("vol, table and accum must be contiguous")
    if not vol.device == table.device == accum.device:
        raise ValueError(f"vol, table and accum on different devices: "
                         f"{vol.device}, {table.device}, {accum.device}")
    if accel is not None:
        nbx, nby, nbz = brick_dims(opts.voxelRes, accel.edge)
        rows = accel.rows
        if rows.shape[0] != nbx * nby * nbz:
            raise ValueError(f"accel rows: {rows.shape[0]} bricks, the volume has "
                             f"{nbx * nby * nbz} of edge {accel.edge}")
        if not rows.is_contiguous() or rows.device != vol.device:
            raise ValueError(f"accel rows must be contiguous on {vol.device}")


def render_pass(vol, opts, table, accum, accel: Accel | None = None) -> torch.Tensor:
    """One pass blended into `accum` in place; returns accum. `accel` is
    the volume's brick table or None. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    _check(vol, opts, table, accum, accel)
    if accum.device.type == "cpu":
        return accum.copy_(render_pass_plain(vol, opts, table, accum, accel))
    if accum.device.type != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 loads)")
    global LAUNCHES
    params = make_params(opts, accel)
    rows = None if accel is None else accel.rows.data_ptr()
    lib = build.library()
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rmcl_render_pass(ctypes.byref(params), vol.data_ptr(), table.data_ptr(),
                                  rows, accum.data_ptr(), opts.num_pixels, stream)
    build.check(rc, "rmcl_render_pass")
    LAUNCHES += 1
    return accum
