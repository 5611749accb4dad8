"""K2: the spp passes of one frame, blended into accum in order
(reference: RenderImage, renderer.cl:478-494).

On the TPU each pass is jnp code lowered by XLA (`raymarchcl_tpu/ops`:
sampling, camera, march, shade and render.render_pass); there is no Pallas
source. On the H100 a frame is one launch of a hand-written CUDA kernel,
csrc/render_pass.cu, which notes what bounds it: a thread renders every
pass of its pixel in order. Presets with reflections (reflectIter > 0) run
the kernel's reflective instances, which add the bounce loop. Its plain
version is `render_pass_plain`, built from this package's ops modules, once
per pass. Both march over the brick table (ops/accel.py) when one is given,
with the same result as without it. Both render a range of the frame's
pixels when asked (`pix_lo`, `pix_count`: one tile of a multi-device frame,
parallel/tiling.py); a pixel keeps its global id, which seeds its passes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel import Accel, brick_dims, row_words
from ..camera import camera_ray_lookat, view_scales
from ..sampling import init_render_state
from ..shade import ao_step_dist, ao_trunc_steps, scene_color
from ..vecmath import fma
from . import build
from .tonemap import tonemap_pack_plain

LAUNCHES = 0  # K2 launches (one per render_passes call; plain-version calls excluded)
REFLECTIVE_LAUNCHES = 0  # those of LAUNCHES that ran the reflective instance (K2c)
PACKS = 0  # K2 launches that also packed the image (K1's pack as their epilogue)

# The loops the counting build counts, in the order of csrc/render_pass.cu's
# CountedLoop: (warp iterations, active lanes) of each
COUNTED_LOOPS = ("primary_samples", "primary_steps", "ao_samples", "shadow_samples",
                 "shadow_steps", "bounce_samples", "bounce_steps")
SAMPLE_LOOPS = ("primary_samples", "ao_samples", "shadow_samples", "bounce_samples")

MAX_LIGHTS = 4  # the kernel's light arrays; no preset of the JAX package has more

_f, _i = ctypes.c_float, ctypes.c_int


class RmclParams(ctypes.Structure):
    """Mirror of `struct RmclParams` in csrc/rmcl_common.cuh."""

    _fields_ = [
        ("width", _i), ("height", _i),
        ("rx", _i), ("ry", _i), ("rz", _i), ("rxy", _i),
        ("maxIter", _i), ("maxVoxelIter", _i), ("shadowIter", _i), ("aoIter", _i),
        ("numLights", _i), ("isoVal", _i), ("reflectIter", _i), ("tableLen", _i),
        ("edge", _i), ("brickShift", _i), ("nbx", _i), ("nby", _i), ("rowWords", _i),
        ("aoSteps", _i), ("pixLo", _i), ("pixCount", _i),
        ("marchScale", _f), ("aoScale", _f), ("shadowBaseStep", _f),
        ("invNumLights", _f), ("voxelSize", _f),
        ("bmin", _f * 3), ("bmax", _f * 3), ("vb", _f * 3), ("vb2", _f * 3),
        ("invS", _f * 3),
        ("eyePos", _f * 3), ("targetPos", _f * 3), ("up", _f * 3),
        ("sky1", _f * 3), ("sky2", _f * 3),
        ("invAspect", _f), ("fov", _f), ("maxDist", _f),
        ("startDist", _f), ("eps", _f), ("aoAmp", _f), ("groundY", _f),
        ("shadowBias", _f), ("lightScatter", _f), ("minLightAtt", _f),
        ("exposure", _f), ("dof", _f), ("frameBlend", _f), ("fogPow", _f),
        ("flareAmp", _f), ("gamma", _f), ("viewScale", _f * 2), ("viewHalf", _f),
        ("lightPos", (_f * 4) * 4), ("lightColor", (_f * 4) * 4),
        ("matAlbedo", (_f * 4) * 4), ("matR0", _f * 4), ("matSmooth", _f * 4),
    ]


def make_params(opts, accel: Accel | None = None, pix_lo: int = 0,
                pix_count: int | None = None) -> RmclParams:
    """The kernel's parameter block, one per launch (the pass times and AO
    probes go beside it, `launch_block`); derived constants in float32
    exactly as the plain version computes them. The brick fields stay 0
    without a brick table; reflectIter > 0 selects the reflective
    instance; the launch renders the pixel range `pixel_range(opts, pix_lo,
    pix_count)` gives."""
    if not 1 <= opts.numLights <= MAX_LIGHTS:
        raise ValueError(f"numLights must be in [1, {MAX_LIGHTS}] (the kernel's light arrays; "
                         f"the JAX presets use 1 or 2), got {opts.numLights}")
    if opts.aoIter < 0:
        raise ValueError(f"aoIter must be >= 0, got {opts.aoIter}")
    f32 = np.float32
    p = RmclParams()
    p.width, p.height = opts.resolution
    p.rx, p.ry, p.rz, p.rxy = opts.voxelRes
    for k in ("maxIter", "maxVoxelIter", "shadowIter", "aoIter", "numLights", "isoVal",
              "reflectIter"):
        setattr(p, k, getattr(opts, k))
    p.tableLen = opts.mcTableLength
    if accel is not None:
        p.edge, p.brickShift = accel.edge, accel.edge.bit_length() - 1
        p.nbx, p.nby, _ = brick_dims(opts.voxelRes, accel.edge)
        p.rowWords = row_words(accel.edge)
    p.aoSteps = opts.maxVoxelIter // 2
    p.pixLo, p.pixCount = pixel_range(opts, pix_lo, pix_count)
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
    for k in ("invAspect", "fov", "maxDist", "startDist", "eps", "aoAmp",
              "groundY", "shadowBias", "lightScatter", "minLightAtt", "exposure",
              "dof", "frameBlend", "fogPow", "flareAmp", "gamma"):
        setattr(p, k, float(getattr(opts, k)))
    for dst, src in (("lightPos", opts.lightPos), ("lightColor", opts.lightColor),
                     ("matAlbedo", opts.mat_albedo)):
        rows = src.numpy()
        for r in range(4):
            getattr(p, dst)[r][:] = [float(v) for v in rows[r]]
    sx, sy, p.viewHalf = view_scales(opts)
    p.viewScale[:] = [sx, sy]
    p.matR0[:] = [float(v) for v in opts.mat_r0.numpy()]
    p.matSmooth[:] = [float(v) for v in opts.mat_smoothness.numpy()]
    return p


def pixel_range(opts, pix_lo: int = 0, pix_count: int | None = None) -> tuple:
    """(pix_lo, pix_count) of a launch, pix_count by default the pixels
    from pix_lo to the frame's end. Row i of its accum and image is pixel
    min(pix_lo + i, N - 1): rows past the last pixel (a padded tile's tail)
    render that pixel again, as the JAX package's padded shards do."""
    n = opts.num_pixels
    pix_lo = int(pix_lo)
    pix_count = max(n - pix_lo, 0) if pix_count is None else int(pix_count)
    if pix_lo < 0 or pix_count < 0 or pix_lo + pix_count > 2**31 - 1:
        raise ValueError(f"pixel range [{pix_lo}, {pix_lo} + {pix_count}) out of bounds")
    return pix_lo, pix_count


def pass_times(times) -> torch.Tensor:
    """Each pass's time as the float32 value `opts.replace(time=t)` gives
    it: a (P,) float32 CPU tensor."""
    if isinstance(times, torch.Tensor):
        return times.detach().to("cpu", torch.float32).reshape(-1)
    return torch.tensor([np.float32(t) for t in times], dtype=torch.float32)


def launch_block(opts, times: torch.Tensor) -> torch.Tensor:
    """What goes to the card beside the parameter block, in one copy: each
    pass's time (`pass_times`), then per AO probe i <= aoIter its distance
    shade.ao_step_dist (float32), then its sample cap shade.ao_trunc_steps
    (int32). An int32 CPU tensor holding the bits."""
    steps = opts.maxVoxelIter // 2
    probes = range(opts.aoIter + 1)
    dist = np.array([ao_step_dist(opts, i) for i in probes], np.float32)
    cap = np.array([ao_trunc_steps(opts, steps, i) for i in probes], np.int32)
    return torch.from_numpy(np.concatenate([times.numpy().view(np.int32), dist.view(np.int32),
                                            cap]))


def render_pass_plain(vol, opts, table, accum, accel: Accel | None = None,
                      pix_lo: int = 0) -> torch.Tensor:
    """Plain version of one pass: the pass's blended accum (a new tensor).
    accum's rows are the pixel range from pix_lo (`pixel_range`)."""
    ids = torch.clamp(torch.arange(pix_lo, pix_lo + accum.shape[0], device=accum.device),
                      max=opts.num_pixels - 1)
    state = init_render_state(opts, table, ids)
    ray_pos, ray_dir = camera_ray_lookat(opts, state)
    col = scene_color(vol, opts, table, state, ray_pos, ray_dir, accel)
    col_a = (col * opts.exposure).to_array()
    return fma(col_a - accum, opts.frameBlend, accum)


def _check(vol, opts, tables, times, accum, accel, argb=None, pix_count=None):
    rx, ry, rz, _ = opts.voxelRes
    if vol.dtype != torch.uint8 or vol.shape != (rx * ry * rz,):
        raise ValueError(f"vol must be flat uint8 of {rx * ry * rz} voxels, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if (tables.dtype != torch.float32 or tables.dim() != 3
            or tables.shape[1:] != (opts.mcTableLength, 4)):
        raise ValueError(f"table must be (P, {opts.mcTableLength}, 4) float32 tables, got "
                         f"{tuple(tables.shape)} {tables.dtype}")
    if times.shape != (tables.shape[0],):
        raise ValueError(f"times: {tuple(times.shape)} for {tables.shape[0]} passes")
    n = opts.num_pixels if pix_count is None else pix_count
    if accum.dtype != torch.float32 or accum.shape != (n, 3):
        raise ValueError(f"accum must be ({n}, 3) float32, got "
                         f"{tuple(accum.shape)} {accum.dtype}")
    if not (vol.is_contiguous() and tables.is_contiguous() and accum.is_contiguous()):
        raise ValueError("vol, table and accum must be contiguous")
    if not vol.device == tables.device == accum.device:
        raise ValueError(f"vol, table and accum on different devices: "
                         f"{vol.device}, {tables.device}, {accum.device}")
    if accel is not None:
        nbx, nby, nbz = brick_dims(opts.voxelRes, accel.edge)
        rows = accel.rows
        if rows.shape[0] != nbx * nby * nbz:
            raise ValueError(f"accel rows: {rows.shape[0]} bricks, the volume has "
                             f"{nbx * nby * nbz} of edge {accel.edge}")
        if not rows.is_contiguous() or rows.device != vol.device:
            raise ValueError(f"accel rows must be contiguous on {vol.device}")
    if argb is not None and (argb.dtype != torch.int32 or argb.shape != (n,)
                             or not argb.is_contiguous() or argb.device != accum.device):
        raise ValueError(f"argb must be contiguous ({n},) int32 on "
                         f"{accum.device}, got {tuple(argb.shape)} {argb.dtype} on {argb.device}")


def _launch(vol, opts, tables, times, accum, accel, counts, argb=None, pix_lo=0,
            pix_count=None) -> None:
    """One launch of K2 over all passes and the pixel range; `counts`
    selects the counting build, `argb` the pack of the final accum."""
    if accum.device.type != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    if tables.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 loads)")
    global LAUNCHES, PACKS, REFLECTIVE_LAUNCHES
    params = make_params(opts, accel, pix_lo, pix_count)
    # pinned and non-blocking: a pageable copy would wait for the stream
    block_d = launch_block(opts, times).pin_memory().to(accum.device, non_blocking=True)
    next_tile = torch.zeros(1, dtype=torch.int32, device=accum.device)
    rows = None if accel is None else accel.rows.data_ptr()
    lib = build.library()
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rmcl_render_passes(ctypes.byref(params), vol.data_ptr(), tables.data_ptr(),
                                    block_d.data_ptr(), tables.shape[0], rows,
                                    accum.data_ptr(), None if argb is None else argb.data_ptr(),
                                    next_tile.data_ptr(),
                                    None if counts is None else counts.data_ptr(), stream)
    build.check(rc, "rmcl_render_passes")
    LAUNCHES += 1
    if opts.reflectIter > 0:
        REFLECTIVE_LAUNCHES += 1
    if argb is not None:
        PACKS += 1


def render_passes(vol, opts, tables, times, accum, accel: Accel | None = None,
                  argb: torch.Tensor | None = None, pix_lo: int = 0,
                  pix_count: int | None = None) -> torch.Tensor:
    """Passes [0, P) of `tables` (P, T, 4) at `times` (P,), blended into
    `accum` in place in order; returns accum. `accel` is the volume's brick
    table or None. `argb`, an int32 tensor or None, is filled with the
    final accum tonemapped and packed (K1's function). accum (pix_count, 3)
    and argb (pix_count,) hold the pixel range from pix_lo (`pixel_range`;
    by default the whole frame, N rows). CPU tensors take the plain
    versions, pass by pass, then the pack; CUDA tensors launch the kernel
    once, which packs in its epilogue (or raise)."""
    times = pass_times(times)
    pix_lo, pix_count = pixel_range(opts, pix_lo, pix_count)
    _check(vol, opts, tables, times, accum, accel, argb, pix_count)
    if accum.device.type == "cpu":
        for p in range(tables.shape[0]):
            accum.copy_(render_pass_plain(vol, opts.replace(time=times[p]), tables[p], accum,
                                          accel, pix_lo))
        if argb is not None:
            argb.copy_(tonemap_pack_plain(accum, opts.gamma))
        return accum
    _launch(vol, opts, tables, times, accum, accel, None, argb, pix_lo, pix_count)
    return accum


def render_pass(vol, opts, table, accum, accel: Accel | None = None,
                argb: torch.Tensor | None = None, pix_lo: int = 0,
                pix_count: int | None = None) -> torch.Tensor:
    """One pass (`table` (T, 4) at opts.time) blended into `accum` in place;
    returns accum. The one-pass call of `render_passes`."""
    return render_passes(vol, opts, table[None], opts.time.reshape(1), accum, accel, argb,
                         pix_lo, pix_count)


def count_lanes(vol, opts, tables, times, accum, accel: Accel) -> dict:
    """The counting build of K2 over the brick table on a CUDA device: the
    same passes and accum as `render_passes`, and per counted loop its warp
    iterations and active lanes, with `samples` the lanes of the sample
    loops (the march samples the kernel took)."""
    if accel is None:
        raise ValueError("the counting build marches over the brick table")
    times = pass_times(times)
    _check(vol, opts, tables, times, accum, accel)
    counts = torch.zeros(2 * len(COUNTED_LOOPS), dtype=torch.int64, device=accum.device)
    _launch(vol, opts, tables, times, accum, accel, counts)
    c = counts.cpu().tolist()
    out = {name: {"iters": c[2 * i], "lanes": c[2 * i + 1],
                  "active": c[2 * i + 1] / max(32 * c[2 * i], 1)}
           for i, name in enumerate(COUNTED_LOOPS)}
    out["samples"] = sum(out[name]["lanes"] for name in SAMPLE_LOOPS)
    return out
