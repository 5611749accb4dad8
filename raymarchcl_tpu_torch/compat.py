"""Byte-level compatibility entry: render directly from TRenderOpts blobs.

Counterpart of `raymarchcl_tpu/compat.py`. Ties the binary codec
(options_codec.py) to the renderer: given the exact bytes the reference
host would enqueue as its option buffer (core.clj:104-105), an externally
supplied MC sample table and a `.vox` volume, produce the frame. A
reference run's inputs can be captured and replayed here.
"""

from __future__ import annotations

import torch

from . import options_codec as codec
from .api import build_accel_for
from .convert import accum_on, tables_on, volume_on
from .ops import render as render_mod
from .options import DYNAMIC_FIELDS, MC_TABLE_LENGTH, RenderOpts, f32
from .runtime import check_device


def opts_from_blob(blob: bytes) -> RenderOpts:
    """TRenderOpts bytes -> RenderOpts (float fields as float32 CPU
    tensors)."""
    d = codec.decode(blob)
    mats = d["materials"]
    return RenderOpts(
        resolution=tuple(int(v) for v in d["resolution"]),
        voxelRes=tuple(int(v) for v in d["voxelRes"]),
        maxIter=int(d["maxIter"]),
        maxVoxelIter=int(d["maxVoxelIter"]),
        shadowIter=int(d["shadowIter"]),
        aoIter=int(d["aoIter"]),
        reflectIter=int(d["reflectIter"]),
        numLights=int(d["numLights"]),
        isoVal=int(d["isoVal"]),
        mcTableLength=int(d["mcTableLength"]) or MC_TABLE_LENGTH,
        voxelBounds=tuple(d["voxelBounds"]),
        voxelBounds2=tuple(d["voxelBounds2"]),
        voxelBoundsMin=tuple(d["voxelBoundsMin"]),
        voxelBoundsMax=tuple(d["voxelBoundsMax"]),
        invVoxelScale=tuple(d["invVoxelScale"]),
        aoStepDist=float(d["aoStepDist"]),
        voxelSize=float(d["voxelSize"]),
        **{k: f32(d[k]) for k in DYNAMIC_FIELDS if not k.startswith("mat_")},
        mat_albedo=f32([m["albedo"] for m in mats]),
        mat_r0=f32([m["r0"] for m in mats]),
        mat_smoothness=f32([m["smoothness"] for m in mats]),
    )


def render_from_blobs(opt_blobs, volume, mc_tables, accum=None, accel=True, device="cuda"):
    """Replay the reference's exact per-pass inputs on `device`.

    opt_blobs: TRenderOpts byte blobs, one per pass (the reference
    allocates `iter` option buffers differing only in `time`,
    core.clj:99-106); the frame takes the first blob's options and each
    blob's time. mc_tables: (iter, tableLen, 4) float32, the reference's
    host-generated tables injected for exact-parity runs. volume: flat
    uint8 voxels (numpy or tensor). Returns (argb (H, W) uint32 numpy,
    accum (N, 3) tensor on device).
    """
    dev = check_device(device)
    opts_list = [opts_from_blob(b) for b in opt_blobs]
    opts0 = opts_list[0]
    times = torch.stack([o.time for o in opts_list]).reshape(-1)
    tables = tables_on(mc_tables, dev)
    vol = volume_on(volume, dev)
    acc = build_accel_for(vol, opts0) if accel else None
    if accum is not None:
        accum = accum_on(accum, dev)
    return render_mod.render_image(vol, opts0, tables, times=times, accum=accum, accel=acc)
