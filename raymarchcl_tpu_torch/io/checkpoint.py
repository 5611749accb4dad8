"""Checkpoint/resume for progressive renders.

Counterpart of `raymarchcl_tpu/io/checkpoint.py`, in its file format. The
reference's accumulation buffer is a resumable state: each pass blends into
p-buf (renderer.cl:492) and `test-anim` relies on it persisting across
executions (core.clj:194-208). Here it is saved and loaded with the
metadata that validates a resume, and a chunked render loop checkpoints between
spp chunks so long renders survive interruption. A checkpoint written by
the JAX package resumes here and the other way round: same `.npz` layout,
same digest of the MC tables and pass times.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..convert import accum_on, tables_on, volume_on
from ..ops import render as render_mod
from ..ops.accel import Accel
from ..ops.kernels.render_pass import pass_times
from ..runtime import check_device

FORMAT = "raymarchcl_tpu/accum/v1"


def _host(x) -> np.ndarray:
    """numpy view of an array or tensor (tensors copied to the host)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _npz(path) -> str:
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def pass_digest(mc_tables, times, seed=None) -> str:
    """Digest of everything that determines a pass sequence's output (the MC
    tables and pass times). Two renders blend compatibly iff it matches."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(_host(mc_tables), np.float32).tobytes())
    h.update(np.ascontiguousarray(_host(times), np.float32).tobytes())
    h.update(repr(seed).encode())
    return h.hexdigest()[:32]


def save_accum(path, accum, opts, passes_done, seed=None, digest=None) -> str:
    """Write accumulation state + metadata to `path` (.npz appended if
    missing); returns the path written. The archive is stored uncompressed:
    np.load (and the JAX package's load_accum) reads it as it reads the
    JAX package's compressed one, and a 1024^2 frame's accum writes in a
    fraction of zlib's time."""
    path = _npz(path)
    meta = {
        "resolution": list(opts.resolution),
        "voxelRes": list(opts.voxelRes),
        "passes_done": int(passes_done),
        "frameBlend": float(opts.frameBlend),
        "seed": seed,
        "digest": digest,
        "format": FORMAT,
    }
    np.savez(path, accum=np.asarray(_host(accum), np.float32), meta=json.dumps(meta))
    return path


def load_accum(path, opts=None):
    """Read accumulation state -> (accum (N, 3) float32 numpy, meta dict).
    With `opts`, refuses a checkpoint of another resolution."""
    path = _npz(path)
    with np.load(path, allow_pickle=False) as z:
        accum = z["accum"]
        meta = json.loads(str(z["meta"]))
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not an accumulation checkpoint")
    if opts is not None and list(opts.resolution) != meta["resolution"]:
        raise ValueError(f"{path}: checkpoint is {meta['resolution']}, opts want "
                         f"{list(opts.resolution)}")
    return accum, meta


def render_checkpointed(vol, opts, mc_tables, ckpt_path, chunk=8, times=None, progress=None,
                        accel=None, device="cuda"):
    """Render all spp passes on `device` in chunks, checkpointing after each
    chunk and resuming from ckpt_path if it exists. Returns (argb (H, W)
    uint32 numpy, accum (N, 3) tensor on device).

    vol: flat uint8 voxels; mc_tables: (P, T, 4) float32 (numpy or tensor);
    accel: the volume's brick table or None. Each chunk is one render pass
    launch over tables[c0:c1] at times[c0:c1], so the result is bit-equal
    to an uninterrupted render. A fully resumed render packs the loaded
    accum on its own (render.pack_argb).
    """
    dev = check_device(device)
    vol = volume_on(vol, dev)
    tables = tables_on(mc_tables, dev)
    n_passes = tables.shape[0]
    if times is None:
        times = torch.arange(n_passes, dtype=torch.float32) * render_mod.TIME_STEP_INIT
    times = pass_times(times)
    if accel is not None and accel.rows.device != dev:
        accel = Accel(accel.rows.to(dev), accel.edge)
    digest = pass_digest(tables, times)
    start, accum = 0, None
    if os.path.exists(_npz(ckpt_path)):
        accum_np, meta = load_accum(ckpt_path, opts)
        # a checkpoint written directly by save_accum has no digest and
        # cannot be validated; one written here must match, or the blend
        # would mix passes of other tables or times
        if meta.get("digest") is not None and meta["digest"] != digest:
            raise ValueError(
                f"{ckpt_path}: checkpoint was written for different MC tables/times "
                f"(digest {meta.get('digest')} != {digest}); resuming would blend "
                "mismatched passes")
        start = meta["passes_done"]
        accum = accum_on(accum_np, dev)
    if accum is None:
        accum = torch.zeros((opts.num_pixels, 3), dtype=torch.float32, device=dev)
    argb = None
    for c0 in range(start, n_passes, chunk):
        c1 = min(c0 + chunk, n_passes)
        argb, accum = render_mod.render_image(vol, opts, tables[c0:c1], times=times[c0:c1],
                                              accum=accum, accel=accel)
        save_accum(ckpt_path, accum, opts, c1, digest=digest)
        if progress:
            progress(c1, n_passes)
    if argb is None:  # fully resumed: pack the loaded state
        w, h = opts.resolution
        argb = render_mod.pack_argb(opts, accum).cpu().numpy().view(np.uint32).reshape(h, w)
    return argb, accum
