"""Procedural voxel volumes (gyroid, terrain) in numpy float64.

Counterpart of `raymarchcl_tpu/models/generators.py` (reference:
generators.clj:18-60). Only the float64 numpy paths are ported: they are
byte-equal to the JAX package's native C++ and numpy paths. Byte values as
the device reads them: the reference's Java signed bytes 64 / -128 / -1 are
uchar 64 / 128 / 255.
"""

from __future__ import annotations

import numpy as np


def _gyroid_slab_np(z0, n, rx, ry, scl):
    """One z-slab of the sliced gyroid volume in float64."""
    zs = np.arange(z0, z0 + n)
    x = np.arange(rx, dtype=np.float64) * scl + 0.3875
    y = np.arange(ry, dtype=np.float64) * scl
    z = zs.astype(np.float64) * scl
    v = np.abs(
        np.cos(x)[None, None, :] * np.sin(z)[:, None, None]
        + np.cos(y)[None, :, None] * np.sin(x)[None, None, :]
        + np.cos(z)[:, None, None] * np.sin(y)[None, :, None]
    ) - 1.0
    xi = np.arange(rx)[None, None, :]
    shell = np.abs(0.2 - v) < 0.05  # generators.clj:39
    stripe = (xi & 0x3F) < 32  # generators.clj:40
    interior = v > 0.35  # generators.clj:41
    vox = np.where(
        shell, np.where(stripe, np.uint8(64), np.uint8(128)),
        np.where(interior, np.uint8(255), np.uint8(0)),
    ).astype(np.uint8)
    zmask = (zs & 0x3F) >= 32  # z-slicing (generators.clj:35)
    vox[~zmask] = 0
    return vox


def make_gyroid_volume(opts_or_vres, slab=None) -> np.ndarray:
    """Sliced gyroid volume (reference: generators.clj:27-42).

    Accepts a dict with key 'vres' or an int/triple. Returns a flat uint8
    array of rx*ry*rz voxels, index z*(rx*ry)+y*rx+x.
    """
    rx, ry, rz = _vres3(opts_or_vres)
    scl = 0.01 * (512.0 / rx)  # generators.clj:33
    if slab is None:
        slab = max(1, min(rz, (1 << 24) // max(1, rx * ry)))  # ~16M voxels/slab
    out = np.empty(rx * ry * rz, dtype=np.uint8)
    for z0 in range(0, rz, slab):
        n = min(slab, rz - z0)
        out[z0 * rx * ry : (z0 + n) * rx * ry] = _gyroid_slab_np(
            z0, n, rx, ry, scl).reshape(-1)
    return out


def make_terrain(opts_or_vres) -> np.ndarray:
    """Walls + sinusoidal pillar terrain demo volume
    (reference: generators.clj:44-60)."""
    rx, ry, rz = _vres3(opts_or_vres)
    vox = np.zeros((rz, ry, rx), dtype=np.uint8)
    wall_y = int(ry * 0.666)
    vox[:4, :wall_y, :] = 64  # wall 1 (generators.clj:50)
    # wall 2 (generators.clj:51): the reference indexes x over slabs and
    # assumes cubic volumes; clamp to min(rx, rz) slabs for other grids
    for z in range(4):
        if rx - 1 - z >= 0:
            vox[: min(rx, rz), :wall_y, rx - 1 - z] = 64
    # pillars (generators.clj:52-59)
    x = np.arange(rx)
    z = np.arange(rz)
    dx = 16 - (x % 32)
    dz = 16 - (z % 32)
    inside = dz[:, None] ** 2 + dx[None, :] ** 2 <= 121  # (rz, rx)
    h = (
        ry * (0.25 + 0.125 * np.sin(z[:, None] * 0.02) * np.cos(x[None, :] * 0.03))
    ).astype(np.int32)  # (rz, rx)
    y = np.arange(ry)
    vox[(y[None, :, None] <= h[:, None, :]) & inside[:, None, :]] = 255
    return vox.reshape(-1)


def _vres3(opts_or_vres):
    vres = opts_or_vres["vres"] if isinstance(opts_or_vres, dict) else opts_or_vres
    if isinstance(vres, (int, np.integer)):
        vres = (int(vres),) * 3
    rx, ry, rz = (int(v) for v in vres)
    return rx, ry, rz
