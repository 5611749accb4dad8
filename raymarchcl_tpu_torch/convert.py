"""Carry render state in from numpy: options, volumes, MC tables and brick
tables.

The JAX package and this port share no objects; tests and tools move state
between them as numpy arrays and python scalars. These helpers build the
port's values from such plain data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.accel import Accel
from .options import DYNAMIC_FIELDS, RenderOpts, f32


def opts_from_numpy(fields: dict) -> RenderOpts:
    """RenderOpts from a dict of every field (numpy arrays, python scalars
    or tuples), e.g. `{f.name: getattr(jax_opts, f.name) ...}` after
    `np.asarray` of the array fields."""
    kw = {}
    for f in dataclasses.fields(RenderOpts):
        v = fields[f.name]
        if f.name in DYNAMIC_FIELDS:
            kw[f.name] = f32(np.asarray(v))
        elif f.name in ("resolution", "voxelRes"):
            kw[f.name] = tuple(int(x) for x in v)
        elif f.name in _FLOAT_TRIPLES:
            kw[f.name] = tuple(float(x) for x in v)
        elif f.name in ("aoStepDist", "voxelSize"):
            kw[f.name] = float(v)
        else:
            kw[f.name] = int(v)
    return RenderOpts(**kw)


_FLOAT_TRIPLES = ("voxelBounds", "voxelBounds2", "voxelBoundsMin",
                  "voxelBoundsMax", "invVoxelScale")


def volume_from_numpy(vol, device="cpu") -> torch.Tensor:
    """Flat uint8 voxel tensor (index z*rx*ry + y*rx + x) on `device`."""
    arr = np.ascontiguousarray(np.asarray(vol, dtype=np.uint8).reshape(-1))
    return torch.from_numpy(arr.copy()).to(device)


def accel_from_numpy(rows, edge=8, device="cpu") -> Accel:
    """Brick table from its (NB, edge^3/32 + 2) uint32 rows, e.g. the JAX
    package's `Accel.rows` after `np.asarray`, on `device`."""
    arr = np.ascontiguousarray(np.asarray(rows, dtype=np.uint32))
    return Accel(torch.from_numpy(arr.view(np.int32).copy()).to(device), edge)


def tables_from_numpy(tables, device="cpu") -> torch.Tensor:
    """MC tables as float32 (P, T, 4) (or one (T, 4) table) on `device`."""
    arr = np.ascontiguousarray(np.asarray(tables, dtype=np.float32))
    if arr.ndim not in (2, 3) or arr.shape[-1] != 4:
        raise ValueError(f"MC tables must be (T, 4) or (P, T, 4), got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def volume_on(volume, device) -> torch.Tensor:
    """A flat uint8 volume (numpy array or tensor) as a contiguous tensor
    on `device`."""
    if isinstance(volume, torch.Tensor):
        return volume.to(device=device, dtype=torch.uint8).reshape(-1).contiguous()
    return volume_from_numpy(volume, device)


def tables_on(tables, device) -> torch.Tensor:
    """MC tables (numpy array or tensor) as a contiguous float32 tensor on
    `device` whose storage starts 16-byte aligned (K2 reads float4s)."""
    if not isinstance(tables, torch.Tensor):
        return tables_from_numpy(tables, device)
    t = tables.detach().to(device=device, dtype=torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def accum_on(accum, device) -> torch.Tensor:
    """An (N, 3) accumulation (numpy array or tensor) as a contiguous
    float32 tensor on `device`."""
    if not isinstance(accum, torch.Tensor):
        accum = torch.from_numpy(np.array(accum, dtype=np.float32))
    return accum.detach().to(device=device, dtype=torch.float32).contiguous()
