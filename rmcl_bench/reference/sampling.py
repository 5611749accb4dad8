"""MC table lookups and per-pixel jitter state (renderer.cl:142-144,
467-476), for lanes that each carry their own pass.

A lane is one (frame pose, pixel, pass) triple: its pass selects its MC
table and time, its frame pose its eye position. Seeds are uint32 values
held in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import V3, f2i_sat, fma, normalize

U32_MASK = 0xFFFFFFFF


class Lanes(NamedTuple):
    """tables: (P*T, 4) float32, the passes' MC tables one after another;
    base: (L,) int64, the first row of each lane's table (pass * T); time:
    (L,) float32, each lane's pass time; eye: V3 of (L,) float32, each
    lane's eye position (its frame's pose); ids: (L,) int64 pixel ids."""

    tables: torch.Tensor
    base: torch.Tensor
    time: torch.Tensor
    eye: V3
    ids: torch.Tensor


def f2u32(x) -> torch.Tensor:
    """(uint)(float expr): via int32 with truncation, saturation, NaN -> 0."""
    return f2i_sat(torch.as_tensor(x, dtype=torch.float32)) & U32_MASK


def rand_float4(lanes: Lanes, seed):
    """The lane's table[seed & 0x3fff] -> (x, y, z, w)."""
    row = lanes.tables[lanes.base + (seed & 0x3FFF)]
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3]


def rand_xyz(lanes: Lanes, seed) -> V3:
    x, y, z, _ = rand_float4(lanes, seed)
    return V3(x, y, z)


def init_render_state(opts, lanes: Lanes):
    """renderer.cl:467-476: jittered pixel coords, the MC normal and the
    DOF-offset eye of each lane."""
    ids = lanes.ids
    w = opts.resolution[0]
    pix_x = (ids % w).float()
    pix_y = torch.div(ids, w, rounding_mode="floor").float()
    t = lanes.time
    seed_pos = ((ids * 17) + f2u32(t * 3141.3862)) & U32_MASK
    seed_nrm = ((ids * 37) + f2u32(t * 1859.1467)) & U32_MASK
    _, _, pz, pw = rand_float4(lanes, seed_pos)
    mc_normal = normalize(rand_xyz(lanes, seed_nrm))
    eye = V3(fma(mc_normal.z, opts.dof, lanes.eye.x),
             fma(mc_normal.x, opts.dof, lanes.eye.y),
             fma(mc_normal.y, opts.dof, lanes.eye.z))
    return {"px": pix_x + pz, "py": pix_y + pw, "mc_normal": mc_normal, "eye_pos": eye}


def light_seed(lanes: Lanes, px, py):
    """renderer.cl:267."""
    return f2u32(fma(px, 1957.0, py * 2173.0) + lanes.time * 4763.742)


def ao_seed(lanes: Lanes, pos: V3):
    """renderer.cl:334."""
    s = fma(pos.z, 2945.87, fma(pos.x, 3183.75, pos.y * 1831.42))
    return f2u32(s + lanes.time * 2671.918)
