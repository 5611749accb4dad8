"""The inputs of a run, made from its seed and handed alike to the program
and to the reference: the volume, the MC tables, the camera ring and the
pixels the check samples. The same seed gives the same inputs."""

from __future__ import annotations

import math
import random

import numpy as np
import torch

T_LEN = 0x4000  # rows of an MC table (core.clj:138)
TIME_STEP = 0.333  # pass time step of a still (core.clj:105)


def rng(seed: int, stream: str) -> random.Random:
    """A host generator of `seed`'s named stream (a str seed is hashed with
    sha512: the same on every machine and process)."""
    return random.Random(f"{int(seed)}:{stream}")


def gyroid_volume(vres: int, device) -> torch.Tensor:
    """The sliced gyroid (generators.clj:27-42) as a flat uint8 tensor
    (index z*rx*ry + y*rx + x) made on `device` in float64, a z-slab at a
    time: shell |0.2 - v| < 0.05 as 64 or 128 by x stripe, interior v >
    0.35 as 255, slabs with (z & 63) < 32 empty."""
    n = int(vres)
    scl = 0.01 * (512.0 / n)
    ar = torch.arange(n, device=device, dtype=torch.float64)
    x, y = ar * scl + 0.3875, ar * scl
    cx, sx = torch.cos(x)[None, None, :], torch.sin(x)[None, None, :]
    cy, sy = torch.cos(y)[None, :, None], torch.sin(y)[None, :, None]
    stripe = (torch.arange(n, device=device) & 0x3F) < 32
    out = torch.empty((n, n, n), dtype=torch.uint8, device=device)
    slab = max(1, (1 << 22) // (n * n))
    for z0 in range(0, n, slab):
        z = torch.arange(z0, min(n, z0 + slab), device=device, dtype=torch.float64) * scl
        cz, sz = torch.cos(z)[:, None, None], torch.sin(z)[:, None, None]
        v = torch.abs(cx * sz + cy * sx + cz * sy) - 1.0
        shell = torch.abs(0.2 - v) < 0.05
        vox = torch.where(shell, torch.where(stripe[None, None, :], 64, 128),
                          torch.where(v > 0.35, 255, 0)).to(torch.uint8)
        zi = torch.arange(z0, z0 + vox.shape[0], device=device)
        vox[(zi & 0x3F) < 32] = 0
        out[z0:z0 + vox.shape[0]] = vox
    return out.reshape(-1)


VOLUMES = {"gyroid": gyroid_volume}


def mc_tables(n_passes: int, seed: int, device) -> torch.Tensor:
    """(P, T, 4) float32 MC tables (generators.clj:8-16): uniform
    components in [-1, 1), each row scaled by 1/sqrt of its sum of
    squares, drawn on `device` from `seed` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    v = torch.rand((n_passes, T_LEN, 4), generator=gen, device=device) * 2.0 - 1.0
    sq = v * v
    s = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    return (v * (1.0 / torch.sqrt(s))[..., None]).contiguous()


def pass_times(n_passes: int) -> torch.Tensor:
    """Each pass's time, p * 0.333 in float32 (core.clj:105)."""
    return torch.arange(n_passes, dtype=torch.float32) * TIME_STEP


def compute_eyepos(theta, dist, y) -> np.ndarray:
    """Orbit camera: (0, y, dist) rotated about +y by theta degrees
    (core.clj:150-152), float32."""
    a = math.radians(theta)
    return np.array([dist * math.sin(a), y, dist * math.cos(a)], dtype=np.float32)


def camera_ring(camera: dict, seed: int) -> np.ndarray:
    """The turntable's eye positions, (poses, 3) float32: theta_k = theta0 +
    360 k / poses degrees, theta0 drawn from the seed, at the camera's
    distance and height."""
    theta0 = rng(seed, "ring").uniform(0.0, 360.0)
    poses = int(camera["poses"])
    return np.stack([compute_eyepos(theta0 + 360.0 * k / poses, camera["dist"], camera["y"])
                     for k in range(poses)])


def check_pixels(seed: int, n_frames: int, n_pixels: int, per_frame: int) -> torch.Tensor:
    """(n_frames, per_frame) int64 distinct pixel ids of each checked
    frame, drawn from the seed."""
    r = rng(seed, "pixels")
    k = min(per_frame, n_pixels)
    return torch.tensor([sorted(r.sample(range(n_pixels), k)) for _ in range(n_frames)],
                        dtype=torch.int64)
