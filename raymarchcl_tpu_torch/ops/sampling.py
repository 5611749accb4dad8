"""Monte-Carlo sample tables and per-pixel jitter state.

Counterpart of `raymarchcl_tpu/ops/sampling.py` (reference:
generators.clj:8-16 table; renderer.cl:142-144 `randFloat4`;
renderer.cl:467-476 per-pixel state). The tables are the renderer's only
randomness. They reproduce the JAX package's bits exactly: jax's threefry2x32
`PRNGKey` / `split` / `uniform` (with `jax_threefry_partitionable=True`, the
default of jax 0.9) written out in numpy uint32 arithmetic, then the same
row normalization.

uint32 values (seeds) live in int64 tensors masked to 32 bits: torch has no
uint32 add or shift on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import MC_TABLE_LENGTH
from .vecmath import V3, f2i_sat, fma, normalize

U32_MASK = 0xFFFFFFFF

# --- threefry2x32 (jax._src.prng), numpy uint32 -----------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2); all uint32, x1/x2 arrays of one shape."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1 = np.asarray(x1, np.uint32) + ks[0]
    x2 = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3]) + np.uint32(i + 1)
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for an int32 seed: (2,) uint32 [0, seed]."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return np.array([0, seed & U32_MASK], np.uint32)


def _hash_iota(key, n):
    """threefry of the 64-bit iota 0..n-1 split into (hi, lo) words."""
    hi = np.zeros(n, np.uint32)
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key, num: int) -> np.ndarray:
    """jax.random.split(key, num) -> (num, 2) uint32 keys."""
    b1, b2 = _hash_iota(key, num)
    return np.stack([b1, b2], axis=1)


def uniform(key, shape, minval=-1.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    n = int(np.prod(shape))
    b1, b2 = _hash_iota(key, n)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(shape)


def generate_scatter_offsets(num=MC_TABLE_LENGTH, seed=0, key=None) -> np.ndarray:
    """(num, 4) float32 table of normalized 4-vectors (generators.clj:8-16):
    uniform components in [-1, 1), each row scaled by 1/sqrt of its sum of
    squares (summed left to right, as XLA reduces it)."""
    if key is None:
        key = prng_key(seed)
    v = uniform(key, (num, 4))
    sq = v * v
    s = ((sq[:, 0] + sq[:, 1]) + sq[:, 2]) + sq[:, 3]
    m = np.float32(1.0) / np.sqrt(s)
    return v * m[:, None]


def make_mc_tables(n_passes, seed=0, device="cpu") -> torch.Tensor:
    """Stacked per-pass tables, float32 (n_passes, T, 4) on `device`
    (core.clj:137-138); bit-equal to the JAX package's tables."""
    keys = split(prng_key(seed), n_passes)
    tabs = np.stack([generate_scatter_offsets(key=k) for k in keys])
    return torch.from_numpy(tabs).to(device)


# --- per-pixel state ----------------------------------------------------------


def f2u32(x) -> torch.Tensor:
    """C-style (uint)(float_expr) cast as the JAX package performs it: via
    int32 with truncation, saturation and NaN -> 0, then reinterpreted as
    uint32 (int64 tensor in [0, 2**32))."""
    return f2i_sat(torch.as_tensor(x, dtype=torch.float32)) & U32_MASK


def table_index(seed: torch.Tensor) -> torch.Tensor:
    """renderer.cl:142-144: seed & 0x3fff."""
    return seed & 0x3FFF


def rand_float4(table, seed):
    """table[seed & 0x3fff] -> (x, y, z, w). table: (T, 4) float32."""
    row = table[table_index(seed)]
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3]


def rand_xyz(table, seed) -> V3:
    x, y, z, _ = rand_float4(table, seed)
    return V3(x, y, z)


def init_render_state(opts, table, ids):
    """Per-pixel jitter state (renderer.cl:467-476). ids: int64 flat pixel
    ids. Returns dict px, py (jittered pixel coords), mc_normal V3, eye_pos
    V3 (DOF offset)."""
    w = opts.resolution[0]
    pix_x = (ids % w).float()
    pix_y = torch.div(ids, w, rounding_mode="floor").float()
    t = opts.time
    # (uint)(id*17) + (uint)(time*3141.3862f) etc. (renderer.cl:471-472)
    seed_pos = ((ids * 17) + f2u32(t * 3141.3862)) & U32_MASK
    seed_nrm = ((ids * 37) + f2u32(t * 1859.1467)) & U32_MASK
    _, _, pz, pw = rand_float4(table, seed_pos)
    mc_normal = normalize(rand_xyz(table, seed_nrm))
    px = pix_x + pz  # subpixel jitter (renderer.cl:473)
    py = pix_y + pw
    # DOF: eyePos += mcNormal.zxy * dof (renderer.cl:474)
    eye = V3(
        fma(mc_normal.z, opts.dof, opts.eyePos[0]),
        fma(mc_normal.x, opts.dof, opts.eyePos[1]),
        fma(mc_normal.y, opts.dof, opts.eyePos[2]),
    )
    return {"px": px, "py": py, "mc_normal": mc_normal, "eye_pos": eye}


def light_seed(opts, px, py):
    """Jittered light-position seed (renderer.cl:267), shared by all
    lights of a pixel."""
    return f2u32(fma(px, 1957.0, py * 2173.0) + opts.time * 4763.742)


def ao_seed(opts, pos: V3):
    """AO scatter seed from world position (renderer.cl:334)."""
    s = fma(pos.z, 2945.87, fma(pos.x, 3183.75, pos.y * 1831.42))
    return f2u32(s + opts.time * 2671.918)
