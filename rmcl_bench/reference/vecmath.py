"""3-vectors as triples of same-shaped tensors, and the scalar helpers.

`fma(a, b, c)` is a fused multiply-add rounded once, at the sites where the
renderer fuses (seeds, march sample positions, ray positions, dot
products, bounce directions); a division by a constant is a product with
its float32 reciprocal; `normalize` divides by `sqrt`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def to_array(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.double()
    return float(np.float32(v))  # python constant: round to f32 first


def fma(a, b, c):
    """float32 fused multiply-add a*b + c, rounded once (the float64
    product of two float32 values is exact)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def fma3(a: V3, s, c: V3) -> V3:
    return V3(fma(a.x, s, c.x), fma(a.y, s, c.y), fma(a.z, s, c.z))


def dot(a: V3, b: V3):
    """fma(az, bz, fma(ax, bx, ay*by))."""
    return fma(a.z, b.z, fma(a.x, b.x, a.y * b.y))


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def norm(a: V3):
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """Length-normalize; |a|^2 <= 1e-24 gives +y."""
    n2 = dot(a, a)
    ok = n2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return V3(torch.where(ok, a.x * inv, 0.0), torch.where(ok, a.y * inv, 1.0),
              torch.where(ok, a.z * inv, 0.0))


def mix(a, b, t):
    return a + (b - a) * t


def reflect(v: V3, n: V3) -> V3:
    """renderer.cl:271-273."""
    return v - n * (2.0 * dot(v, n))


def reflect_fused(v: V3, n: V3) -> V3:
    """reflect() where it feeds a bounce march: fma(-n, 2*dot(v, n), v),
    the x component's dot in the order fma(vz, nz, fma(vy, ny, vx*nx))."""
    s = 2.0 * dot(v, n)
    sx = 2.0 * fma(v.z, n.z, fma(v.y, n.y, v.x * n.x))
    return V3(fma(-n.x, sx, v.x), fma(-n.y, s, v.y), fma(-n.z, s, v.z))


def where3(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def f2i_sat(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 value: truncate toward zero, saturate, NaN -> 0.
    Returns int64."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return x.clamp(-2147483648.0, 2147483647.0).trunc().long()
