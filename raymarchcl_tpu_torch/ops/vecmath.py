"""3-vectors as triples of same-shaped tensors, and the scalar helpers the
renderer shares with its CUDA kernel.

Counterpart of `raymarchcl_tpu/ops/vecmath.py`. Two conventions here are
the contract the CUDA kernel (csrc/rmcl_common.cuh) follows op for op:

* `fma(a, b, c)` is a fused multiply-add, rounded once. XLA:CPU contracts
  `a*b + c` into an FMA inside a fusion, and the kernel is built with
  `--fmad=false`, so both sides fuse exactly where this module says so:
  at the sites that feed a discontinuity (seeds, march sample positions,
  ray positions, dot products, bounce directions).
* A division by a constant is a product with its float32 reciprocal, as
  XLA:CPU compiles `x / c`, with the scalar factors multiplied first where
  XLA multiplies them first (`camera.view_coords`, the AO factor of
  `shade.ambient_occlusion`). No tensor is divided by a host scalar:
  PyTorch divides on the CPU but multiplies by the reciprocal on a CUDA
  device, so such a quotient would differ by an ulp between the plain
  version on the card and its kernel.
* `normalize` divides by `sqrt` (one IEEE rounding each). XLA:CPU's
  `rsqrt` is an estimate specific to the host CPU, up to 2 ulp off
  `1/sqrt`; the port does not copy it, so ray directions stay within 2 ulp
  of the JAX package's, inside the render tolerances.
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
    """float32 fused multiply-add a*b + c, rounded once.

    The float64 product of two float32 values is exact; the float64 sum then
    rounds twice (to 53 bits, then 24), which differs from one rounding only
    when the first lands exactly on a float32 tie (never seen in practice)."""
    out = _f64(a) * _f64(b) + _f64(c)
    return out.float()


def fma3(a: V3, s, c: V3) -> V3:
    """Componentwise fma(a, s, c) with s a scalar or tensor."""
    return V3(fma(a.x, s, c.x), fma(a.y, s, c.y), fma(a.z, s, c.z))


def dot(a: V3, b: V3):
    """a.x*b.x + a.y*b.y + a.z*b.z with XLA:CPU's contraction:
    fma(az, bz, fma(ax, bx, ay*by))."""
    return fma(a.z, b.z, fma(a.x, b.x, a.y * b.y))


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm(a: V3):
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """Length-normalize; degenerate vectors (|a|^2 <= 1e-24) give +y
    (OpenCL leaves normalize(0) undefined)."""
    n2 = dot(a, a)
    ok = n2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return V3(
        torch.where(ok, a.x * inv, 0.0),
        torch.where(ok, a.y * inv, 1.0),
        torch.where(ok, a.z * inv, 0.0),
    )


def mix(a, b, t):
    """OpenCL mix(): a + (b - a) * t. Works on tensors and V3."""
    return a + (b - a) * t


def reflect(v: V3, n: V3) -> V3:
    """reflect() (reference: renderer.cl:271-273)."""
    return v - n * (2.0 * dot(v, n))


def reflect_fused(v: V3, n: V3) -> V3:
    """reflect() as XLA:CPU contracts it where the result feeds a march (the
    bounce directions): each component is fma(-n, 2*dot(v, n), v), and the
    x component's dot is fma(vz, nz, fma(vy, ny, vx*nx)), its own order
    (the y and z components take `dot`'s). Read off XLA:CPU's machine code
    and bit-equal to the JAX package's bounce directions."""
    s = 2.0 * dot(v, n)
    sx = 2.0 * fma(v.z, n.z, fma(v.y, n.y, v.x * n.x))
    return V3(fma(-n.x, sx, v.x), fma(-n.y, s, v.y), fma(-n.z, s, v.z))


def where3(mask, a: V3, b: V3) -> V3:
    """Per-lane select between two V3s."""
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def f2i_sat(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 value as XLA (and CUDA `__float2int_rz`) convert it:
    truncate toward zero, saturate to the int32 range, NaN -> 0. Torch's own
    cast gives INT_MIN for both NaN and out-of-range input. Returns int64."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return x.clamp(-2147483648.0, 2147483647.0).trunc().long()
