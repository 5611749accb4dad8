"""Render options: the flat config that drives the renderer.

PyTorch counterpart of `raymarchcl_tpu/options.py` (the reference's
`TRenderOpts` struct, renderer.cl:35-78, filled by core.clj:28-74). Static
fields (shapes, loop budgets, structural geometry) are python ints/tuples;
the per-frame / per-pass fields are float32 tensors on the CPU. A 0-d CPU
tensor combines with tensors on any device, so the plain renderer reads the
fields directly and the CUDA wrapper packs them into its parameter block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .materials import get_preset

MC_TABLE_LENGTH = 0x4000  # reference: core.clj:138 (16384 float4 samples)

# float32 fields, in declaration order (shapes in the RenderOpts comments)
DYNAMIC_FIELDS = (
    "eyePos", "targetPos", "up", "skyColor1", "skyColor2", "invAspect", "time",
    "fov", "maxDist", "startDist", "eps", "aoAmp", "groundY", "shadowBias",
    "lightScatter", "minLightAtt", "gamma", "exposure", "dof", "frameBlend",
    "fogPow", "flareAmp", "lightPos", "lightColor", "mat_albedo", "mat_r0",
    "mat_smoothness",
)


def f32(x) -> torch.Tensor:
    """float32 CPU tensor of a python / numpy value (rounded as numpy does)."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class RenderOpts:
    """TRenderOpts parity (reference: renderer.cl:35-78)."""

    # --- static configuration ---
    resolution: Tuple[int, int]  # (w, h)
    voxelRes: Tuple[int, int, int, int]  # (rx, ry, rz, rx*ry)
    maxIter: int
    maxVoxelIter: int
    shadowIter: int
    aoIter: int
    reflectIter: int
    numLights: int
    isoVal: int
    mcTableLength: int
    voxelBounds: Tuple[float, float, float]
    voxelBounds2: Tuple[float, float, float]
    voxelBoundsMin: Tuple[float, float, float]
    voxelBoundsMax: Tuple[float, float, float]
    invVoxelScale: Tuple[float, float, float]
    aoStepDist: float
    voxelSize: float

    # --- dynamic parameters (float32 CPU tensors) ---
    eyePos: torch.Tensor  # (3,)
    targetPos: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    skyColor1: torch.Tensor  # (3,)
    skyColor2: torch.Tensor  # (3,)
    invAspect: torch.Tensor  # ()
    time: torch.Tensor  # ()
    fov: torch.Tensor  # ()
    maxDist: torch.Tensor  # ()
    startDist: torch.Tensor  # ()
    eps: torch.Tensor  # ()
    aoAmp: torch.Tensor  # ()
    groundY: torch.Tensor  # ()
    shadowBias: torch.Tensor  # ()
    lightScatter: torch.Tensor  # ()
    minLightAtt: torch.Tensor  # ()
    gamma: torch.Tensor  # ()
    exposure: torch.Tensor  # ()
    dof: torch.Tensor  # ()
    frameBlend: torch.Tensor  # ()
    fogPow: torch.Tensor  # ()
    flareAmp: torch.Tensor  # ()
    lightPos: torch.Tensor  # (4, 4)
    lightColor: torch.Tensor  # (4, 4)
    mat_albedo: torch.Tensor  # (4, 4)
    mat_r0: torch.Tensor  # (4,)
    mat_smoothness: torch.Tensor  # (4,)

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def num_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]

    def replace(self, **changes) -> "RenderOpts":
        """Copy with fields replaced; dynamic fields are coerced to float32."""
        for k in DYNAMIC_FIELDS:
            if k in changes:
                v = changes[k]
                changes[k] = (v.detach().to("cpu", torch.float32)
                              if isinstance(v, torch.Tensor) else f32(v))
        return dataclasses.replace(self, **changes)


def _pad4x4(rows, n=4):
    """Pad a list of <=4 vectors of length <=4 to a (4,4) float32 array."""
    out = np.zeros((n, 4), dtype=np.float32)
    for i, r in enumerate(rows[:n]):
        r = list(r)
        out[i, : len(r)] = r
    return out


def render_options(
    width=640,
    height=360,
    vres=256,
    t=0.0,
    iter=1,
    eyepos=None,
    mat=None,
    fov=None,
    dof=None,
    targetpos=None,
    gamma=None,
    groundY=None,
    voxelSize=None,
    **overrides,
) -> RenderOpts:
    """Build the full option set from sparse kwargs.

    Defaults and derived fields replicate the reference (core.clj:28-74):
    eps=0.005, clip=0.99, frameBlend=1/iter, fov deg->rad, invAspect=h/w,
    voxelRes=[rx,ry,rz,rx*ry], voxelSize=1/rx, then the material preset
    merged on top (unknown preset -> `ao`). `overrides` force any field
    after the preset merge.
    """
    if isinstance(vres, (int, np.integer)):
        vres = [int(vres)] * 3  # core.clj:32
    vres = [int(v) for v in vres]
    eps = 0.005  # core.clj:30
    clip = 0.99  # core.clj:31

    preset = get_preset(mat)

    d = {
        "aoAmp": 0.2,
        "aoIter": 5,
        "aoStepDist": 0.05,
        "dof": dof if dof is not None else 0.001,
        "eps": eps,
        "exposure": 3.5,
        "eyePos": eyepos if eyepos is not None else [2, 0, 2],
        "flareAmp": 0.015,
        "fogPow": 0.05,
        "fov": math.radians(fov if fov is not None else 90),  # core.clj:43
        "frameBlend": 1.0 / iter,  # core.clj:44
        "gamma": gamma if gamma is not None else 1.5,
        "groundY": groundY if groundY is not None else 1.05,
        "invAspect": float(height) / float(width),  # core.clj:47
        "invVoxelScale": [0.5, 0.5, 0.5],
        "isoVal": 32,
        "lightColor": [[50, 50, 50, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]],
        "lightScatter": 0.2,
        "maxDist": 30,
        "maxIter": 128,
        "maxVoxelIter": 192,
        "minLightAtt": 0.0,
        "numLights": 2,
        "reflectIter": 0,
        "resolution": (int(width), int(height)),
        "shadowBias": 0.1,
        "shadowIter": 128,
        "skyColor1": [1.8, 1.8, 1.9],
        "skyColor2": [0.1, 0.1, 0.1],
        "startDist": 0.0,
        "targetPos": targetpos if targetpos is not None else [0, -0.15, 0],
        "time": t,
        "up": [0, 1, 0],
        "voxelBounds": [1, 1, 1],
        "voxelBounds2": [2, 2, 2],
        "voxelBoundsMax": [clip, clip, clip],
        "voxelBoundsMin": [-clip, -clip, -clip],
        "voxelRes": (vres[0], vres[1], vres[2], vres[0] * vres[1]),  # core.clj:72
        "voxelSize": voxelSize if voxelSize is not None else 1.0 / vres[0],  # core.clj:73
        "materials": None,
    }
    d.update(preset)  # preset wins over defaults (core.clj:33/74)
    d.update(overrides)

    mats = d.pop("materials")
    d["mat_albedo"] = _pad4x4([m["albedo"] for m in mats])
    d["mat_r0"] = [m["r0"] for m in mats]
    d["mat_smoothness"] = [m["smoothness"] for m in mats]
    d["lightPos"] = _pad4x4(d["lightPos"])
    d["lightColor"] = _pad4x4(d["lightColor"])

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
        mcTableLength=MC_TABLE_LENGTH,
        voxelBounds=tuple(float(v) for v in d["voxelBounds"]),
        voxelBounds2=tuple(float(v) for v in d["voxelBounds2"]),
        voxelBoundsMin=tuple(float(v) for v in d["voxelBoundsMin"]),
        voxelBoundsMax=tuple(float(v) for v in d["voxelBoundsMax"]),
        invVoxelScale=tuple(float(v) for v in d["invVoxelScale"]),
        aoStepDist=float(d["aoStepDist"]),
        voxelSize=float(d["voxelSize"]),
        **{k: f32(d[k]) for k in DYNAMIC_FIELDS},
    )
