"""Render options from the user-facing values (core.clj:28-74) and the
material presets (materials.clj:3-76).

Static fields are python ints and tuples; the per-frame fields are float32
CPU tensors (0-d or small), which combine with tensors on any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

MC_TABLE_LENGTH = 0x4000  # core.clj:138

PRESETS = {
    "orange-stripes": {  # materials.clj:4-21
        "lightColor": [[28, 18, 8, 0], [8, 18, 28, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]],
        "materials": [
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.1, "smoothness": 0.9},
            {"albedo": [4.9, 0.9, 0.05, 1.0], "r0": 0.01, "smoothness": 0.5},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.01, "smoothness": 0.4},
            {"albedo": [0.9, 0.9, 0.9, 1.0], "r0": 0.8, "smoothness": 0.1},
        ],
        "numLights": 2, "aoAmp": 0.25, "reflectIter": 1,
    },
    "metal": {  # materials.clj:23-40
        "lightColor": [[28, 18, 8, 0], [16, 36, 56, 0]],
        "lightPos": [[0, 2, 0, 0], [3, 0, 3, 0]],
        "materials": [
            {"albedo": [0.01, 0.01, 0.01, 1.0], "r0": 0.1, "smoothness": 0.5},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.1, "smoothness": 0.5},
            {"albedo": [0.25, 0.27, 0.5, 1.0], "r0": 0.7, "smoothness": 0.1},
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.2, "smoothness": 0.1},
        ],
        "numLights": 2, "aoAmp": 0.25, "reflectIter": 3,
    },
    "metal2": {  # materials.clj:42-58
        "lightColor": [[28, 18, 8, 0], [8, 18, 28, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]],
        "materials": [
            {"albedo": [0.0, 0.0, 0.0, 1.0], "r0": 0.1, "smoothness": 0.9},
            {"albedo": [1.0, 1.01, 1.075, 1.0], "r0": 0.4, "smoothness": 0.7},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.4, "smoothness": 0.5},
            {"albedo": [0.9, 0.9, 0.9, 1.0], "r0": 0.75, "smoothness": 0.2},
        ],
        "numLights": 2, "aoAmp": 0.25, "reflectIter": 3,
    },
    "ao": {  # materials.clj:60-76
        "lightColor": [[50, 50, 50, 0]],
        "materials": [{"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.0, "smoothness": 1.0}] * 4,
        "numLights": 1, "aoAmp": 0.25, "reflectIter": 0,
    },
}

DYNAMIC_FIELDS = (
    "targetPos", "up", "skyColor1", "skyColor2", "invAspect", "fov", "maxDist",
    "startDist", "eps", "aoAmp", "groundY", "shadowBias", "lightScatter", "minLightAtt",
    "gamma", "exposure", "dof", "frameBlend", "fogPow", "flareAmp", "lightPos",
    "lightColor", "mat_albedo", "mat_r0", "mat_smoothness",
)


def f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class Opts:
    """The frame-level options (renderer.cl:35-78 TRenderOpts). The eye
    position and the pass time are per lane (`sampling.Lanes`)."""

    resolution: Tuple[int, int]
    voxelRes: Tuple[int, int, int, int]
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
    targetPos: torch.Tensor
    up: torch.Tensor
    skyColor1: torch.Tensor
    skyColor2: torch.Tensor
    invAspect: torch.Tensor
    fov: torch.Tensor
    maxDist: torch.Tensor
    startDist: torch.Tensor
    eps: torch.Tensor
    aoAmp: torch.Tensor
    groundY: torch.Tensor
    shadowBias: torch.Tensor
    lightScatter: torch.Tensor
    minLightAtt: torch.Tensor
    gamma: torch.Tensor
    exposure: torch.Tensor
    dof: torch.Tensor
    frameBlend: torch.Tensor
    fogPow: torch.Tensor
    flareAmp: torch.Tensor
    lightPos: torch.Tensor
    lightColor: torch.Tensor
    mat_albedo: torch.Tensor
    mat_r0: torch.Tensor
    mat_smoothness: torch.Tensor

    @property
    def num_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]


def _pad4x4(rows):
    out = np.zeros((4, 4), dtype=np.float32)
    for i, r in enumerate(rows[:4]):
        r = list(r)
        out[i, : len(r)] = r
    return out


def frame_options(width, height, vres, iter, mat, fov=None, dof=None, targetpos=None,
                  **overrides) -> Opts:
    """core.clj:28-74: the defaults, then the preset (unknown -> `ao`),
    then `overrides`; fov in degrees (a linear view-plane scale),
    frameBlend = 1/iter, invAspect = h/w, voxelSize = 1/rx."""
    vres = [int(vres)] * 3 if isinstance(vres, (int, np.integer)) else [int(v) for v in vres]
    clip = 0.99
    d = {
        "aoAmp": 0.2, "aoIter": 5, "aoStepDist": 0.05,
        "dof": dof if dof is not None else 0.001, "eps": 0.005, "exposure": 3.5,
        "flareAmp": 0.015, "fogPow": 0.05,
        "fov": math.radians(fov if fov is not None else 90),
        "frameBlend": 1.0 / iter, "gamma": 1.5, "groundY": 1.05,
        "invAspect": float(height) / float(width), "invVoxelScale": [0.5, 0.5, 0.5],
        "isoVal": 32, "lightColor": [[50, 50, 50, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]], "lightScatter": 0.2, "maxDist": 30,
        "maxIter": 128, "maxVoxelIter": 192, "minLightAtt": 0.0, "numLights": 2,
        "reflectIter": 0, "shadowBias": 0.1, "shadowIter": 128,
        "skyColor1": [1.8, 1.8, 1.9], "skyColor2": [0.1, 0.1, 0.1], "startDist": 0.0,
        "targetPos": targetpos if targetpos is not None else [0, -0.15, 0],
        "up": [0, 1, 0], "voxelBounds": [1, 1, 1], "voxelBounds2": [2, 2, 2],
        "voxelBoundsMax": [clip] * 3, "voxelBoundsMin": [-clip] * 3,
        "voxelSize": 1.0 / vres[0], "materials": None,
    }
    d.update(PRESETS.get(mat, PRESETS["ao"]))
    d.update(overrides)
    mats = d.pop("materials")
    d["mat_albedo"] = _pad4x4([m["albedo"] for m in mats])
    d["mat_r0"] = [m["r0"] for m in mats]
    d["mat_smoothness"] = [m["smoothness"] for m in mats]
    d["lightPos"] = _pad4x4(d["lightPos"])
    d["lightColor"] = _pad4x4(d["lightColor"])
    return Opts(
        resolution=(int(width), int(height)),
        voxelRes=(vres[0], vres[1], vres[2], vres[0] * vres[1]),
        maxIter=int(d["maxIter"]), maxVoxelIter=int(d["maxVoxelIter"]),
        shadowIter=int(d["shadowIter"]), aoIter=int(d["aoIter"]),
        reflectIter=int(d["reflectIter"]), numLights=int(d["numLights"]),
        isoVal=int(d["isoVal"]), mcTableLength=MC_TABLE_LENGTH,
        **{k: tuple(float(v) for v in d[k]) for k in
           ("voxelBounds", "voxelBounds2", "voxelBoundsMin", "voxelBoundsMax",
            "invVoxelScale")},
        aoStepDist=float(d["aoStepDist"]), voxelSize=float(d["voxelSize"]),
        **{k: f32(d[k]) for k in DYNAMIC_FIELDS},
    )

