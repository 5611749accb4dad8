"""A voxelized mesh (BASELINE config 3; meshvoxel.clj:12-23, 45-58): the
configuration's `volume` names an STL file (`stl`, relative to the
checkout's root), the grid edge (`vres`) and the cube half-width (`ks`).

The volume is the program's: `models.mesh.read_stl`, then
`models.mesh.voxelize_ks`. The harness's `correct` renders the reference
from the volume this returns, so a fault of the program's voxelizer would
pass unseen there; here, before any frame, the volume is held byte-equal
to the benchmark's own voxelizer (`reference/mesh.py`), and a difference
stops the run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rmcl_bench.reference import mesh as reference_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make(volume_cfg: dict, device) -> torch.Tensor:
    """The flat uint8 vres^3 volume on `device`; ValueError, naming how many
    voxels differ, where the program's volume is not the reference's."""
    from raymarchcl_tpu_torch.models import mesh

    path = os.path.join(ROOT, volume_cfg["stl"])
    vres, ks = int(volume_cfg["vres"]), int(volume_cfg["ks"])
    vol = mesh.voxelize_ks(mesh.read_stl(path), vres, ks)
    want = reference_mesh.voxelize_ks(reference_mesh.read_stl(path), vres, ks)
    if vol.dtype != np.uint8 or vol.shape != want.shape:
        raise ValueError(f"stl_ks: the program's volume is {vol.dtype} {vol.shape}, "
                         f"the reference's {want.dtype} {want.shape}")
    differ = int(np.count_nonzero(vol != want))
    if differ:
        raise ValueError(f"stl_ks: {differ} of {want.size} voxels of the program's "
                         f"voxelize_ks({volume_cfg['stl']}, {vres}, {ks}) differ from the "
                         "reference's")
    return torch.from_numpy(vol).to(device)
