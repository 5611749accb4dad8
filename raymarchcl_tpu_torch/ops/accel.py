"""Brick table for the fixed-step march: a STOP bitplane and a brick-level
Chebyshev distance per brick, which license exact multi-sample skips.

Counterpart of `raymarchcl_tpu/ops/accel.py` (the `rows` table; its MXU
byte planes and its 12^3 smooth-normal windows are TPU gather workarounds
and are not ported). The rows are the JAX package's word for word, so the
tests can hold the two builds equal and hand one table to both packages.

Row layout, (NB, edge^3/32 + 2) uint32 per edge^3 brick (edge 4/8/16/32),
brick id (bz*NBY + by)*NBX + bx, local bit L = (lz*edge + ly)*edge + lx:

  words [0, dist_w)   STOP bitplane, little-endian: bit L set <=> the voxel
                      stops the march (value > isoVal); padding voxels
                      outside the grid are set
  word dist_w         brick Chebyshev distance D (in bricks, capped at 255)
                      to the nearest brick holding a STOP bit, the outside
                      of the grid counting as stopping
  word dist_w + 1     zero

The march's exactness argument (the JAX module's docstring): two voxels in
bricks at brick-Chebyshev distance D are at voxel-Chebyshev distance
>= edge*D - (edge-1) =: d_equiv, and every voxel of the brick's
(d_equiv - 1)-neighbourhood is in the grid and no hit. Voxel coordinates
truncate f32 products, so a sample i steps ahead lands at most
floor(i*vps) + 2 voxels away per axis (plus far less than a voxel of f32
rounding), which SKIP_SLACK covers: the samples after a landing in a brick
with D >= 2 may be skipped floor((d_equiv - SKIP_SLACK) / vps) at a time
without changing any hit or hit index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.ndimage import distance_transform_cdt

EDGES = (4, 8, 16, 32)

# Safety slack subtracted from d_equiv before converting to skippable
# samples (raymarchcl_tpu/ops/accel.py:105-110): i*vps + 2 + eps <=
# d_equiv - 1  =>  i <= (d_equiv - 3.5) / vps.
SKIP_SLACK = 3.5


def row_words(edge: int) -> int:
    """Words of one brick row: the STOP bitplane, D, and the pad word."""
    if edge not in EDGES:
        raise ValueError(f"brick edge must be one of {EDGES}, got {edge}")
    return edge**3 // 32 + 2


@dataclass(frozen=True)
class Accel:
    """Brick table of one volume.

    rows: (NB, edge^3/32 + 2) int32 tensor holding the uint32 row words.
    edge: the brick edge the table was built at."""

    rows: torch.Tensor
    edge: int = 8

    def __post_init__(self):
        want = row_words(self.edge)
        if self.rows.dtype != torch.int32 or self.rows.dim() != 2 or self.rows.shape[1] != want:
            raise ValueError(f"brick rows must be (NB, {want}) int32 for edge {self.edge}, "
                             f"got {tuple(self.rows.shape)} {self.rows.dtype}")

    @property
    def dist_w(self) -> int:
        """Index of the distance word (the STOP words precede it)."""
        return self.edge**3 // 32


def brick_dims(voxel_res, edge: int = 8):
    """(NBX, NBY, NBZ) brick-grid dims of a voxel resolution."""
    row_words(edge)  # checks the edge
    rx, ry, rz = int(voxel_res[0]), int(voxel_res[1]), int(voxel_res[2])
    return -(-rx // edge), -(-ry // edge), -(-rz // edge)


def chebyshev_from_mask(stop_3d: np.ndarray) -> np.ndarray:
    """Exact Chebyshev distance to {mask} U {outside}, capped at 255, as
    uint8. stop_3d: (Z, Y, X) bool. A zero ring pads the transform, so no
    cell's distance exceeds its distance to the array's boundary."""
    z, y, x = stop_3d.shape
    freep = np.zeros((z + 2, y + 2, x + 2), dtype=np.uint8)
    freep[1:-1, 1:-1, 1:-1] = ~stop_3d
    d = distance_transform_cdt(freep, metric="chessboard")[1:-1, 1:-1, 1:-1]
    return np.minimum(d, 255).astype(np.uint8)


def build_accel(vol, voxel_res, iso_val, edge: int = 8) -> Accel:
    """Brick table of a flat uint8 volume (index z*rx*ry + y*rx + x; numpy
    array or tensor), built on the host. The rows land on the tensor's
    device (the CPU for numpy input)."""
    device = vol.device if isinstance(vol, torch.Tensor) else torch.device("cpu")
    if isinstance(vol, torch.Tensor):
        vol = vol.cpu().numpy()
    rx, ry, rz = int(voxel_res[0]), int(voxel_res[1]), int(voxel_res[2])
    nbx, nby, nbz = brick_dims(voxel_res, edge)
    v = np.asarray(vol, np.uint8).reshape(rz, ry, rx)

    stop = np.ones((nbz * edge, nby * edge, nbx * edge), bool)  # padding stops
    stop[:rz, :ry, :rx] = v > iso_val
    sb = (stop.reshape(nbz, edge, nby, edge, nbx, edge)
          .transpose(0, 2, 4, 1, 3, 5)
          .reshape(-1, edge**3))  # (NB, edge^3), local index L
    occw = np.packbits(sb, axis=1, bitorder="little").view("<u4").astype(np.uint32)

    dist = chebyshev_from_mask(sb.any(axis=1).reshape(nbz, nby, nbx))
    dist_w = edge**3 // 32
    rows = np.zeros((sb.shape[0], dist_w + 2), np.uint32)
    rows[:, :dist_w] = occw
    rows[:, dist_w] = dist.reshape(-1)
    return Accel(torch.from_numpy(rows.view(np.int32)).to(device), edge)


def skips_per_distance(opts, delta):
    """Per-ray multiplier turning a proven voxel-Chebyshev clearance d into
    a safe skip count floor((d - SKIP_SLACK) * inv_vps); vps is the largest
    per-axis voxel advance of one step. Rays that never move (vps == 0) get
    1e30: any clearance proves every later sample free, so skipping past
    the budget is exact."""
    rx, ry, rz, _ = opts.voxelRes
    vps = torch.maximum(delta.x.abs() * float(rx),
                        torch.maximum(delta.y.abs() * float(ry), delta.z.abs() * float(rz)))
    return torch.where(vps > 0, 1.0 / torch.clamp(vps, min=1e-30), 1e30)


def skip_samples(accel: Accel, dist_word, inv_vps):
    """Samples that may be skipped after a landing in a brick at distance
    D = dist_word: floor((edge*D - (edge-1) - SKIP_SLACK) * inv_vps), clipped
    to [0, 2^30] in float32 before the cast (inv_vps may be 1e30). 0 for
    D <= 1. Returns int64."""
    e = accel.edge
    d_equiv = float(e) * dist_word.float() - float(e - 1)
    return torch.clamp((d_equiv - SKIP_SLACK) * inv_vps, 0.0, 2.0**30).long()
