"""A voxelized mesh (thi-ng/raymarchcl meshvoxel.clj): the STL's vertices
(:12-14), fitted to the grid (:16-23) and stamped as cubes (`voxelize-ks`,
:45-58), in plain float64 numpy.

Written from the reference, independently of the program's voxelizers:

- An STL file holds single-precision coordinates (binary records of
  float32; ASCII values are rounded to float32, as the binary format would
  store them). They are held in float64, where every float32 is exact.
- The reference stamps the mesh's *vertices* only; no face is rasterized.
- Fit to grid (`mesh-scale`): the bounding box's largest extent md fills
  `res` and the other axes are centred, v -> (v - pmin) * (res / md) + off
  with off = (res / 2) * (1 - size / md), truncated to integers (`int`).
- `voxelize-ks`: a cube of edge 2 ks + 1 of 255 around each stamped vertex,
  clipped to the grid, z-major index z*res^2 + y*res + x.

Here the cubes are one dilation of the grid of stamped centres: the
centres are marked in a grid padded by ks on each side, each of the
(2 ks + 1)^3 shifts of it is or-ed in, and the padding is cut away.
"""

from __future__ import annotations

import numpy as np

BINARY_RECORD = np.dtype([("normal", "<f4", (3,)), ("vertices", "<f4", (3, 3)),
                          ("attribute", "<u2")])  # 50 bytes a triangle


def read_stl(path) -> np.ndarray:
    """The distinct vertices of an STL file (binary, or ASCII where it opens
    with `solid` and names a facet), (V, 3) float64 in ascending row order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:5].lower() == b"solid" and b"facet" in data[:280]:
        rows = [line.split()[1:] for line in data.decode("ascii", errors="replace").splitlines()
                if len(line.split()) == 4 and line.split()[0] == "vertex"]
        verts = np.array(rows, dtype=np.float64).astype(np.float32)
    else:
        count = int(np.frombuffer(data, "<u4", count=1, offset=80)[0])
        if len(data) < 84 + count * BINARY_RECORD.itemsize:
            raise ValueError(f"{path}: {count} triangles do not fit the file")
        tris = np.frombuffer(data, BINARY_RECORD, count=count, offset=84)
        verts = tris["vertices"].reshape(-1, 3)
    if verts.size == 0:
        raise ValueError(f"{path}: no vertices")
    return np.unique(verts.astype(np.float64), axis=0)


def grid_cells(verts: np.ndarray, res: int) -> np.ndarray:
    """Each vertex's grid cell (meshvoxel.clj:16-23), (V, 3) int64 x, y, z."""
    pmin, pmax = verts.min(axis=0), verts.max(axis=0)
    size = pmax - pmin
    md = size.max()
    off = (res * 0.5) * (1.0 - size / md)
    return ((verts - pmin) * (res / md) + off).astype(np.int64)


def voxelize_ks(verts: np.ndarray, res: int, ks: int) -> np.ndarray:
    """`voxelize-ks` (meshvoxel.clj:45-58): the flat uint8 res^3 volume,
    255 within ks cells (Chebyshev) of a stamped vertex, else 0."""
    cells = grid_cells(verts, res) + ks  # in the padded grid
    span = res + 2 * ks
    cells = cells[((cells >= 0) & (cells < span)).all(axis=1)]  # the rest reach no cell
    centres = np.zeros((span, span, span), dtype=bool)  # [z, y, x]
    centres[cells[:, 2], cells[:, 1], cells[:, 0]] = True
    grid = np.zeros((res, res, res), dtype=bool)
    for dz in range(2 * ks + 1):
        for dy in range(2 * ks + 1):
            for dx in range(2 * ks + 1):
                grid |= centres[dz:dz + res, dy:dy + res, dx:dx + res]
    return np.where(grid, 255, 0).astype(np.uint8).reshape(-1)
