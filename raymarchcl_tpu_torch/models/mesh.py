"""Mesh -> voxel volume: STL loading, grid fitting, three voxelizers, and
heightmap volumes, in numpy on the host.

Counterpart of `raymarchcl_tpu/models/mesh.py` (reference:
src/thi/ng/raymarchcl/meshvoxel.clj + the used surface of thi.ng/geom's STL
reader). The voxelizers stamp mesh vertices (the reference never
rasterizes faces). Only the numpy paths are ported: the JAX package's
optional C++ path is held byte-equal to them, so these volumes equal the
JAX package's whichever path it takes.

Integer arithmetic stays in numpy: the scatter draws rely on uint64
wrap-around, and `np.unique(v, axis=0)` fixes the vertex order that the
counter-based draws are indexed by.

Orientation quirks preserved: `voxelize`/`voxelize_ks` write z-major
(z*r^2 + y*r + x, meshvoxel.clj:57,68) but `voxelize_scatter` and
`make_heatmap` write Y-major (y*r^2 + z*r + x, meshvoxel.clj:42,82).

The STL read and the three voxelizers run in the spans `rmcl.mesh.read_stl`
and `rmcl.mesh.voxelize`; `LAST_VOXELIZE` holds the last voxelization's
counts.
"""

from __future__ import annotations

import functools
import struct as _struct
import time

import numpy as np

from ..utils.metrics import span

# The last voxelization's host seconds (`read_stl`: the last STL read's;
# `voxelize`), its vertices, its grid edge `res` and its voxels set
# (`occupied`), replaced at each voxelization.
LAST_VOXELIZE: dict = {}
LAST_READ_S = 0.0  # the last read_stl's host seconds


def read_stl(path) -> np.ndarray:
    """Binary or ASCII STL -> unique vertex array (V, 3) float32, sorted
    (the reference voxelizes mesh VERTICES only, meshvoxel.clj:31/51/65)."""
    global LAST_READ_S
    t0 = time.perf_counter()
    with span("rmcl.mesh.read_stl"):
        verts = _read_stl(path)
    LAST_READ_S = time.perf_counter() - t0
    return verts


def _read_stl(path) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if head[:5].lower() == b"solid" and b"facet" in (head + rest[:200]):
        verts = []
        for line in (head + rest).decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        v = np.asarray(verts, dtype=np.float32)
    else:
        (n_tri,) = _struct.unpack("<I", rest[:4])
        body = np.frombuffer(rest[4 : 4 + n_tri * 50], dtype=np.uint8)
        if body.size != n_tri * 50:
            raise ValueError(f"{path}: truncated binary STL")
        tri = body.reshape(n_tri, 50)
        f32 = tri[:, :48].copy().view("<f4").reshape(n_tri, 12)
        v = f32[:, 3:12].reshape(n_tri * 3, 3).astype(np.float32)  # skip normal
    if v.size == 0:
        raise ValueError(f"{path}: no vertices found")
    return np.unique(v, axis=0)


load_mesh = read_stl  # reference name (meshvoxel.clj:12-14)


def _counted(voxelizer):
    """`voxelizer` in the span `rmcl.mesh.voxelize`, its counts put in
    LAST_VOXELIZE."""

    @functools.wraps(voxelizer)
    def counted(vertices, res, *args, **kwargs):
        t0 = time.perf_counter()
        with span("rmcl.mesh.voxelize"):
            vox = voxelizer(vertices, res, *args, **kwargs)
        seconds = time.perf_counter() - t0
        LAST_VOXELIZE.clear()
        LAST_VOXELIZE.update({"seconds": {"read_stl": LAST_READ_S, "voxelize": seconds},
                              "vertices": len(vertices), "res": int(res),
                              "occupied": int(np.count_nonzero(vox))})
        return vox

    return counted


def _scale_params(vertices: np.ndarray, res: int):
    """(off, pmin, scale) of the fit-to-grid transform
    (meshvoxel.clj:16-23): v -> off + (v - pmin) * scale, in float64."""
    p = vertices.min(axis=0).astype(np.float64)
    size = vertices.max(axis=0) - p
    md = float(size.max())
    off = 0.5 * res * (1.0 - size / md)
    return off, p, res / md


def mesh_scale(vertices: np.ndarray, res: int):
    """Fit-to-grid transform (meshvoxel.clj:16-23): the largest extent
    fills `res`, the others are centered. Returns a (V,3) -> (V,3) fn."""
    off, p, s = _scale_params(vertices, res)
    return lambda v: off + (np.asarray(v, np.float64) - p) * s


@_counted
def voxelize(vertices, res) -> np.ndarray:
    """Point-stamp voxelizer (meshvoxel.clj:60-69): one voxel of 255 per
    in-bounds vertex, z-major index."""
    q = mesh_scale(vertices, res)(vertices).astype(np.int64)
    q = q[((q >= 0) & (q < res)).all(axis=1)]
    vox = np.zeros(res * res * res, dtype=np.uint8)
    vox[q[:, 2] * res * res + q[:, 1] * res + q[:, 0]] = 255
    return vox


@_counted
def voxelize_ks(vertices, res, ks) -> np.ndarray:
    """Kernel-size dilation voxelizer (meshvoxel.clj:45-58): a clipped
    (2ks+1)^3 cube of 255 around each vertex, z-major index."""
    q = mesh_scale(vertices, res)(vertices).astype(np.int64)
    vox = np.zeros(res * res * res, dtype=np.uint8)
    rng = np.arange(-ks, ks + 1)
    for dz in rng:
        for dy in rng:
            for dx in rng:
                x, y, z = q[:, 0] + dx, q[:, 1] + dy, q[:, 2] + dz
                m = (x >= 0) & (x < res) & (y >= 0) & (y < res) & (z >= 0) & (z < res)
                vox[z[m] * res * res + y[m] * res + x[m]] = 255
    return vox


def _sm64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays (wrapping arithmetic)."""
    with np.errstate(over="ignore"):  # the wrap is the point (scalar inputs warn)
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _scatter_draws(seed: int, nv: int) -> np.ndarray:
    """(V, 12) float64 draws in [0, 1) for voxelize_scatter, from the
    counter-based stream u(i, d) = sm64(sm64(seed) + i*GOLDEN + d*LEAP)."""
    base = _sm64(np.uint64(np.uint64(seed) & np.uint64(0xFFFFFFFFFFFFFFFF)))
    i = np.arange(nv, dtype=np.uint64)[:, None] * np.uint64(0x9E3779B97F4A7C15)
    d = np.arange(12, dtype=np.uint64)[None, :] * np.uint64(0xD1B54A32D192ED03)
    u = _sm64(base + i + d)
    return (u >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)


@_counted
def voxelize_scatter(vertices, res, seed=0) -> np.ndarray:
    """Randomized scatter/streak voxelizer (meshvoxel.clj:25-43). Per
    vertex: with p=0.25 stamp up to 4 extra displaced copies, each shifted
    -x by a random fraction, -z by a random chunk, +y by 0.4*res, as a 3^3
    block of value 64. Y-MAJOR voxel index (meshvoxel.clj:42). The
    reference's unseeded RNG is an explicit seed here (`_scatter_draws`)."""
    vertices = np.asarray(vertices, np.float32)
    off, pmin, s = _scale_params(vertices, res)
    r2 = res / 2.0
    f = _scatter_draws(seed, vertices.shape[0])
    sv = off + (vertices.astype(np.float64) - pmin) * s
    x0 = np.trunc(sv[:, 0]).astype(np.int64)
    y0 = np.trunc(sv[:, 1]).astype(np.int64)
    z0 = np.trunc(sv[:, 2]).astype(np.int64)
    n = np.where(f[:, 0] < 0.25, np.ceil(5.0 * f[:, 1]).astype(np.int64), 1)
    n = np.maximum(n, 1)
    y = np.trunc(y0 + res * 0.4).astype(np.int64)
    xs, ys, zs = [], [], []
    for k in range(5):
        act = k < n
        if not act.any():
            continue
        dx = np.trunc(f[:, 2 + 2 * k] * ((k / 5.0) * r2)).astype(np.int64)
        x = np.trunc(x0 - dx + res * 0.4).astype(np.int64)
        z = np.maximum(
            z0 - np.trunc(r2 * (0.125 * f[:, 3 + 2 * k] + 0.125)).astype(np.int64), 0)
        xs.append(x[act])
        ys.append(y[act])
        zs.append(z[act])
    X = np.concatenate(xs) if xs else np.zeros(0, np.int64)
    Y = np.concatenate(ys) if ys else np.zeros(0, np.int64)
    Z = np.concatenate(zs) if zs else np.zeros(0, np.int64)
    vox = np.zeros(res * res * res, dtype=np.uint8)
    rxy = res * res
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx_ in (-1, 0, 1):
                xx, yy, zz = X + dx_, Y + dy, Z + dz
                m = ((xx >= 0) & (xx < res) & (yy >= 0) & (yy < res)
                     & (zz >= 0) & (zz < res))
                vox[yy[m] * rxy + zz[m] * res + xx[m]] = 64
    return vox


def make_heatmap(path_or_gray, amp, res=None) -> np.ndarray:
    """Heightmap volume from an image's low byte (meshvoxel.clj:71-83):
    column height h = 0 if c == 0, 2 if c > 224, else max(2, c*amp), the
    float height taken up to the next integer. Y-MAJOR index
    (meshvoxel.clj:82)."""
    if isinstance(path_or_gray, (str, bytes)):
        from ..io.imageio import load_gray

        gray = load_gray(path_or_gray)
    else:
        gray = np.asarray(path_or_gray, dtype=np.uint8)
    if res is None:
        res = gray.shape[1]  # image width (meshvoxel.clj:75)
    c = gray[:res, :res].astype(np.float64)
    h = np.where(c > 0, np.where(c > 224, 2.0, np.maximum(2.0, c * amp)), 0.0)
    h = np.ceil(h).astype(np.int64)  # (range h) on a float h
    vox = np.zeros((res, res, res), dtype=np.uint8)
    hh = np.arange(res)[None, :, None]
    vox[hh < h[:, None, :]] = 255  # vox[y, hh, x] for hh < h[y, x]
    return vox.reshape(-1)


def make_heatmap_anim(path, out_path_fmt, n, res=256):
    """Animated heatmap volume series (meshvoxel.clj:85-89): n `.vox`
    files, frame i at amp i / (n * 1.33333). Returns their paths."""
    from ..io import voxio
    from ..io.imageio import load_gray

    gray = load_gray(path)
    paths = []
    for i in range(n):
        out = out_path_fmt % i
        voxio.save_volume(out, res, make_heatmap(gray, float(i / (n * 1.33333)), res=res))
        paths.append(out)
    return paths
