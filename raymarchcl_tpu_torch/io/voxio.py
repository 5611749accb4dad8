"""`.vox` volume file format, byte-compatible with the reference.

Format (reference: src/thi/ng/raymarchcl/io.clj:9-17):
    bytes 0-4   magic "VOXEL"
    3 x int32   big-endian resx, resy, resz (Java DataOutputStream)
    1 x uint8   element size in bytes (always 1)
    raw voxels  resx*resy*resz bytes, index = z*(rx*ry) + y*rx + x
"""

from __future__ import annotations

import struct as _struct

import numpy as np

MAGIC = b"VOXEL"


def save_volume(path, res, voxels: np.ndarray) -> None:
    """Write a volume; `res` is an int (cubic) or an (rx, ry, rz) triple."""
    if isinstance(res, (int, np.integer)):
        res = (int(res),) * 3
    rx, ry, rz = (int(r) for r in res)
    voxels = np.ascontiguousarray(voxels, dtype=np.uint8).reshape(-1)
    if voxels.size != rx * ry * rz:
        raise ValueError(f"volume size {voxels.size} != {rx}*{ry}*{rz}")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_struct.pack(">iii", rx, ry, rz))  # big-endian, io.clj:13-15
        f.write(_struct.pack("B", 1))  # element size
        f.write(voxels.tobytes())


def load_volume(path):
    """Read a volume -> (voxels uint8 flat array, (rx, ry, rz))."""
    with open(path, "rb") as f:
        magic = f.read(5)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}, expected {MAGIC!r}")
        rx, ry, rz = _struct.unpack(">iii", f.read(12))
        (elem_size,) = _struct.unpack("B", f.read(1))
        if elem_size != 1:
            raise ValueError(f"{path}: unsupported element size {elem_size}")
        n = rx * ry * rz
        voxels = np.frombuffer(f.read(n), dtype=np.uint8)
        if voxels.size != n:
            raise ValueError(f"{path}: truncated volume ({voxels.size}/{n} bytes)")
    return voxels, (rx, ry, rz)
