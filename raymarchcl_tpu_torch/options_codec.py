"""Binary codec for the TRenderOpts device struct layout.

Counterpart of `raymarchcl_tpu/options_codec.py`. The reference marshals
its option map into an OpenCL-alignment-correct ByteBuffer by parsing the
kernel's own typedefs (core.clj:25-26, 101-106 via thi.ng/structgen). This
module gives that byte layout from the OpenCL 1.2 §6.1.5 alignment rules
(float3 occupies 16 bytes and aligns to 16, float4/int4 16, int2 8,
scalars their own size; the struct size rounds up to the largest member
alignment), so RenderOpts values can be written to / read from the exact
bytes the reference kernel would consume (TRenderOpts fields:
resources/renderer.cl:35-78; TMaterial: :14-19). `encode` gives the JAX
package's bytes for the same `render_options(...)` call.

A compatibility/verification artifact: the renderer itself takes
RenderOpts (whose float fields are float32 CPU tensors, read here with
`float()` and `np.asarray`).
"""

from __future__ import annotations

import struct as _struct

import numpy as np

# (name, kind, count) in declaration order — renderer.cl:35-78.
# kinds: f3 (float3: 12 bytes data, 16 size/align), f4, i4, i2, f, i, uc
TRENDEROPTS_FIELDS = [
    ("eyePos", "f3", 1),
    ("targetPos", "f3", 1),
    ("up", "f3", 1),
    ("voxelBounds", "f3", 1),
    ("voxelBounds2", "f3", 1),
    ("voxelBoundsMin", "f3", 1),
    ("voxelBoundsMax", "f3", 1),
    ("invVoxelScale", "f3", 1),
    ("skyColor1", "f3", 1),
    ("skyColor2", "f3", 1),
    ("voxelRes", "i4", 1),
    ("resolution", "i2", 1),
    ("invAspect", "f", 1),
    ("time", "f", 1),
    ("fov", "f", 1),
    ("maxIter", "i", 1),
    ("maxVoxelIter", "i", 1),
    ("maxDist", "f", 1),
    ("startDist", "f", 1),
    ("eps", "f", 1),
    ("aoIter", "i", 1),
    ("aoStepDist", "f", 1),
    ("aoAmp", "f", 1),
    ("voxelSize", "f", 1),
    ("groundY", "f", 1),
    ("shadowIter", "i", 1),
    ("reflectIter", "i", 1),
    ("shadowBias", "f", 1),
    ("lightScatter", "f", 1),
    ("minLightAtt", "f", 1),
    ("gamma", "f", 1),
    ("exposure", "f", 1),
    ("dof", "f", 1),
    ("frameBlend", "f", 1),
    ("fogPow", "f", 1),
    ("flareAmp", "f", 1),
    ("mcTableLength", "i", 1),
    ("isoVal", "uc", 1),
    ("numLights", "uc", 1),
    ("lightPos", "f4", 4),
    ("lightColor", "f4", 4),
    ("materials", "mat", 4),  # TMaterial: float4 albedo, float r0, float smoothness, float2 dummy
]

_ALIGN = {"f3": 16, "f4": 16, "i4": 16, "i2": 8, "f": 4, "i": 4, "uc": 1, "mat": 16}
_SIZE = {"f3": 16, "f4": 16, "i4": 16, "i2": 8, "f": 4, "i": 4, "uc": 1, "mat": 32}


def _align(off, a):
    return (off + a - 1) // a * a


def layout():
    """[(name, kind, count, offset)] + total struct size."""
    out = []
    off = 0
    max_a = 1
    for name, kind, count in TRENDEROPTS_FIELDS:
        a = _ALIGN[kind]
        max_a = max(max_a, a)
        off = _align(off, a)
        out.append((name, kind, count, off))
        off += _SIZE[kind] * count
    return out, _align(off, max_a)


def struct_size():
    return layout()[1]


def encode(opts) -> bytes:
    """RenderOpts -> TRenderOpts bytes (little-endian device layout)."""
    fields, size = layout()
    buf = bytearray(size)

    def f32s(off, vals):
        _struct.pack_into(f"<{len(vals)}f", buf, off, *[float(v) for v in vals])

    def i32s(off, vals):
        _struct.pack_into(f"<{len(vals)}i", buf, off, *[int(v) for v in vals])

    vals3 = lambda v: list(np.asarray(v, np.float32).reshape(-1))[:3]
    for name, kind, count, off in fields:
        if name == "materials":
            for m in range(4):
                base = off + m * 32
                f32s(base, list(np.asarray(opts.mat_albedo[m]).reshape(-1))[:4])
                f32s(base + 16, [float(opts.mat_r0[m])])
                f32s(base + 20, [float(opts.mat_smoothness[m])])
                # float2 dummy stays zero
            continue
        v = getattr(opts, name)
        if kind == "f3":
            f32s(off, vals3(v))
        elif kind == "f4":
            a = np.asarray(v, np.float32).reshape(count, 4)
            for r in range(count):
                f32s(off + r * 16, list(a[r]))
        elif kind == "i4":
            i32s(off, list(v)[:4])
        elif kind == "i2":
            i32s(off, list(v)[:2])
        elif kind == "f":
            f32s(off, [float(v)])
        elif kind == "i":
            i32s(off, [int(v)])
        elif kind == "uc":
            buf[off] = int(v) & 0xFF
    return bytes(buf)


def decode(data: bytes) -> dict:
    """TRenderOpts bytes -> plain dict (for round-trip verification)."""
    fields, size = layout()
    if len(data) < size:
        raise ValueError(f"need {size} bytes, got {len(data)}")
    out = {}
    for name, kind, count, off in fields:
        if name == "materials":
            mats = []
            for m in range(4):
                base = off + m * 32
                albedo = _struct.unpack_from("<4f", data, base)
                r0, smooth = _struct.unpack_from("<2f", data, base + 16)
                mats.append({"albedo": list(albedo), "r0": r0, "smoothness": smooth})
            out[name] = mats
        elif kind == "f3":
            out[name] = list(_struct.unpack_from("<3f", data, off))
        elif kind == "f4":
            out[name] = [
                list(_struct.unpack_from("<4f", data, off + r * 16)) for r in range(count)
            ]
        elif kind == "i4":
            out[name] = list(_struct.unpack_from("<4i", data, off))
        elif kind == "i2":
            out[name] = list(_struct.unpack_from("<2i", data, off))
        elif kind == "f":
            (out[name],) = _struct.unpack_from("<f", data, off)
        elif kind == "i":
            (out[name],) = _struct.unpack_from("<i", data, off)
        elif kind == "uc":
            out[name] = data[off]
    return out
