"""K1: tonemap + ARGB pack (reference: renderer.cl:496-508).

Replaces the TPU kernel `raymarchcl_tpu/ops/kernels/tonemap_pallas.py`
(`tonemap_pack_pallas`) and the jnp pack of `ops/render.py:pack_argb`.
CUDA source: csrc/tonemap.cu (what bounds it on the H100 is noted there).
On the main path the same pack is the epilogue of K2's frame launch
(`render_pass.render_passes(..., argb=...)`, counted in `render_pass.PACKS`);
this kernel packs an accum on its own (`render.pack_argb`).

Packed pixels are returned as an int32 tensor holding the uint32 bits
0xAARRGGBB (torch has few uint32 ops); `.numpy().view(np.uint32)` reads them.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches by tonemap_pack (plain-version calls excluded)


def tonemap(col, g):
    """(col / (g + col))^2 (renderer.cl:448-454)."""
    c = col / (g + col)
    return c * c


def tonemap_pack_plain(accum: torch.Tensor, gamma) -> torch.Tensor:
    """Plain version: accum (N, 3) float32 -> (N,) int32 ARGB bits, clamped
    before the cast and NaN -> 0 as XLA's convert gives."""
    t = torch.clamp(tonemap(accum, gamma) * 255.0, 0.0, 255.0)
    c = torch.nan_to_num(t, nan=0.0).long()  # in [0, 255]: truncation
    packed = 0xFF000000 | (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    return ((packed ^ 0x80000000) - 0x80000000).int()  # uint32 bits as int32


def tonemap_pack(accum: torch.Tensor, gamma) -> torch.Tensor:
    """Tonemap + pack. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if accum.dtype != torch.float32 or accum.dim() != 2 or accum.shape[1] != 3:
        raise ValueError(f"accum must be (N, 3) float32, got {tuple(accum.shape)} {accum.dtype}")
    if not accum.is_contiguous():
        raise ValueError("accum must be contiguous")
    if accum.device.type == "cpu":
        return tonemap_pack_plain(accum, gamma)
    if accum.device.type != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    global LAUNCHES
    n = accum.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=accum.device)
    lib = build.library()
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rmcl_tonemap_pack(accum.data_ptr(), out.data_ptr(), float(gamma), n, stream)
    build.check(rc, "rmcl_tonemap_pack")
    LAUNCHES += 1
    return out
