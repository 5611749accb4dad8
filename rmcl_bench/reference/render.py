"""The frame's passes blended in order (renderer.cl:478-494,
`pixels = mix(pixels, col*exposure, frameBlend)` from a zeroed buffer) and
the tonemap and ARGB pack (renderer.cl:448-454, 496-508), for a sample of
pixels of several frames at once."""

from __future__ import annotations

import torch

from .camera import camera_ray_lookat
from .sampling import Lanes, init_render_state
from .shade import scene_color
from .vecmath import V3, fma


def tonemap_pack(accum: torch.Tensor, gamma) -> torch.Tensor:
    """(N, 3) float32 -> (N,) int64 0xAARRGGBB: ((c / (g + c))^2 * 255)
    clamped to [0, 255], NaN -> 0, truncated."""
    c = accum / (gamma + accum)
    t = torch.clamp(c * c * 255.0, 0.0, 255.0)
    c = torch.nan_to_num(t, nan=0.0).long()
    return 0xFF000000 | (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]


def pass_colors(vol, opts, tables, times, eyes, ids) -> torch.Tensor:
    """The colour times exposure of every (frame, pixel, pass) lane.

    vol: flat uint8 volume; tables: (P, T, 4) float32 MC tables; times: (P,)
    float32 pass times; eyes: (F, 3) float32 eye positions; ids: (F, S)
    int64 pixel ids of frame f. Returns (F, S, P, 3) float32."""
    n_frames, n_pix = ids.shape
    n_pass, t_len, _ = tables.shape
    dev = vol.device
    f_idx = torch.arange(n_frames, device=dev)[:, None, None].expand(n_frames, n_pix, n_pass)
    p_idx = torch.arange(n_pass, device=dev)[None, None, :].expand(n_frames, n_pix, n_pass)
    lane_ids = ids.to(dev)[:, :, None].expand(n_frames, n_pix, n_pass).reshape(-1)
    eye = eyes.to(dev, torch.float32)[f_idx.reshape(-1)]
    lanes = Lanes(tables=tables.reshape(-1, 4), base=p_idx.reshape(-1) * t_len,
                  time=times.to(dev, torch.float32)[p_idx.reshape(-1)],
                  eye=V3(eye[:, 0], eye[:, 1], eye[:, 2]), ids=lane_ids)
    state = init_render_state(opts, lanes)
    ray_pos, ray_dir = camera_ray_lookat(opts, state)
    col = scene_color(vol, opts, lanes, state, ray_pos, ray_dir)
    return (col * opts.exposure).to_array().reshape(n_frames, n_pix, n_pass, 3)


def blend(opts, cols: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The passes of each pixel blended in order from zero: (..., P, 3) ->
    (..., 3). In float32 each step is fma(col - accum, frameBlend, accum),
    rounded once; `dtype=torch.bfloat16` keeps the colours and the accum in
    bfloat16, each operation rounded to it (the control)."""
    accum = torch.zeros(cols.shape[:-2] + (3,), dtype=dtype, device=cols.device)
    for p in range(cols.shape[-2]):
        col = cols[..., p, :]
        if dtype == torch.float32:
            accum = fma(col - accum, opts.frameBlend, accum)
        else:
            accum = (col.to(dtype) - accum) * opts.frameBlend.to(dtype) + accum
    return accum.float()


def reference_pixels(vol, opts, tables, times, eyes, ids, block_lanes=1 << 16,
                     dtype=torch.float32):
    """The accum and packed image of pixels `ids` (F, S) of F frames whose
    eye positions are `eyes` (F, 3), all from zeroed accums: (accum (F, S,
    3) float32, argb (F, S) int64). Marched in blocks of about
    `block_lanes` lanes, so that it fits beside anything."""
    n_frames, n_pix = ids.shape
    n_pass = tables.shape[0]
    per = max(1, block_lanes // (n_frames * n_pass))
    accs = []
    for s0 in range(0, n_pix, per):
        cols = pass_colors(vol, opts, tables, times, eyes, ids[:, s0:s0 + per])
        accs.append(blend(opts, cols, dtype))
    accum = torch.cat(accs, dim=1)
    argb = tonemap_pack(accum.reshape(-1, 3), opts.gamma).reshape(n_frames, n_pix)
    return accum, argb
