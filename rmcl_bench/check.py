"""What decides `correct`: sampled pixels of the window's frames against
the plain reference.

The frames the window kept (a reservoir drawn from the seed) are judged
at pixels drawn from the seed: each kept frame's accum rows and packed
image at those pixels, against `reference/` run from the same inputs (the
volume, the MC tables, the frame's eye position and the user-facing
options; the reference derives its own options and marches without the
brick table). Two numbers, each with the cell's limit
(`workloads/<cell>.json` `check.limits`):

  accum_off_pct  % of the sampled accum values (pixel x channel) off by
                 more than ATOL + RTOL * |reference|
  image_off_pct  % of the sampled pixels whose packed ARGB differs

`control=True` judges the control in the program's place: the reference's
colours and blend in bfloat16 (`reference.render.blend`) at the same
pixels. It has to come out not correct.
"""

from __future__ import annotations

import torch

from . import inputs
from .reference.options import frame_options
from .reference.render import reference_pixels

RTOL = ATOL = 1e-4
NUMBERS = ("accum_off_pct", "image_off_pct")


def reference_options(cell):
    """The reference's options of the cell's frames, from the user-facing
    values (the eye position is per lane)."""
    cfg, tr = cell.config, cell.traffic
    cam = tr["camera"]
    return frame_options(tr["width"], tr["height"], cfg["volume"]["vres"], tr["spp"],
                         cfg["mat"], fov=cam.get("fov"), dof=cam.get("dof"),
                         targetpos=cam["target"], **cfg.get("options", {}),
                         **tr.get("budgets", {}))


def judge(cell, seed, vol, tables, ring, kept, control=False) -> dict:
    """The compared numbers over the kept frames, each {value, limit}, and
    the frames that broke a limit on their own. kept: [(pose index, accum
    tensor (>= N, 3), argb (H, W) uint32 numpy)]."""
    tr = cell.traffic
    limits = cell.data["check"]["limits"]
    n_pix = tr["width"] * tr["height"]
    ids = inputs.check_pixels(seed, len(kept), n_pix, cell.data["check"]["pixels"])
    port_acc = torch.stack([acc[i.to(acc.device)].float().cpu() for (_, acc, _), i
                            in zip(kept, ids)])
    port_img = torch.stack([torch.from_numpy(img.reshape(-1)[i.numpy()].astype("int64"))
                            for (_, _, img), i in zip(kept, ids)])
    eyes = torch.from_numpy(ring[[k for k, _, _ in kept]])
    opts = reference_options(cell)
    times = inputs.pass_times(tables.shape[0])
    ref_acc, ref_img = reference_pixels(vol, opts, tables, times, eyes, ids)
    ref_acc, ref_img = ref_acc.cpu(), ref_img.cpu()
    if control:
        ctl_acc, ctl_img = reference_pixels(vol, opts, tables, times, eyes, ids,
                                            dtype=torch.bfloat16)
        port_acc, port_img = ctl_acc.cpu(), ctl_img.cpu()
    acc_off = ~((port_acc - ref_acc).abs() <= ATOL + RTOL * ref_acc.abs())  # NaN is off
    img_off = port_img != ref_img
    per_frame = [{"accum_off_pct": 100.0 * float(acc_off[f].float().mean()),
                  "image_off_pct": 100.0 * float(img_off[f].float().mean())}
                 for f in range(len(kept))]
    numbers = {"accum_off_pct": 100.0 * float(acc_off.float().mean()),
               "image_off_pct": 100.0 * float(img_off.float().mean())}
    return {"numbers": {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS},
            "failed_frames": sum(any(f[k] > limits[k] for k in NUMBERS) for f in per_frame),
            "pixels": int(ids.numel())}
