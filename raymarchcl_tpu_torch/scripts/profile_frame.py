"""Where the device time of a main-path frame goes: a torch.profiler trace
of whole frames with and without the brick table (gyroid 256^3, 512x512,
16 spp, `ao`, orbit camera at theta=135: chip_smoke.py's main path).

    python -m raymarchcl_tpu_torch.scripts.profile_frame [--frames 3]

For each mode it prints the device's busy share of the traced wall time and
the device time by kernel, copy and fill, largest first. The frame and K2
times themselves come from chip_smoke.py, untraced. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import api
from ..convert import volume_from_numpy
from ..ops import render as render_mod
from ..ops.accel import build_accel
from ..ops.camera import compute_eyepos
from ..ops.sampling import make_mc_tables
from ..options import render_options


def profile(frame_fn, n):
    """Device time by kernel over n frames and the busy share of the wall."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            frame_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # the device's own events (kernels, copies, fills), not the host ops
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, ev.self_device_time_total, ev.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"wall_us": wall_us, "device_us": total, "busy": total / wall_us,
            "kernels": [{"name": k[:60], "us": us, "share": us / total, "count": c}
                        for k, us, c in rows[:8]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3, help="traced frames per mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    dev = torch.device("cuda")
    vol_np, res = api.default_volume(256, cache=False)
    vol = volume_from_numpy(vol_np, dev)
    opts = render_options(width=512, height=512, iter=16, vres=list(res), mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = make_mc_tables(16, seed=0, device=dev)
    out = {"device": torch.cuda.get_device_name(0)}
    for mode, bricks in (("accel", build_accel(vol, res, opts.isoVal)), ("raw", None)):
        def frame():
            return render_mod.render_image(vol, opts, tables, accel=bricks)

        frame()  # builds the kernels, warms the caches
        prof = profile(frame, args.frames)
        out[mode] = prof
        print(f"PROFILE {mode}: device busy {prof['busy']:.4f} of {prof['wall_us']:.0f} us "
              f"wall over {args.frames} frames", flush=True)
        for k in prof["kernels"]:
            print(f"  {k['share']:.4%} {k['us']:10.1f} us x{k['count']:4d} {k['name']}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
