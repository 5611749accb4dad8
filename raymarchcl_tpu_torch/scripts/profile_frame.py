"""Where the device time of a main-path frame goes: a torch.profiler trace
of whole frames with and without the brick table (gyroid 256^3, 512x512,
16 spp, `ao` or the `--mat` preset, orbit camera at theta=135:
chip_smoke.py's main path, or its reflective path with `--mat metal`), and
K2's counting build on one frame.

    python raymarchcl_tpu_torch/scripts/profile_frame.py [--frames 3] [--root CHECKOUT]
        [--mat ao|metal|metal2|orange-stripes]

For each mode it prints the device's busy share of the traced frames, where
the idle time falls (from the exported chrome trace: before the frame's
first device event, between device events, after the last) and the device
time by kernel, copy and fill, largest first. Over the brick table it then
runs the counting build of K2 (ops/kernels/render_pass.count_lanes) on one
frame and prints each counted loop's active-lane share (active lanes over
32 x warp iterations) and the march samples the kernel took. --root
profiles the raymarchcl_tpu_torch package of another checkout (default: the
one holding this file), so two versions can be compared in one call; an
older checkout without the counting build skips it. The frame and K2 times
themselves come from chip_smoke.py, untraced. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

FRAME = "profile_frame"  # the record_function label around each frame


def idle_by_place(events):
    """Idle device time of each traced frame by place, from chrome-trace
    events (µs): before the frame's first device event, in the gaps between
    device events (overlapping events merged), after the last. Returns the
    sums over frames and the frames' total wall time."""
    frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == FRAME and e.get("cat") == "user_annotation")
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                               "gpu_memset"))
    out = {"before": 0.0, "between": 0.0, "after": 0.0, "busy": 0.0, "wall": 0.0}
    for f0, f1 in frames:
        spans = [(max(a, f0), min(b, f1)) for a, b in device if b > f0 and a < f1]
        out["wall"] += f1 - f0
        if not spans:
            out["before"] += f1 - f0
            continue
        merged = [list(spans[0])]
        for a, b in spans[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out["before"] += merged[0][0] - f0
        out["after"] += f1 - merged[-1][1]
        out["between"] += sum(b[0] - a[1] for a, b in zip(merged, merged[1:]))
        out["busy"] += sum(b - a for a, b in merged)
    return out


def profile(frame_fn, n):
    """Device time by kernel over n frames, and the busy and idle shares of
    the frames' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(FRAME):
                frame_fn()
                torch.cuda.synchronize()
    rows = []  # the device's own events (kernels, copies, fills), not the host ops
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key != FRAME:
            rows.append((ev.key, ev.self_device_time_total, ev.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            idle = idle_by_place(json.load(f)["traceEvents"])
    wall = idle["wall"]
    return {"wall_us": wall, "device_us": total, "busy": idle["busy"] / wall,
            "idle": {k: idle[k] / wall for k in ("before", "between", "after")},
            "kernels": [{"name": k[:60], "us": us, "share": us / total, "count": c}
                        for k, us, c in rows[:8]]}


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3, help="traced frames per mode")
    ap.add_argument("--root", default=here, help="checkout whose package renders")
    ap.add_argument("--mat", default="ao", help="material preset")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from raymarchcl_tpu_torch import api
    from raymarchcl_tpu_torch.convert import volume_from_numpy
    from raymarchcl_tpu_torch.ops import render as render_mod
    from raymarchcl_tpu_torch.ops.accel import build_accel
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos
    from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(api.__file__)))
    if pkg_root != os.path.abspath(args.root):
        raise SystemExit(f"profile_frame: the package is imported from {api.__file__}, not "
                         f"{args.root}; run this file by its path")
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    dev = torch.device("cuda")
    vol_np, res = api.default_volume(256, cache=False)
    vol = volume_from_numpy(vol_np, dev)
    opts = render_options(width=512, height=512, iter=16, vres=list(res), mat=args.mat,
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = make_mc_tables(16, seed=0, device=dev)
    bricks = build_accel(vol, res, opts.isoVal)
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0)}
    for mode, acc in (("accel", bricks), ("raw", None)):
        def frame():
            return render_mod.render_image(vol, opts, tables, accel=acc)

        frame()  # builds the kernels, warms the caches
        prof = profile(frame, args.frames)
        out[mode] = prof
        idle = prof["idle"]
        print(f"PROFILE {mode}: device busy {prof['busy']:.4f} of {prof['wall_us']:.0f} us "
              f"wall over {args.frames} frames; idle before the first device event "
              f"{idle['before']:.4f}, between {idle['between']:.4f}, after the last "
              f"{idle['after']:.4f}", flush=True)
        for k in prof["kernels"]:
            print(f"  {k['share']:.4%} {k['us']:10.1f} us x{k['count']:4d} {k['name']}")
    if not hasattr(k2, "count_lanes"):
        print(json.dumps(out), flush=True)
        return
    times = torch.arange(16, dtype=torch.float32) * render_mod.TIME_STEP_INIT
    counts = k2.count_lanes(vol, opts, tables, times,
                            torch.zeros((opts.num_pixels, 3), device=dev), bricks)
    out["lanes"] = counts
    print(f"LANES (counting build, one frame over the brick table): {counts['samples']} "
          f"march samples", flush=True)
    for name in k2.COUNTED_LOOPS:
        c = counts[name]
        print(f"  {name:15s} active {c['active']:.4f}: {c['lanes']} lanes in "
              f"{c['iters']} warp iterations")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
