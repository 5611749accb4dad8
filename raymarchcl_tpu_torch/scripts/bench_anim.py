"""Steady turntable frames and the preview frame on the card: one JSON line.

    python -m raymarchcl_tpu_torch.scripts.bench_anim [--size 512] [--spp 2]
        [--vres 256] [--mat ao] [--frames 6] [--device cuda]

Counterpart of the JAX package's scripts/bench_anim.py, with its keys. The
frames follow api.test_anim's camera path (core.clj:181-213: theta 0->350
over 35 frames, fov 115, target y -0.15) with its loop's shape: the MC
tables and the brick table built once, one accum carried from frame to
frame, the animation's pass times. The first frame includes the kernel
library's build or load; each steady frame (1..--frames) runs from its
options to the packed image on the host (render_image's copy of the image
waits for the frame) and writes no PNG (api.test_anim's frames do). Then
the preview frame: 256^2, 1 spp, api.PREVIEW_BUDGETS, the still's camera,
its own brick table, the fastest of 3 (scripts/bench.frame).
"""

from __future__ import annotations

import argparse
import json
import time

PREVIEW_SIZE = 256  # the preview frame's side (api.PREVIEW_BUDGETS' look-dev still)


def main(argv=None):
    ap = argparse.ArgumentParser(description="steady turntable frames and the preview frame")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--vres", type=int, default=256)
    ap.add_argument("--mat", default="ao")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="torch device (cuda|cpu)")
    args = ap.parse_args(argv)
    if args.frames < 1:
        raise ValueError(f"--frames must be >= 1, got {args.frames}")

    import torch

    from .. import api
    from ..convert import volume_on
    from ..ops import render
    from ..ops.camera import compute_eyepos
    from ..ops.sampling import make_mc_tables
    from ..options import render_options
    from ..runtime import card, check_device
    from . import bench

    dev = check_device(args.device)
    volume, vres = api.default_volume((args.vres,) * 3)
    vol = volume_on(volume, dev)
    tables = make_mc_tables(args.spp, seed=0, device=dev)
    times = torch.arange(args.spp, dtype=torch.float32) * render.TIME_STEP_ANIM

    def frame_opts(frame, n_frames):
        t = frame / n_frames  # api.test_anim's camera path (core.clj:192-201)
        return render_options(
            width=args.size, height=args.size, vres=list(vres), iter=args.spp, mat=args.mat,
            fov=115.0, targetpos=[0, -0.15, 0],
            eyepos=compute_eyepos(t * 350.0, 2.25, 0.44 + t * 0.01))

    t0 = time.perf_counter()
    opts0 = frame_opts(0, 35)
    accel = api.build_accel_for(vol, opts0)
    accum = torch.zeros((opts0.num_pixels, 3), dtype=torch.float32, device=dev)
    argb, accum = render.render_image(vol, opts0, tables, times, accum, accel=accel)
    first_s = time.perf_counter() - t0

    per_frame = []
    for f in range(1, args.frames + 1):
        t0 = time.perf_counter()
        argb, accum = render.render_image(vol, frame_opts(f, 35), tables, times, accum,
                                          accel=accel)
        per_frame.append(time.perf_counter() - t0)

    # preview mode (api.PREVIEW_BUDGETS): quarter budgets and 1 spp
    popts = render_options(width=PREVIEW_SIZE, height=PREVIEW_SIZE, vres=list(vres), iter=1,
                           mat=args.mat,
                           eyepos=compute_eyepos(135.0, 2.25, 0.35),
                           targetpos=[0, -0.4, 0], **api.PREVIEW_BUDGETS)
    pscene = bench.make_scene(vol, popts, 1, args.mat, dev)
    bench.frame(pscene)  # the preview's first frame
    pt = []
    for _ in range(3):
        t0 = time.perf_counter()
        bench.frame(pscene)
        pt.append(time.perf_counter() - t0)

    out = {
        "anim_config": f"{args.size}^2/{args.spp}spp/{args.mat}",
        "first_frame_incl_compile_s": first_s,
        "steady_state_s_per_frame": per_frame,
        "steady_state_median_s": sorted(per_frame)[len(per_frame) // 2],
        "preview_256_s": min(pt),
        "device": card(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
