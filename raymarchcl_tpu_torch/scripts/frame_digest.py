"""Digest of the main path's frame, to hold two versions of the port bit
for bit on one card.

    python raymarchcl_tpu_torch/scripts/frame_digest.py [--root CHECKOUT] [--frames 3]
        [--mat ao|metal|metal2|orange-stripes]

Renders the main path of chip_smoke.py (gyroid 256^3, 512x512, 16 spp,
the `--mat` preset, `ao` by default, orbit camera at theta=135, over the
brick table) `--frames` times
through ops.render.render_image with the raymarchcl_tpu_torch package of
the checkout at --root (default: the one holding this file), and prints
one JSON line: the sha256 of the last frame's accum bytes and of its
image (the (H, W) uint32 ARGB words), the frames' host-clock seconds (each
ending in a synchronize), the K1/K2 launches, the images K2 packed (null
for a version whose K2 does not pack) and the device. It calls only entry points that every version of the port
with a brick table has, so one file serves an older checkout too. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="checkout whose package renders")
    ap.add_argument("--frames", type=int, default=3)
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
    from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(api.__file__)))
    if pkg_root != os.path.abspath(args.root):
        raise SystemExit(f"frame_digest: the package is imported from {api.__file__}, not "
                         f"{args.root}; run this file by its path")
    if not torch.cuda.is_available():
        raise SystemExit("frame_digest: no CUDA device")
    dev = torch.device("cuda")
    vol_np, res = api.default_volume(256, cache=False)
    vol = volume_from_numpy(vol_np, dev)
    opts = render_options(width=512, height=512, iter=16, vres=list(res), mat=args.mat,
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = make_mc_tables(16, seed=0, device=dev)
    bricks = build_accel(vol, res, opts.isoVal)
    render_mod.render_image(vol, opts, tables, accel=bricks)  # builds, warms up
    torch.cuda.synchronize()
    k1.LAUNCHES = k2.LAUNCHES = 0
    if hasattr(k2, "PACKS"):
        k2.PACKS = 0
    frames, argb, accum = [], None, None
    for _ in range(args.frames):
        t0 = time.perf_counter()
        argb, accum = render_mod.render_image(vol, opts, tables, accel=bricks)
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
    digest = hashlib.sha256(accum.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps({"root": os.path.abspath(args.root), "mat": args.mat, "accum_sha256": digest,
                      "argb_sha256": hashlib.sha256(argb.tobytes()).hexdigest(),
                      "frames_s": frames, "launches": {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES},
                      "packs": getattr(k2, "PACKS", None),
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
