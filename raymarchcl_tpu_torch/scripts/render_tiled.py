"""Render a frame tiled over a process group, one tile a process.

    torchrun --nproc-per-node N -m raymarchcl_tpu_torch.scripts.render_tiled \\
        [--width 512] [--height 512] [--iter 16] [--vres 256] \\
        [--device cuda|cpu] [--backend nccl|gloo] [--out image.png]

Each process joins the group through parallel/distributed.initialize
(torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK), renders its
tile of the gyroid frame (the main path: `ao` preset, orbit camera,
theta 135, MC tables of seed 0, brick table on) on its device (default its
CUDA card, LOCAL_RANK's) through parallel/tiling.render_image_tiled, and receives the
whole image. Every rank prints one JSON line: its rank, what initialize
returned on its first and second call, process_info, the render's seconds
and the sha256 of the gathered accum and image; rank 0 writes --out.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--iter", type=int, default=16)
    ap.add_argument("--vres", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="this process's device (default its CUDA card)")
    ap.add_argument("--backend", default=None, help="default nccl with a card, else gloo")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from .. import api, runtime
    from ..convert import volume_on
    from ..io.imageio import save_png
    from ..ops.camera import compute_eyepos
    from ..ops.sampling import make_mc_tables
    from ..options import render_options
    from ..parallel import distributed, tiling

    first = distributed.initialize(backend=args.backend)
    again = distributed.initialize(backend=args.backend)
    try:
        mesh = tiling.make_mesh(None if args.device is None else [args.device])
        dev = mesh.home
        vol_np, res = api.default_volume(args.vres, cache=False)
        opts = render_options(width=args.width, height=args.height, iter=args.iter,
                              vres=list(res), mat="ao", targetpos=[0, -0.4, 0],
                              eyepos=compute_eyepos(135, 2.25, 0.35))
        vol = volume_on(vol_np, dev)
        bricks = api.build_accel_for(vol, opts)
        tables = make_mc_tables(args.iter, seed=0, device=dev)
        if dev.type == "cuda":  # the kernel library's load is no part of the render
            runtime.build()
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        argb, accum = tiling.render_image_tiled(vol, opts, tables, mesh=mesh, accel=bricks)
        seconds = time.perf_counter() - t0
        rank, world, local = distributed.process_info()
        acc = accum[: opts.num_pixels].cpu().numpy()
        print(json.dumps({
            "rank": rank, "world": world, "local_devices": local, "initialize": [first, again],
            "device": str(dev), "seconds": seconds,
            "accum_sha256": hashlib.sha256(acc.tobytes()).hexdigest(),
            "argb_sha256": hashlib.sha256(argb.tobytes()).hexdigest()}), flush=True)
        if args.out and rank == 0:
            save_png(argb, args.out)
    finally:
        if distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
