"""BASELINE config 5 at full size: 1024x1024, metal, dof=0.025, 100 spp,
seed 0, the 256^3 gyroid (the reference's showcase workload, README.org:63-64
100-spp DOF renders), through the port's io/checkpoint.render_checkpointed.

The render survives interruption and resumes across invocations (run the
script again until it reports the final line). Prints one JSON line per
chunk and a final line with the seconds and s/spp of this run; writes the
PNG next to the checkpoint. Renders on the CUDA card unless --device cpu.

    python -m raymarchcl_tpu_torch.scripts.run_config5 [--ckpt PATH] [--chunk 10]
        [--spp 100] [--minutes 8] [--device cuda]

--ckpt defaults to cfg5 in the temporary directory; the script stops
cleanly (exit 3) after ~--minutes and resumes from the checkpoint.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "cfg5"))
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--spp", type=int, default=100)
    ap.add_argument("--minutes", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from raymarchcl_tpu_torch.api import build_accel_for, default_volume
    from raymarchcl_tpu_torch.convert import volume_on
    from raymarchcl_tpu_torch.io import imageio
    from raymarchcl_tpu_torch.io.checkpoint import render_checkpointed
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options
    from raymarchcl_tpu_torch.runtime import check_device

    dev = check_device(args.device)
    volume_np, vres = default_volume((256,) * 3)
    opts = render_options(
        width=1024, height=1024, vres=list(vres), iter=args.spp, mat="metal",
        dof=0.025, eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0],
    )
    vol = volume_on(volume_np, dev)
    accel = build_accel_for(vol, opts)
    tables = make_mc_tables(args.spp, seed=0, device=dev)

    t_start = time.perf_counter()
    done_passes = []

    def progress(c1, n):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_start
        done_passes.append(c1)
        print(json.dumps({"passes_done": c1, "of": n, "elapsed_s": round(dt, 1)}), flush=True)
        if dt > args.minutes * 60 and c1 < n:
            print(json.dumps({"paused_at": c1,
                              "resume": "run raymarchcl_tpu_torch.scripts.run_config5 again"}),
                  flush=True)
            sys.exit(3)

    argb, _ = render_checkpointed(vol, opts, tables, args.ckpt, chunk=args.chunk,
                                  progress=progress, accel=accel, device=dev)
    total = time.perf_counter() - t_start
    out_png = str(args.ckpt) + ".png"
    imageio.save_png(argb, out_png)
    n_this_run = (done_passes[-1] - (done_passes[0] - args.chunk)) if done_passes else 0
    print(json.dumps({
        "config": "5: 1024^2 metal dof=0.025",
        "spp": args.spp,
        "passes_this_run": n_this_run,
        "seconds_this_run": round(total, 1),
        "s_per_spp_this_run": round(total / max(n_this_run, 1), 2),
        "png": out_png,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }), flush=True)


if __name__ == "__main__":
    main()
