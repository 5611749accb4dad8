"""Command-line interface: `python -m raymarchcl_tpu_torch <cmd>`.

Counterpart of `raymarchcl_tpu/__main__.py`. The reference is REPL-driven
only (README.org:9-38); this CLI covers the same workflows
non-interactively: still renders, turntable animations, volume baking and
mesh voxelization, a report of the card and the kernel toolchain, and the
headline benchmark (scripts/bench.py). Renders run on the CUDA card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse


def _add_render_args(p):
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--iter", type=int, default=1, help="supersampling passes (spp)")
    p.add_argument("--vres", type=int, default=256, help="procedural volume resolution")
    p.add_argument("--mat", default="metal", help="material preset (orange-stripes|metal|metal2|ao)")
    p.add_argument("--vname", default=None, help=".vox volume file (overrides --vres)")
    p.add_argument("--theta", type=float, default=135.0)
    p.add_argument("--dist", type=float, default=2.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--dof", type=float, default=None)
    p.add_argument("--no-accel", action="store_true", help="march without the brick table")
    p.add_argument("--device", default="cuda", help="torch device to render on (cuda|cpu)")


def _info():
    import torch

    from . import runtime
    from .ops.kernels import build

    platform = runtime.select_platform()
    print(f"platform: {platform}")
    for d in runtime.devices(platform):
        name = torch.cuda.get_device_name(d) if d.type == "cuda" else "host CPU"
        print(f"  {d}: {name}")
    print(f"card (name, power limit): {runtime.card()}")
    try:
        nvcc = build._nvcc()
    except RuntimeError:
        nvcc = "not found (PATH, CUDA_HOME, /usr/local/cuda/bin)"
    print(f"nvcc: {nvcc}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raymarchcl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a still image")
    _add_render_args(r)
    r.add_argument("-o", "--out", default="out.png")
    r.add_argument("--preview", action="store_true",
                   help="fast look-dev budgets (quarter march budgets, same engine; "
                        "see api.PREVIEW_BUDGETS)")

    a = sub.add_parser("anim", help="render a turntable animation")
    _add_render_args(a)
    a.add_argument("--frames", type=int, default=35)
    a.add_argument("-o", "--out-dir", default="export")

    g = sub.add_parser("gen-volume", help="bake a procedural volume to .vox")
    g.add_argument("kind", choices=["gyroid", "terrain"])
    g.add_argument("--vres", type=int, default=256)
    g.add_argument("-o", "--out", required=True)

    v = sub.add_parser("voxelize", help="voxelize an STL mesh to .vox")
    v.add_argument("stl")
    v.add_argument("--res", type=int, default=64)
    v.add_argument("--mode", choices=["point", "ks", "scatter"], default="point")
    v.add_argument("--ks", type=int, default=1)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("-o", "--out", required=True)

    sub.add_parser("info", help="the card, devices and kernel toolchain")

    b = sub.add_parser("bench", help="the headline benchmark: one JSON line, gated on the "
                                     "kernels' invariants (scripts/bench.py; BENCH_* env)")
    b.add_argument("--device", default="cuda", help="torch device (cuda|cpu)")

    args = ap.parse_args(argv)

    if args.cmd == "render":
        from . import api

        extra = {k: getattr(args, k) for k in ("fov", "dof") if getattr(args, k) is not None}
        api.test_render(
            width=args.width, height=args.height, iter=args.iter, vres=args.vres,
            mat=args.mat, vname=args.vname, out_path=args.out, theta=args.theta,
            dist=args.dist, seed=args.seed, preview=args.preview, device=args.device,
            accel=not args.no_accel, **extra,
        )
        print(f"wrote {args.out}")
    elif args.cmd == "anim":
        from . import api

        paths = api.test_anim(
            args.width, args.height, args.iter, args.vres, args.mat, vname=args.vname,
            out_dir=args.out_dir, frames=args.frames, seed=args.seed, device=args.device,
        )
        print(f"wrote {len(paths)} frames to {args.out_dir}")
    elif args.cmd == "gen-volume":
        from .io import voxio
        from .models import generators

        gen = {"gyroid": generators.make_gyroid_volume, "terrain": generators.make_terrain}
        vox = gen[args.kind]({"vres": [args.vres] * 3})
        voxio.save_volume(args.out, args.vres, vox)
        print(f"wrote {args.out} ({args.vres}^3, {vox.size} voxels)")
    elif args.cmd == "voxelize":
        from .io import voxio
        from .models import mesh

        verts = mesh.read_stl(args.stl)
        if args.mode == "point":
            vox = mesh.voxelize(verts, args.res)
        elif args.mode == "ks":
            vox = mesh.voxelize_ks(verts, args.res, args.ks)
        else:
            vox = mesh.voxelize_scatter(verts, args.res, seed=args.seed)
        voxio.save_volume(args.out, args.res, vox)
        print(f"wrote {args.out} ({(vox > 0).sum()} occupied voxels)")
    elif args.cmd == "info":
        _info()
    elif args.cmd == "bench":
        from .scripts import bench

        bench.main(["--device", args.device])


if __name__ == "__main__":
    main()
