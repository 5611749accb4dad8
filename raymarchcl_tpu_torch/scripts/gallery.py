"""Render the showcase gallery (the reference's README gallery workflows,
reproduced with in-repo procedural assets since the original STL/volume
files aren't distributed) through the port's api.

Counterpart of `examples/gallery.py`, with the same six images and options
and a `--device` (default the CUDA card; `--device cpu` renders on the
CPU):

    python -m raymarchcl_tpu_torch.scripts.gallery [outdir] [--size WxH] [--spp N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def torus_knot_points(p=2, q=3, n=4000, tube=0.35, r=1.0):
    """Parametric (p,q) torus-knot point cloud (stand-in mesh vertices)."""
    t = np.linspace(0, 2 * np.pi, n)
    rr = r + np.cos(q * t) * 0.5
    x = rr * np.cos(p * t)
    y = np.sin(q * t) * 0.5
    z = rr * np.sin(p * t)
    pts = np.stack([x, y, z], 1)
    rng = np.random.default_rng(0)
    off = rng.normal(scale=tube * 0.25, size=(n, 3))
    return (pts + off).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="examples/output")
    ap.add_argument("--size", default="256x144", help="WxH")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    spp, dev = args.spp, args.device
    os.makedirs(args.out_dir, exist_ok=True)

    from .. import api
    from ..io.imageio import save_png
    from ..models import generators, mesh

    paths = []

    def emit(name, argb):
        path = os.path.join(args.out_dir, name + ".png")
        save_png(np.asarray(argb), path)
        print("wrote", path)
        paths.append(path)

    # 1. gyroid, AO preset (reference gallery "ao" shots)
    emit("gyroid-ao", api.test_render(
        width=w, height=h, iter=spp, vres=128, mat="ao", out_path=None, device=dev))

    # 2. gyroid, metal preset with reflections (reference "metal" shots)
    emit("gyroid-metal", api.test_render(
        width=w, height=h, iter=spp, vres=128, mat="metal", out_path=None, device=dev))

    # 3. orange-stripes preset
    emit("gyroid-orange", api.test_render(
        width=w, height=h, iter=spp, vres=128, mat="orange-stripes",
        theta=60, out_path=None, device=dev))

    # 4. depth of field (reference DOF shots used iter=100)
    emit("gyroid-dof", api.test_render(
        width=w, height=h, iter=max(spp, 4), vres=128, mat="metal2",
        dof=0.04, out_path=None, device=dev))

    # 5. terrain volume
    vol = generators.make_terrain({"vres": [128] * 3})
    argb, _ = api.render_frame(
        vol, (128, 128, 128), iter=spp, width=w, height=h, mat="ao",
        eyepos=[1.7, 0.9, 1.7], targetpos=[0, -0.1, 0], device=dev)
    emit("terrain", argb)

    # 6. voxelized point-cloud knot (mesh pipeline, smooth normals)
    pts = torus_knot_points()
    kvol = mesh.voxelize_ks(pts, 96, 1)
    argb, _ = api.render_frame(
        kvol, (96, 96, 96), iter=spp, width=w, height=h, mat="metal",
        eyepos=[1.8, 1.0, 1.8], targetpos=[0, 0, 0], device=dev)
    emit("knot-metal", argb)
    return paths


if __name__ == "__main__":
    main()
