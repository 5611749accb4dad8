"""The five BASELINE configs (BASELINE.json) on the card: a markdown table on
stdout and one JSON line a config on stderr.

    python -m raymarchcl_tpu_torch.scripts.run_configs [--spp-scale 1]
        [--host-chunk 16] [--device cuda]

Counterpart of the JAX package's scripts/run_configs.py, with its configs
and parameters: the 256^3 gyroid, the committed trefoil mesh's
voxelize_ks(64, 1) and voxelize_scatter(128, seed=3) volumes
(assets/trefoil.stl), MC tables seed 0, the brick table. A config's time is
its second frame (the first builds or loads the kernels), from a zeroed
accum to the packed image on the host, `--host-chunk` passes a launch.
`--spp-scale N` divides each config's spp by N, and config 5's 100 by 25N,
as the JAX script does: config 5 renders 4 passes at full scale, in one
launch and with no checkpoint (scripts/run_config5.py renders its 100
passes through io/checkpoint.render_checkpointed). Each JSON line carries
the frame's sha256 (scripts/digests.frame_digests) and, at full spp,
whether it equals its DIGESTS entry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

TREFOIL = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "trefoil.stl")


def configs(gy256, bunny64, dragon, s=1):
    """The five configs (scripts/run_configs.py:81-98) as (name, kwargs),
    spp divided by s. The JAX script's host_slices (config 5) is TPU
    scheduling that changes no pixel: the port has none."""
    from ..ops.camera import compute_eyepos

    cam = dict(eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    return [
        ("1: gyroid 224^2 1spp primary/flat-ish (ao)",
         dict(volume=gy256, vres=(256,) * 3, spp=1, width=224, height=224, mat="ao", **cam)),
        ("2: gyroid 512^2 AO+fog 25spp",
         dict(volume=gy256, vres=(256,) * 3, spp=max(1, 25 // s), width=512, height=512,
              mat="ao", fogPow=0.1, **cam)),
        ("3: voxelized mesh 64^3 smooth normals 16spp",
         dict(volume=bunny64, vres=(64,) * 3, spp=max(1, 16 // s), width=512, height=512,
              mat="ao", eyepos=compute_eyepos(120, 2.0, 0.5), targetpos=[0, 0, 0])),
        ("4: dragon-style volume, metal + reflections 16spp",
         dict(volume=dragon, vres=(128,) * 3, spp=max(1, 16 // s), width=512, height=512,
              mat="metal", **cam)),
        ("5: gyroid 1024^2 DOF+metal 100spp (single chip here)",
         dict(volume=gy256, vres=(256,) * 3, spp=max(1, 100 // (s * 25)), width=1024,
              height=1024, mat="metal", dof=0.025, **cam)),
    ]


def digest_key(name, spp):
    """The DIGESTS entry of a config's frame at full spp (config 5 renders
    100 // 25 = 4 spp here)."""
    n = name.split(":")[0]
    return f"config {n}" + (f" at {spp} spp" if n == "5" else "")


def volumes():
    """(gyroid 256^3, voxelize_ks(trefoil, 64, 1), voxelize_scatter(trefoil,
    128, seed=3)) as flat uint8 numpy arrays."""
    from .. import api
    from ..models import mesh

    gy256, _ = api.default_volume((256,) * 3)
    verts = mesh.read_stl(TREFOIL)
    return gy256, mesh.voxelize_ks(verts, 64, 1), mesh.voxelize_scatter(verts, 128, seed=3)


def render_timed(volume, vres, spp, host_chunk=16, device="cuda", **kw):
    """Render the config twice, `host_chunk` passes a launch; returns (seconds
    of the second frame, its argb (H, W) uint32, its accum)."""
    from ..options import render_options
    from ..runtime import check_device
    from .bench import make_scene, timed_frame

    opts = render_options(vres=list(vres), iter=spp, **kw)
    scene = make_scene(volume, opts, spp, kw.get("mat"), check_device(device))
    return timed_frame(scene, host_chunk)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the five BASELINE configs on the card")
    ap.add_argument("--spp-scale", type=int, default=1,
                    help="divide each config's spp by this (>= 1)")
    ap.add_argument("--host-chunk", type=int, default=16,
                    help="passes a K2 launch (16: one launch for configs 3 and 4)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda|cpu)")
    args = ap.parse_args(argv)
    if args.host_chunk < 1:
        raise ValueError(f"--host-chunk must be >= 1, got {args.host_chunk}")
    s = max(1, args.spp_scale)

    from ..runtime import card, check_device
    from .digests import DIGESTS, frame_digests

    dev = check_device(args.device)
    device_name = card(dev)
    rows = []
    for name, cfg in configs(*volumes(), s=s):
        volume, vres, spp = cfg.pop("volume"), cfg.pop("vres"), cfg.pop("spp")
        dt, argb, accum = render_timed(volume, vres, spp, host_chunk=args.host_chunk,
                                       device=dev, **cfg)
        digests = frame_digests(accum, argb)
        key = digest_key(name, spp)
        row = {"config": name, "width": cfg["width"], "height": cfg["height"], "spp": spp,
               "seconds": dt, "accum_sha256": digests[0], "argb_sha256": digests[1],
               "digests_equal": DIGESTS[key] == digests if s == 1 and key in DIGESTS else None,
               "device": device_name}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print("\n| config | resolution | spp | seconds | s/spp-Mpixel |")
    print("|---|---|---|---|---|")
    for r in rows:
        norm = r["seconds"] / (r["spp"] * r["width"] * r["height"] / 1e6)
        print(f"| {r['config']} | {r['width']}x{r['height']} | {r['spp']} | {r['seconds']:.4f} "
              f"| {norm:.4f} |")
    print(f"\non {device_name}; {args.host_chunk} passes a launch; config 5 at 100 // "
          f"{25 * s} spp (the JAX script's), with no checkpoint")
    return rows


if __name__ == "__main__":
    main()
