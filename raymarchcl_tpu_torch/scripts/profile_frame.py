"""K2's lane shares on one main-path frame: the counting build of K2
(ops/kernels/render_pass.count_lanes) over the brick table (gyroid 256^3,
512x512, 16 spp, `ao` or the `--mat` preset, orbit camera at theta=135:
chip_smoke.py's main path, or its reflective path with `--mat metal`).

    python raymarchcl_tpu_torch/scripts/profile_frame.py [--root CHECKOUT]
        [--mat ao|metal|metal2|orange-stripes]

It prints each counted loop's active-lane share (active lanes over 32 x
warp iterations) and the march samples the kernel took, then the same as
one JSON line. --root counts with the raymarchcl_tpu_torch package of
another checkout (default: the one holding this file), so two versions can
be compared in one call. Where the device time of a frame goes is read
from the port's own spans: `python3 -m rmcl_bench.run --trace 1`. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="checkout whose package counts")
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
    if not hasattr(k2, "count_lanes"):
        raise SystemExit(f"profile_frame: {args.root} has no counting build")
    dev = torch.device("cuda")
    vol_np, res = api.default_volume(256, cache=False)
    vol = volume_from_numpy(vol_np, dev)
    opts = render_options(width=512, height=512, iter=16, vres=list(res), mat=args.mat,
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = make_mc_tables(16, seed=0, device=dev)
    bricks = build_accel(vol, res, opts.isoVal)
    times = torch.arange(16, dtype=torch.float32) * render_mod.TIME_STEP_INIT
    counts = k2.count_lanes(vol, opts, tables, times,
                            torch.zeros((opts.num_pixels, 3), device=dev), bricks)
    print(f"LANES (counting build, one frame over the brick table): {counts['samples']} "
          f"march samples", flush=True)
    for name in k2.COUNTED_LOOPS:
        c = counts[name]
        print(f"  {name:15s} active {c['active']:.4f}: {c['lanes']} lanes in "
              f"{c['iters']} warp iterations")
    print(json.dumps({"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
                      "lanes": counts}), flush=True)


if __name__ == "__main__":
    main()
