"""Freeze a cell's work a frame: the march samples of the port's counting
build (ops/kernels/render_pass.count_lanes) over the cell's camera ring,
and the bytes a frame reads and writes.

    python3 -m rmcl_bench.tools.freeze_counts --workload <cell> [--seeds 1 2 3]

Runs on one card, whatever the cell's chips: a pixel's samples do not
depend on which card renders it. Prints, per seed, each pose's samples and
their mean, then one JSON line: the `work` entry of workloads/<cell>.json
(operations = 9 a march sample, the convention of the port's kernel
table; bytes = each card's reads of the volume, brick table and MC tables
once, the accum read and written once, the image written once).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

OPS_PER_SAMPLE = 9


def frame_bytes(cell, vol, tables, accel, chips):
    tr = cell.traffic
    n = tr["width"] * tr["height"]
    rows = -(-n // chips) * chips  # the tiled accum's padded rows
    inputs = vol.numel() + tables.numel() * 4 + accel.rows.numel() * 4
    return chips * inputs + rows * (2 * 12 + 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args(argv)
    import torch

    from raymarchcl_tpu_torch.ops.kernels.render_pass import count_lanes

    from .. import inputs, spec
    from ..entries import Scene

    cell = spec.find_cell(args.workload)
    dev = torch.device("cuda")
    means = []
    for seed in args.seeds:
        scene = Scene(cell, seed, [dev])
        times = inputs.pass_times(cell.traffic["spp"])
        per_pose = []
        for eye in scene.ring:
            opts = scene.render_options(eyepos=eye, **scene.user)
            acc = torch.zeros((opts.num_pixels, 3), dtype=torch.float32, device=dev)
            per_pose.append(count_lanes(scene.vol, opts, scene.tables, times, acc,
                                        scene.accel)["samples"])
        means.append(statistics.fmean(per_pose))
        print(json.dumps({"seed": seed, "samples_per_pose": per_pose, "mean": means[-1],
                          "min": min(per_pose), "max": max(per_pose)}), flush=True)
    samples = statistics.fmean(means)
    work = {"march_samples_per_frame": samples, "ops_per_frame": OPS_PER_SAMPLE * samples,
            "bytes_per_frame": frame_bytes(cell, scene.vol, scene.tables, scene.accel,
                                           cell.chips),
            "seeds": args.seeds, "spread_of_seed_means": max(means) / min(means) - 1.0,
            "card": torch.cuda.get_device_name(dev)}
    print(json.dumps({"workload": cell.name, "work": work}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
