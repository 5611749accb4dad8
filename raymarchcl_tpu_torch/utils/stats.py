"""March-loop occupancy statistics.

Counterpart of `raymarchcl_tpu/utils/stats.py`. For a lock-step vectorized
marcher the efficiency metric is the active-ray fraction per round
(SURVEY.md §5): every round costs the full grid, so the area under the
occupancy curve / its length IS the wasted-lane ratio. This module runs an
instrumented copy of the sphere-trace loop, eagerly, and returns per-round
active fractions + step-count histograms for tuning. On the card the
kernels' own counting build (ops/kernels/render_pass.count_lanes) gives
the per-warp lane shares; this is the lock-step view of the plain march.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import march as march_mod
from ..ops.vecmath import V3
from .metrics import mean_f32


def raymarch_occupancy(vol, opts, ray_pos: V3, ray_dir: V3, max_dist, max_steps,
                       active, accel=None, max_rounds=None):
    """Run the outer sphere-trace loop eagerly, recording per-round active
    fractions and the per-ray round-of-completion. Returns dict with
    'active_frac' (list), 'rounds' (int), 'steps_used' (N,) int array and
    'wasted_lane_ratio'."""
    n = ray_pos.x.shape[0]
    dev = ray_pos.x.device
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=torch.float32, device=dev),
                                  (n,))
    if max_rounds is None:
        max_rounds = max_steps
    dist = torch.zeros(n, dtype=torch.float32, device=dev) + opts.startDist
    act = active
    fracs = []
    steps_used = np.zeros(n, np.int32)
    for r in range(max_rounds):
        if not bool(act.any()):
            break
        fracs.append(mean_f32(act))
        pos = ray_pos + ray_dir * dist
        sd = march_mod.distance_to_scene(vol, opts, pos, ray_dir, opts.maxVoxelIter, act,
                                         accel=accel)["dist"]
        done = (sd.abs() <= opts.eps) | (dist >= max_dist)
        dist = torch.where(act & ~done, dist + sd, dist)
        newly_done = (act & done).cpu().numpy()
        steps_used[newly_done] = r + 1
        act = act & ~done
    steps_used[act.cpu().numpy()] = len(fracs)
    return {
        "active_frac": fracs,
        "rounds": len(fracs),
        "steps_used": steps_used,
        "wasted_lane_ratio": 1.0 - (np.mean(steps_used) / max(len(fracs), 1)),
    }


def histogram_report(steps_used, bins=(1, 2, 4, 8, 16, 32, 64, 128)):
    """Text histogram of per-ray completion rounds."""
    lines = []
    prev = 0
    total = steps_used.size
    for b in bins:
        c = int(((steps_used > prev) & (steps_used <= b)).sum())
        if c:
            bar = "#" * max(1, int(40 * c / total))
            lines.append(f"  {prev + 1:>4}-{b:<4} {c:>8} {bar}")
        prev = b
    c = int((steps_used > prev).sum())
    if c:
        lines.append(f"  >{prev:<7} {c:>8}")
    return "\n".join(lines)
