"""Headline benchmark of the port: gyroid 512x512 @ 16 spp, `ao` preset, on
one CUDA card.

    python -m raymarchcl_tpu_torch bench [--device cuda]
    python -m raymarchcl_tpu_torch.scripts.bench [--device cuda]

Counterpart of the JAX package's top-level bench.py. Prints ONE JSON line
with bench.py's keys: `metric` gyroid{size}_{spp}spp_{mat}_frame_time,
`value` the median frame time in s (each frame from a zeroed accum to the
packed image on the host, ending in torch.cuda.synchronize()),
`vs_baseline` against the north-star target of 1 s a frame (BASELINE.md),
the ray rates (primary rays; primary plus secondary rays for every hit and
for the measured hit fraction, utils/metrics), `primary_hit_fraction`,
`accel`, `device` (the card's name and power limit), `samples` (each timed
frame, s) and `invariants`. On stderr: the gate's verdicts and the kernel
launches of the timed frames.

On a card the gate `check_invariants` runs before timing. When an
invariant breaks, the line still prints (with "invariants": false) and the
process exits 1, so a broken engine quotes no number. The gate cannot be
turned off, and a failure never turns into a smaller configuration. On the
CPU (`--device cpu`: the plain versions) there is no gate and "invariants"
is null.

Env: BENCH_SIZE (512), BENCH_SPP (16), BENCH_VRES (256), BENCH_MAT (ao),
BENCH_REPS (5), BENCH_ACCEL (1), BENCH_HOST_CHUNK (16: passes per K2
launch; 16 is one launch a frame).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import NamedTuple

BASELINE_S = 1.0  # north-star: < 1 s a frame (BASELINE.md)
GATE_VRES = 96  # the gate's volume (bench.py:45), the gyroid at 96^3
GATE_FRAME = (128, 64, 16)  # width, height, passes: with/without the table, chunked
GATE_CHUNK = 4  # passes a launch of the chunked frame
GATE_PLAIN = 64  # the side of the pass held to the plain version (bench.py:51)


class Scene(NamedTuple):
    """A frame's inputs, on one device."""

    vol: object
    opts: object
    tables: object
    times: object
    accel: object
    mat: str


def make_scene(volume, opts, spp, mat, dev, use_accel=True) -> Scene:
    """`volume` (flat uint8, numpy array or tensor) on `dev` seen through
    `opts`: MC tables seed 0 for `spp` passes, the still image's pass times,
    and the brick table when use_accel."""
    import torch

    from .. import api
    from ..convert import volume_on
    from ..ops import render
    from ..ops.sampling import make_mc_tables

    vol = volume_on(volume, dev)
    accel = api.build_accel_for(vol, opts) if use_accel else None
    tables = make_mc_tables(spp, seed=0, device=dev)
    times = torch.arange(spp, dtype=torch.float32) * render.TIME_STEP_INIT
    return Scene(vol, opts, tables, times, accel, mat)


def setup(width, height, spp, vres, mat, use_accel, dev) -> Scene:
    """The gyroid at vres^3 (api.default_volume) seen by the main path's
    orbit camera (make_scene)."""
    from .. import api
    from ..ops.camera import compute_eyepos
    from ..options import render_options

    volume, actual = api.default_volume((vres,) * 3)
    opts = render_options(width=width, height=height, vres=list(actual), iter=spp, mat=mat,
                          eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    return make_scene(volume, opts, spp, mat, dev, use_accel)


def frame(scene: Scene, chunk=None):
    """One frame from a zeroed accum, `chunk` passes a launch (None: one
    launch), to the packed image on the host; returns (argb (H, W) uint32,
    accum)."""
    import torch

    from ..ops import render

    accum = torch.zeros((scene.opts.num_pixels, 3), device=scene.vol.device)
    n = scene.tables.shape[0]
    chunk = chunk or n
    argb = None
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        argb, accum = render.render_image(scene.vol, scene.opts, scene.tables[c0:c1],
                                          scene.times[c0:c1], accum, scene.accel)
    if scene.vol.device.type == "cuda":
        torch.cuda.synchronize(scene.vol.device)
    return argb, accum


def timed_frame(scene: Scene, chunk=None):
    """The scene's frame twice (the first builds or loads the kernel
    library); returns (seconds of the second, its argb, its accum)."""
    frame(scene, chunk)
    t0 = time.perf_counter()
    argb, accum = frame(scene, chunk)
    return time.perf_counter() - t0, argb, accum


def launches() -> dict:
    """The kernel wrappers' launch counts: K1 alone, K2 (K2c included), K2c,
    and the images K2 packed."""
    from ..ops.kernels import render_pass as k2
    from ..ops.kernels import tonemap as k1

    return {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K2c": k2.REFLECTIVE_LAUNCHES,
            "packs": k2.PACKS}


def check_invariants(scene: Scene, default: bool) -> dict:
    """The gate on the card, at the bench's material (K2, or K2c for a
    reflective preset): invariant -> bool.

    - accel_on_off: a 128x64 frame of 16 passes over the brick table
      bit-equal to the same frame without it;
    - chunked_vs_one_launch: that frame in one launch bit-equal to launches
      of 4 passes each;
    - plain_64: a 64x64 pass within rtol=atol=5e-3 of render_pass_plain on
      >= 99.5% of its pixels;
    - pack_bit_equal: the bench frame's image, packed by K2, bit-equal to
      K1's plain pack of its accum;
    - main_path_digests (`default`, the main path's frame only): its accum
      and image equal DIGESTS["ao"].
    """
    import torch

    from ..ops.kernels import render_pass as k2
    from ..ops.kernels.tonemap import tonemap_pack_plain
    from .digests import DIGESTS, frame_digests

    dev = scene.vol.device
    w, h, n = GATE_FRAME
    g = setup(w, h, n, GATE_VRES, scene.mat, True, dev)
    zero = torch.zeros((g.opts.num_pixels, 3), device=dev)
    one = k2.render_passes(g.vol, g.opts, g.tables, g.times, zero.clone(), g.accel)
    raw = k2.render_passes(g.vol, g.opts, g.tables, g.times, zero.clone())
    chunked = zero.clone()
    for c0 in range(0, n, GATE_CHUNK):
        k2.render_passes(g.vol, g.opts, g.tables[c0:c0 + GATE_CHUNK],
                         g.times[c0:c0 + GATE_CHUNK], chunked, g.accel)
    res = {"accel_on_off": bool(torch.equal(one, raw)),
           "chunked_vs_one_launch": bool(torch.equal(one, chunked))}
    p = setup(GATE_PLAIN, GATE_PLAIN, 1, GATE_VRES, scene.mat, True, dev)
    o = p.opts.replace(time=p.times[0])
    zero = torch.zeros((o.num_pixels, 3), device=dev)
    acc_k = k2.render_pass(p.vol, o, p.tables[0], zero.clone(), p.accel)
    acc_p = k2.render_pass_plain(p.vol, o, p.tables[0], zero.clone(), p.accel)
    within = torch.isclose(acc_k, acc_p, rtol=5e-3, atol=5e-3).all(dim=1)
    res["plain_64"] = bool(torch.isfinite(acc_k).all()) and float(within.float().mean()) >= 0.995
    argb, accum = frame(scene)
    packed = tonemap_pack_plain(accum, scene.opts.gamma).cpu().numpy().view("uint32")
    res["pack_bit_equal"] = bool((argb.reshape(-1) == packed).all())
    if default:
        res["main_path_digests"] = frame_digests(accum, argb) == DIGESTS["ao"]
    for name, good in res.items():
        print(f"  invariant {name}: {'OK' if good else 'MISMATCH'}", file=sys.stderr, flush=True)
    return res


def run(scene: Scene, reps: int, chunk: int, invariants, device_name: str) -> dict:
    """Warm up, measure the primary hit fraction, time `reps` frames; print
    the JSON line and return it as a dict."""
    from ..utils import metrics

    frame(scene, chunk)  # warm-up: the kernel library's build or load
    hit_frac = metrics.measured_hit_fraction(scene.vol, scene.opts, scene.tables[0],
                                             scene.accel)
    before = launches()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        frame(scene, chunk)
        samples.append(time.perf_counter() - t0)
    counts = {k: v - before[k] for k, v in launches().items()}
    print(f"  launches in the {reps} timed frames: {json.dumps(counts)}", file=sys.stderr,
          flush=True)
    frame_time = statistics.median(samples)
    opts, spp = scene.opts, scene.tables.shape[0]
    rays = metrics.estimated_total_rays
    out = {
        "metric": f"gyroid{opts.height}_{spp}spp_{scene.mat}_frame_time",
        "value": frame_time,
        "unit": "s",
        "vs_baseline": BASELINE_S / frame_time,
        # primary rays only: a conservative rate (secondary rays excluded)
        "mrays_per_sec": metrics.primary_rays(opts, spp) / frame_time / 1e6,
        # every primary ray charged its secondary budget (an upper bound)
        "total_mrays_per_sec": rays(opts, spp) / frame_time / 1e6,
        # the secondary term scaled by the measured primary hit fraction
        "total_mrays_per_sec_measured_hits": rays(opts, spp, hit_fraction=hit_frac)
        / frame_time / 1e6,
        "primary_hit_fraction": hit_frac,
        "accel": scene.accel is not None,
        "device": device_name,
        "samples": samples,
        # True: the gate held on this card just before timing; None: no card
        "invariants": None if invariants is None else all(invariants.values()),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="the port's headline benchmark (one JSON line)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda|cpu)")
    args = ap.parse_args(argv)

    from ..runtime import card, check_device

    dev = check_device(args.device)
    size = int(os.environ.get("BENCH_SIZE", 512))
    spp = int(os.environ.get("BENCH_SPP", 16))
    vres = int(os.environ.get("BENCH_VRES", 256))
    mat = os.environ.get("BENCH_MAT", "ao")
    reps = int(os.environ.get("BENCH_REPS", 5))
    use_accel = os.environ.get("BENCH_ACCEL", "1") != "0"
    chunk = int(os.environ.get("BENCH_HOST_CHUNK", 16))
    if reps < 1 or chunk < 1:
        raise ValueError(f"BENCH_REPS ({reps}) and BENCH_HOST_CHUNK ({chunk}) must be >= 1")
    scene = setup(size, size, spp, vres, mat, use_accel, dev)
    invariants = None
    if dev.type == "cuda":
        invariants = check_invariants(scene, (size, spp, vres, mat) == (512, 16, 256, "ao"))
        if not all(invariants.values()):
            print(f"  INVARIANT MISMATCH — refusing headline: {invariants}", file=sys.stderr)
    run(scene, reps, chunk, invariants, card(dev))
    if invariants is not None and not all(invariants.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
