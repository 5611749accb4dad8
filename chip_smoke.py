#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raymarchcl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from raymarchcl_tpu_torch/csrc with nvcc, checks
each against its plain PyTorch version on the card, checks the `gyroid-ao`
golden image, then drives the main path (gyroid 256^3, 512x512, 16 spp,
`ao` preset, orbit camera at theta=135) through ops.render.render_image and
times it. One line per phase; the second-to-last line is a JSON object with
one entry per kernel, the last line the JSON result. Any failed check
raises, so the script exits non-zero and prints no result. It needs a CUDA
device and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "goldens", "gyroid-ao.png")
TOL = dict(rtol=5e-3, atol=5e-3)  # per-pixel accum tolerance (tests/test_parity.py:51)
MIN_PIXELS_OK = 0.995
GOLDEN_CASE = dict(width=64, height=48, iter=2, vres=48, mat="ao", theta=135, dist=2.25,
                   seed=7, maxIter=32, maxVoxelIter=64, shadowIter=32)


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def accum_agreement(got, want):
    """(share of pixels within TOL, share bit-equal, max abs difference)."""
    import torch

    ok = torch.isclose(got, want, **TOL).all(dim=1)
    exact = (got == want).all(dim=1)
    return (float(ok.float().mean()), float(exact.float().mean()),
            float((got - want).abs().max()))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from raymarchcl_tpu_torch import api
    from raymarchcl_tpu_torch.convert import volume_from_numpy
    from raymarchcl_tpu_torch.io import imageio
    from raymarchcl_tpu_torch.ops import render as render_mod
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos
    from raymarchcl_tpu_torch.ops.kernels import build
    from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
    from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options

    dev = torch.device("cuda", 0)
    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_info['seconds']:.2f} s) "
        f"-> {os.path.relpath(build.build_info['path'], REPO)}")
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 2. K1 vs plain ------------------------------------------------------
    rng = np.random.default_rng(0)
    acc_np = rng.uniform(-0.5, 30, (512 * 512, 3)).astype(np.float32)
    acc_np[:2] = [[0.0, 1e30, np.inf], [-1.5, np.nan, -np.inf]]
    acc = torch.from_numpy(acc_np).to(dev)
    gamma = render_options(width=8, height=8, vres=8).gamma
    got = k1.tonemap_pack(acc, gamma)
    want = k1.tonemap_pack_plain(acc, gamma)
    torch.cuda.synchronize()
    k1_err = int((got.long() - want.long()).abs().max())
    require(torch.equal(got, want), "K1 tonemap_pack is not bit-equal to its plain version")
    k1_ms = cuda_ms(lambda: k1.tonemap_pack(acc, gamma), 20)
    k1_plain_ms = cuda_ms(lambda: k1.tonemap_pack_plain(acc, gamma), 20)
    log(f"K1 vs plain: bit-equal over {acc.shape[0]} px; 512^2 kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain_ms:.4f} ms")

    # -- 3. K2 vs plain on the card ------------------------------------------
    def k2_case(name, vres, seed, **kw):
        vol_np, res = api.default_volume(vres)
        vol = volume_from_numpy(vol_np, dev)
        opts = render_options(vres=list(res), eyepos=compute_eyepos(135, 2.25, 0.35),
                              targetpos=[0, -0.4, 0], **kw)
        tables = make_mc_tables(kw["iter"], seed=seed, device=dev)
        times = torch.arange(kw["iter"], dtype=torch.float32) * render_mod.TIME_STEP_INIT
        acc_k = torch.zeros((opts.num_pixels, 3), device=dev)
        acc_p = torch.zeros((opts.num_pixels, 3), device=dev)
        for p in range(kw["iter"]):
            o = opts.replace(time=times[p])
            k2.render_pass(vol, o, tables[p], acc_k)
            acc_p = k2.render_pass_plain(vol, o, tables[p], acc_p)
        torch.cuda.synchronize()
        frac, exact, err = accum_agreement(acc_k, acc_p)
        log(f"K2 vs plain [{name}]: {frac:.6f} of {opts.num_pixels} px within "
            f"rtol=atol=5e-3 ({1 - frac:.6f} differ), {exact:.6f} bit-equal, "
            f"max abs diff {err:.6g}")
        require(bool(torch.isfinite(acc_k).all()), f"K2 [{name}] accum not finite")
        require(frac >= MIN_PIXELS_OK, f"K2 [{name}] agrees on {frac:.4%} < 99.5% of pixels")
        return err

    g = {k: v for k, v in GOLDEN_CASE.items() if k not in ("theta", "dist", "seed")}
    k2_case("gyroid-ao golden case 64x48 2spp vres48", g.pop("vres"), 7, **g)
    k2_err = k2_case("128x128 2spp vres64 default budgets", 64, 0,
                     width=128, height=128, iter=2, mat="ao")

    # -- 4. the golden image on the card --------------------------------------
    from PIL import Image

    argb = api.test_render(out_path=None, verbose=False, device="cuda", **GOLDEN_CASE)
    got = imageio.argb_to_rgba(argb).astype(np.int32)
    want = np.asarray(Image.open(GOLDEN).convert("RGBA")).astype(np.int32)
    require(got.shape == want.shape, f"golden shape {got.shape} != {want.shape}")
    diff = np.abs(got[..., :3] - want[..., :3])
    mad, off8 = float(diff.mean()), float((diff > 8).mean())
    log(f"golden gyroid-ao on cuda: mad {mad:.6f} (< 0.15), frac_off8 {off8:.6%} (< 0.5%)")
    require(mad < 0.15 and off8 < 0.005, "gyroid-ao golden thresholds missed")

    # -- 5. the main path --------------------------------------------------------
    t0 = time.perf_counter()
    vol_np, res = api.default_volume(256)
    vol = volume_from_numpy(vol_np, dev)
    opts = render_options(width=512, height=512, vres=list(res), iter=16, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = make_mc_tables(16, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"main path setup: gyroid {res} ({vol.numel() / 1e6:.1f} MB uint8 on the card), "
        f"{opts.width}x{opts.height}, 16 spp, ao: {time.perf_counter() - t0:.2f} s")

    render_mod.render_image(vol, opts, tables)  # warm-up
    torch.cuda.synchronize()
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    frames, accum, argb = [], None, None
    for _ in range(3):
        t0 = time.perf_counter()
        argb, accum = render_mod.render_image(vol, opts, tables)
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
    launches = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES}
    frame_s = sorted(frames)[1]
    log(f"main path: frames {['%.4f' % f for f in frames]} s, median {frame_s:.4f} s; "
        f"launches {launches}")
    require(launches == {"K1": 3, "K2": 48},
            f"expected 16 K2 + 1 K1 launches per frame over 3 frames, got {launches}")
    require(bool(torch.isfinite(accum).all()), "main path accum not finite")
    require(bool(((argb >> 24) == 0xFF).all()), "main path alpha bytes not all 0xFF")
    n_colors = len(np.unique(argb))
    log(f"main path image: {argb.shape}, {n_colors} distinct colours")
    require(n_colors > 100, f"main path image has only {n_colors} distinct colours")

    # one pass of K2 vs one of its plain version at the main path's shape
    o0 = opts.replace(time=torch.tensor(0.0))
    acc_k = torch.zeros((opts.num_pixels, 3), device=dev)
    k2.render_pass(vol, o0, tables[0], acc_k)
    torch.cuda.synchronize()
    k2_ms = cuda_ms(lambda: k2.render_pass(vol, o0, tables[0], acc_k.zero_()), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc_p = k2.render_pass_plain(vol, o0, tables[0], torch.zeros_like(acc_k))
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    frac, exact, err512 = accum_agreement(acc_k, acc_p)
    log(f"K2 one pass at 512^2: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.1f} ms; "
        f"{frac:.6f} of px within tolerance, {exact:.6f} bit-equal, "
        f"max abs diff {err512:.6g}")
    require(frac >= MIN_PIXELS_OK, f"K2 at 512^2 agrees on {frac:.4%} < 99.5% of pixels")

    kernels = [
        {"name": "K1 tonemap_pack", "route": "cuda",
         "source": "raymarchcl_tpu_torch/csrc/tonemap.cu",
         "replaces": "raymarchcl_tpu/ops/kernels/tonemap_pallas.py:37",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 render_pass", "route": "cuda",
         "source": "raymarchcl_tpu_torch/csrc/render_pass.cu",
         "replaces": "raymarchcl_tpu/ops/render.py:56",
         "launches": launches["K2"], "max_abs_err": max(k2_err, err512),
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    log(json.dumps({"kernels": kernels, "frame_s": frame_s, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
