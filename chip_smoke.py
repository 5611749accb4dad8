#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raymarchcl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from raymarchcl_tpu_torch/csrc with nvcc (and
reports each K2 instance's registers, spills and shared memory), checks
each against its plain PyTorch version on the card (K2 also at aoIter 16,
and its reflective instance K2c for `metal`, `metal2` and `orange-stripes`
at 64x48; each on the first pass of the 512x512 frames of the reflective
path and of BASELINE configs 3 and 4), checks the `gyroid-ao`, `gyroid-metal`, `gyroid-orange` and
`gyroid-dof` golden images and the brick table of the 256^3 gyroid, shows
that K2 and K2c over the brick table are bit-equal to themselves without
it, that one launch of a frame's 16 passes is bit-equal to 16 one-pass
launches and that the image K2 packs in its epilogue (K1's function) is
bit-equal to K1's plain version of its accum, then drives the three paths:
the main path (gyroid 256^3, 512x512, 16 spp, `ao` preset, orbit camera at
theta=135, brick table on; one K2 launch a frame, which packs the image)
through ops.render.render_image, timed with and without the brick table, K2
timed with and without the pack; the reflective path (the same frame with
the `metal` preset, the reference's default still) through api.test_render,
its frames and K2c timed; and the primitive probes E1-E5 through
raymarchcl_tpu_torch.scripts.bench_prims, with checks that E1's rounds,
E3's probes, E4's reps and E5's trips cost time, their library yardsticks
and the launch floor. K2's counting build gives the march samples of K2's
and K2c's bounds and their loops' warp iterations, lanes and active-lane
shares. Then the paths of the library and CLI workflows: the trefoil
mesh's volumes (models/mesh.py) held to the JAX package's digests, K2 and
K2c vs plain on them and with depth of field, the `terrain-ao`,
`heatmap-orange` and `scatter-metal` goldens; BASELINE configs 3 (mesh
64^3, `ao`) and 4 (scatter 128^3, `metal`) at 512^2 and 16 spp through
render_image; config 5 (1024^2, `metal`, dof 0.025, 100 spp) through
io/checkpoint.render_checkpointed in chunks of 10, interrupted and resumed,
and fully resumed (K1 alone), each bit-equal to one straight launch and
held to docs/showcase-config5-100spp.png; api.test_anim (512^2, 2 spp, 3
frames); and `python -m raymarchcl_tpu_torch render` and `info` in a
subprocess. Then the multi-device paths (parallel/tiling.py), all on
cuda:0: K2 and K2c over a ragged pixel range against their plain versions
and against a whole-frame launch (its rows bit-equal), the main path tiled over 4 x cuda:0 (its digests the untiled frame's), the
metal frame's first pass tiled (bit-equal to untiled), the main path's
passes sharded 4 ways and over a 2x2 mesh (K1 alone packs; within
rtol=2e-5, atol=1e-6 of one launch), two processes in a gloo group through
raymarchcl_tpu_torch.scripts.render_tiled (both ranks hold the untiled
digests), utils' measured_hit_fraction and raymarch_occupancy, and
scripts/gallery.py at its defaults. Then the headline benchmark, `python -m
raymarchcl_tpu_torch bench`, in a subprocess (its gate must hold, with the
main path's digests; five samples; one packing K2 launch a timed frame),
scripts/run_configs.py's five BASELINE configs at full spp (configs 1 and 2
also held to the plain version on their first pass), scripts/bench_anim.py
with 3 steady frames and scripts/preview_quality.py. Then the card's
frames are held to the JAX package's at full size
(raymarchcl_tpu_torch/refs/: its compiled render_image on the CPU): the
main path's, configs 1-4 and the `metal` frame at 2 spp, each image within
the goldens' thresholds and its kept accum pixels within the port's
criterion, at most 0.05% off by rel > 1e-3. The main path's, the
metal frame's and configs 1-5's accum and image must keep their sha256
(DIGESTS, raymarchcl_tpu_torch/scripts/digests.py). One line per phase; the
second-to-last line is a JSON object with one entry per kernel, the last
line the JSON result.
Any failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TOL = dict(rtol=5e-3, atol=5e-3)  # per-pixel accum tolerance (tests/test_parity.py:51)
MIN_PIXELS_OK = 0.995
# Published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, also taken for int32 operations.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations of one march sample: the position fma per axis (2 each)
# and the scale to voxels (1 each)
OPS_PER_SAMPLE = 9
GOLDEN_CASE = dict(width=64, height=48, iter=2, vres=48, mat="ao", theta=135, dist=2.25,
                   seed=7, maxIter=32, maxVoxelIter=64, shadowIter=32)
# the goldens of tests/test_goldens.py that the gyroid renders
GOLDENS = {
    "gyroid-ao": GOLDEN_CASE,
    "gyroid-metal": dict(GOLDEN_CASE, width=48, height=32, iter=1, mat="metal"),
    "gyroid-orange": dict(GOLDEN_CASE, width=48, height=32, iter=1, mat="orange-stripes",
                          theta=60),
    "gyroid-dof": dict(GOLDEN_CASE, width=48, height=32, mat="metal2", dof=0.05),
}
# the goldens of tests/test_goldens.py on other volumes (its `_volume`)
VOLUME_GOLDENS = {
    "terrain-ao": dict(GOLDEN_CASE, width=48, height=32, iter=1, vres=40, volume="terrain"),
    "heatmap-orange": dict(GOLDEN_CASE, width=48, height=32, iter=1, vres=32,
                           mat="orange-stripes", theta=45, volume="heatmap"),
    "scatter-metal": dict(GOLDEN_CASE, width=48, height=32, iter=1, vres=32, mat="metal",
                          volume="scatter"),
}
REFLECTIVE = ("metal", "metal2", "orange-stripes")
TREFOIL = os.path.join(REPO, "assets", "trefoil.stl")
# BASELINE configs 3 and 4's volumes (scripts/run_configs.py:77-81): occupied
# voxels and sha256 as the JAX package's raymarchcl_tpu.models.mesh gives them
MESH_VOLUMES = {
    "voxelize_ks(64, 1)": (38673, "99eb9c1d21074f34c11c0e5ce50cbcc13462df34dcd5f4f108fea56db5fe41ce"),
    "voxelize_scatter(128, seed=3)": (
        114919, "98f4e0bf2b30656685bc0d1a2763f68b1c73ecf6a8a130cd9baf715e005f2fca"),
}
CAM = dict(eyepos=(135, 2.25, 0.35), targetpos=[0, -0.4, 0])  # the main path's orbit camera
CAM3 = dict(eyepos=(120, 2.0, 0.5), targetpos=[0, 0, 0])  # config 3's (run_configs.py:89)
SHOWCASE = os.path.join(REPO, "docs", "showcase-config5-100spp.png")
REFS_DIR = os.path.join(REPO, "raymarchcl_tpu_torch", "refs")  # the JAX package's frames
# the share of stored accum pixels a reference frame may have off by rel >
# 1e-3 (tests/test_torch_fullsize.py's MAX_OFF)
REF_MAX_OFF = 0.0005


def log(msg):
    print(msg, flush=True)


def camera(cam):
    """render_options' eyepos/targetpos of a camera (theta, dist, y; target)."""
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos

    return dict(eyepos=compute_eyepos(*cam["eyepos"]), targetpos=cam["targetpos"])


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


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def touched(idx, depth, reps):
    """Distinct (row, column) elements that `reps` consecutive rows from
    each start idx[r, c] (mod depth) reach, each column c apart: what a
    gather of table[(idx + j) % depth, c] for j < reps must read."""
    import numpy as np

    rows = (idx[:, :, None].astype(np.int64) + np.arange(reps)) % depth
    cols = np.broadcast_to(np.arange(idx.shape[1])[None, :, None], rows.shape)
    mask = np.zeros((depth, idx.shape[1]), bool)
    mask[rows, cols] = True
    return int(mask.sum())


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms,
                 **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms, **extra}


def check_accel(acc, vol_np, res, iso):
    """The brick rows against a numpy recomputation: the STOP bits are
    v > isoVal with the padding set, D is 0 exactly at bricks holding a STOP
    bit and never exceeds the distance to the brick grid's boundary, the
    last word is 0. Returns the count of bricks by D."""
    import numpy as np

    e = acc.edge
    dist_w = e**3 // 32
    rows = acc.rows.cpu().numpy().view(np.uint32)
    rx, ry, rz = res
    nbx, nby, nbz = -(-rx // e), -(-ry // e), -(-rz // e)
    bits = np.unpackbits(np.ascontiguousarray(rows[:, :dist_w]).view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    stop = (bits.reshape(nbz, nby, nbx, e, e, e).transpose(0, 3, 1, 4, 2, 5)
            .reshape(nbz * e, nby * e, nbx * e))
    v = np.asarray(vol_np).reshape(rz, ry, rx)
    require((stop[:rz, :ry, :rx] == (v > iso)).all(), "STOP bits != (v > isoVal)")
    require(stop[rz:].all() and stop[:, ry:].all() and stop[:, :, rx:].all(),
            "padding voxels not STOP")
    d = rows[:, dist_w].reshape(nbz, nby, nbx)
    brick_stop = stop.reshape(nbz, e, nby, e, nbx, e).any(axis=(1, 3, 5))
    require(((d == 0) == brick_stop).all(), "D is not 0 exactly at bricks holding a STOP bit")
    z, y, x = np.meshgrid(np.arange(nbz), np.arange(nby), np.arange(nbx), indexing="ij")
    edge_d = np.minimum.reduce([z + 1, nbz - z, y + 1, nby - y, x + 1, nbx - x])
    require((d <= edge_d).all(), "D exceeds the distance to the grid boundary")
    require((rows[:, dist_w + 1] == 0).all(), "pad word not 0")
    vals, counts = np.unique(d, return_counts=True)
    return {int(a): int(b) for a, b in zip(vals, counts)}


def k2_instances(build_log):
    """Per K2 instance (raw/table, counting, reflective) its ptxas registers,
    stack frame, spill and shared-memory bytes, read from the nvcc -Xptxas
    -v log."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*render_passes_kernelI5BuildILb(\d)ELb(\d)"
                      r"ELb(\d)", line)
        if m:
            b, c, r = (x == "1" for x in m.groups())
            name = ("K2c" if r else "K2") + (" table" if b else " raw") + (" counting" if c else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and "stack" not in out[name]:
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)  # ptxas names shared memory when it is used
            out[name]["smem"] = int(m[1]) if m else 0
            name = None
    return out


def lanes_line(counts, loops):
    """Each counted loop's active-lane share, warp iterations and lanes (a
    sample loop's lanes are its samples)."""
    return "; ".join(f"{n} {counts[n]['active']:.4f} ({counts[n]['iters']} warp iterations, "
                     f"{counts[n]['lanes']} lanes)" for n in loops)


def timed_frames(render_mod, vol, opts, tables, acc, n=3):
    """n frames of render_image on the host clock, each ending in a
    synchronize. Returns (seconds per frame, last argb, last accum)."""
    import torch

    frames, argb, accum = [], None, None
    for _ in range(n):
        t0 = time.perf_counter()
        argb, accum = render_mod.render_image(vol, opts, tables, accel=acc)
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
    return frames, argb, accum


def reference_phase(dev, volumes, same_as):
    """The card's frames against the JAX package's at full size:
    raymarchcl_tpu_torch/refs/ holds whole frames of the JAX package's
    compiled render_image on the CPU (tests/test_torch_fullsize.py renders
    them). Each is rendered here from its manifest entry through
    render_image over the brick table: the main path's frame, configs 1-3
    at their spp, the `metal` frame and config 4 at the 2 spp of their
    references. `volumes` maps the manifest's volume names to (flat uint8
    numpy volume, edge); `same_as` maps a reference to an accum that its
    frame must equal (the phase's own frame of it). The image against the
    stored one (a lossless WebP), the kept accum pixels (a band of rows and
    every 64th pixel) against the stored float32 accum; one line a
    frame."""
    import numpy as np
    import torch
    from PIL import Image

    from raymarchcl_tpu_torch.convert import volume_from_numpy
    from raymarchcl_tpu_torch.io import imageio
    from raymarchcl_tpu_torch.ops import accel as accel_mod
    from raymarchcl_tpu_torch.ops import render as render_mod
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options

    with open(os.path.join(REFS_DIR, "manifest.json")) as f:
        refs = json.load(f)
    for name, ref in refs.items():
        for fname, digest in ref["files"].items():
            with open(os.path.join(REFS_DIR, fname), "rb") as f:
                require(hashlib.sha256(f.read()).hexdigest() == digest,
                        f"reference {fname}: sha256 differs from its manifest's")
        vol_r, vres_r = volumes[ref["volume"]]
        require(vres_r == ref["vres"], f"reference {name}: volume {ref['volume']} is {vres_r}^3")
        v = volume_from_numpy(vol_r, dev)
        cam_r = dict(eyepos=(ref["cam"]["theta"], ref["cam"]["dist"], ref["cam"]["y"]),
                     targetpos=ref["cam"]["target"])
        o = render_options(vres=[vres_r] * 3, iter=ref["spp"], **camera(cam_r), **ref["opts"])
        b = accel_mod.build_accel(v, o.voxelRes, o.isoVal)
        argb, acc = render_mod.render_image(v, o, make_mc_tables(ref["spp"], seed=0, device=dev),
                                            accel=b)
        if name in same_as:
            require(torch.equal(acc, same_as[name]),
                    f"reference {name}: the frame differs from the phase's own")
        want = np.asarray(Image.open(os.path.join(REFS_DIR, f"{name}.webp")).convert("RGB"))
        diff = np.abs(imageio.argb_to_rgba(argb)[..., :3].astype(np.int32) - want.astype(np.int32))
        mad, off8 = float(diff.mean()), float((diff > 8).mean())
        with np.load(os.path.join(REFS_DIR, f"{name}.npz")) as z:
            ids = np.concatenate([z["band_ids"], z["sample_ids"]])
            want_acc = torch.from_numpy(np.concatenate([z["band"], z["sample"]])).to(dev)
        got = acc[torch.from_numpy(ids).to(dev).long()]
        within = float(torch.isclose(got, want_acc, **TOL).all(dim=1).float().mean())
        err = (got - want_acc).abs()
        off_rel = float(((err / want_acc.abs().clamp(min=1e-30)).amax(dim=1) > 1e-3)
                        .float().mean())
        err = err.amax(dim=1)
        worst = int(err.argmax())
        log(f"reference {name} ({o.width}x{o.height}, {ref['spp']} spp, {ref['opts']['mat']}, "
            f"{ref['volume']}) on {dev.type} vs the JAX package's render_image: image mad "
            f"{mad:.6f} (< 0.15), frac_off8 {off8:.6%} (< 0.5%); {len(ids)} stored accum px: "
            f"{within:.6f} within rtol=atol=5e-3 (>= 0.995), {off_rel:.6%} off by rel > 1e-3 "
            f"(<= {REF_MAX_OFF:.2%}); worst pixel {int(ids[worst])} off by "
            f"{float(err[worst]):.6g}")
        require(mad < 0.15 and off8 < 0.005, f"reference {name}: golden thresholds missed")
        require(within >= MIN_PIXELS_OK and off_rel <= REF_MAX_OFF,
                f"reference {name}: stored accum agreement missed")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from raymarchcl_tpu_torch import api
    from raymarchcl_tpu_torch.convert import volume_from_numpy
    from raymarchcl_tpu_torch.io import checkpoint, imageio
    from raymarchcl_tpu_torch.models import generators, mesh
    from raymarchcl_tpu_torch.ops import accel as accel_mod
    from raymarchcl_tpu_torch.ops import march
    from raymarchcl_tpu_torch.ops import render as render_mod
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos
    from raymarchcl_tpu_torch.ops.kernels import build, prims
    from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
    from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
    from raymarchcl_tpu_torch.options import render_options
    from raymarchcl_tpu_torch.runtime import card as card_of
    from raymarchcl_tpu_torch.scripts import bench_prims
    from raymarchcl_tpu_torch.scripts.bench import launches as counts
    from raymarchcl_tpu_torch.scripts.digests import DIGESTS, frame_digests

    dev = torch.device("cuda", 0)

    def zero_counts():
        k1.LAUNCHES = k2.LAUNCHES = k2.PACKS = k2.REFLECTIVE_LAUNCHES = 0

    def first_pass_vs_plain(name, v, o, table, b):
        """K2 (or K2c) against its plain version on the first pass of a
        full-size frame, from a zero accum. Returns ((share within TOL,
        share bit-equal, max abs diff), plain ms, march samples the plain
        version read)."""
        kname = "K2c" if o.reflectIter > 0 else "K2"
        acc_kern = k2.render_pass(v, o, table, torch.zeros((o.num_pixels, 3), device=dev), b)
        march.SAMPLES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_pl = k2.render_pass_plain(v, o, table, torch.zeros((o.num_pixels, 3), device=dev), b)
        torch.cuda.synchronize()
        ms, samples = (time.perf_counter() - t0) * 1e3, march.SAMPLES
        agree = accum_agreement(acc_kern, acc_pl)
        log(f"{kname} vs plain [{name}]: {agree[0]:.6f} of {o.num_pixels} px within "
            f"rtol=atol=5e-3 ({1 - agree[0]:.6f} differ), {agree[1]:.6f} bit-equal, max abs "
            f"diff {agree[2]:.6g}; plain {ms:.1f} ms, {samples} march samples read")
        require(bool(torch.isfinite(acc_kern).all()), f"{kname} accum [{name}] not finite")
        require(agree[0] >= MIN_PIXELS_OK,
                f"{kname} [{name}] agrees on {agree[0]:.4%} < 99.5% of pixels")
        return agree, ms, samples

    # -- 1. the card and the build ------------------------------------------
    card = card_of(dev)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_info['seconds']:.2f} s"
        f"{', cached: its nvcc log read back' if build.build_info['cached'] else ''}) "
        f"-> {os.path.relpath(build.build_info['path'], REPO)}")
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    k2_regs = k2_instances(build.build_info["log"])
    log("K2 instances (ptxas): " + "; ".join(
        f"{n} {v.get('registers')} registers, {v.get('stack')} B stack, "
        f"{v.get('spill_stores')}/{v.get('spill_loads')} B spilled, {v.get('smem')} B shared"
        for n, v in k2_regs.items()))
    require(len(k2_regs) == 6 and all(v.get("spill_stores") == 0 and v.get("spill_loads") == 0
                                      for v in k2_regs.values()),
            f"K2's six instances should build without spills: {k2_regs}")

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
    k1_ms = bench_prims.kernel_ms(lambda: k1.tonemap_pack(acc, gamma), 50)
    k1_plain_ms = cuda_ms(lambda: k1.tonemap_pack_plain(acc, gamma), 20)
    log(f"K1 vs plain: bit-equal over {acc.shape[0]} px; 512^2 kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain_ms:.4f} ms")

    # -- 3. K2 vs plain on the card ------------------------------------------
    def k2_case(name, vres, seed, volume=None, cam=CAM, table=False, **kw):
        """K2 (or K2c) against its plain version on the gyroid at vres, or
        on `volume` (vres^3), with the brick table if `table`."""
        vol_np, res = api.default_volume(vres) if volume is None else (volume, (vres,) * 3)
        vol = volume_from_numpy(vol_np, dev)
        opts = render_options(vres=list(res), **camera(cam), **kw)
        bricks_c = accel_mod.build_accel(vol, res, opts.isoVal) if table else None
        tables = make_mc_tables(kw["iter"], seed=seed, device=dev)
        times = torch.arange(kw["iter"], dtype=torch.float32) * render_mod.TIME_STEP_INIT
        acc_k = torch.zeros((opts.num_pixels, 3), device=dev)
        acc_p = torch.zeros((opts.num_pixels, 3), device=dev)
        plain_s = 0.0
        for p in range(kw["iter"]):
            o = opts.replace(time=times[p])
            k2.render_pass(vol, o, tables[p], acc_k, bricks_c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc_p = k2.render_pass_plain(vol, o, tables[p], acc_p, bricks_c)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
        frac, exact, err = accum_agreement(acc_k, acc_p)
        kname = "K2c" if opts.reflectIter > 0 else "K2"
        log(f"{kname} vs plain [{name}]: {frac:.6f} of {opts.num_pixels} px within "
            f"rtol=atol=5e-3 ({1 - frac:.6f} differ), {exact:.6f} bit-equal, "
            f"max abs diff {err:.6g}; plain {plain_s * 1e3:.1f} ms")
        require(bool(torch.isfinite(acc_k).all()), f"{kname} [{name}] accum not finite")
        require(frac >= MIN_PIXELS_OK, f"{kname} [{name}] agrees on {frac:.4%} < 99.5% of pixels")
        return err, plain_s * 1e3

    g = {k: v for k, v in GOLDEN_CASE.items() if k not in ("theta", "dist", "seed")}
    k2_err = k2_case("gyroid-ao golden case 64x48 2spp vres48", g.pop("vres"), 7, **g)[0]
    k2_err = max(k2_err, k2_case("128x128 2spp vres64 default budgets", 64, 0,
                     width=128, height=128, iter=2, mat="ao")[0])
    k2_err = max(k2_err, k2_case("64x48 1spp vres48 aoIter 16", 48, 3, width=64, height=48,
                                 iter=1, mat="ao", aoIter=16)[0])
    # -- 3b. K2c, the reflective instance, vs plain on the card --------------
    k2c_small = dict(width=64, height=48, iter=2)
    k2c_cases = {mat: k2_case(f"{mat} 64x48 2spp vres64 default budgets", 64, 0, mat=mat,
                              **k2c_small) for mat in REFLECTIVE}
    k2c_err = max(err for err, _ in k2c_cases.values())

    # -- 3c. the mesh volumes of BASELINE configs 3 and 4, held to the JAX
    # package's digests; K2 and K2c vs plain on them and with DOF, over the
    # brick table
    verts = mesh.read_stl(TREFOIL)
    require(verts.shape == (18000, 3), f"trefoil.stl: {verts.shape[0]} unique vertices, not 18000")
    mesh_vols = {}
    for key, (n_occ, digest) in MESH_VOLUMES.items():
        t0 = time.perf_counter()
        v = (mesh.voxelize_ks(verts, 64, 1) if key.startswith("voxelize_ks")
             else mesh.voxelize_scatter(verts, 128, seed=3))
        dt = time.perf_counter() - t0
        got = (int((v > 0).sum()), hashlib.sha256(v.tobytes()).hexdigest())
        log(f"mesh volume {key} of trefoil.stl ({verts.shape[0]} unique vertices): {got[0]} "
            f"occupied voxels, sha256 {got[1]}, {dt:.3f} s on the host")
        require(got == (n_occ, digest), f"{key} differs from the JAX package's volume")
        mesh_vols[key] = v
    vol3, vol4 = mesh_vols["voxelize_ks(64, 1)"], mesh_vols["voxelize_scatter(128, seed=3)"]
    new_cases = {
        "config 3 mesh": k2_case("config 3 mesh 64^3 ao 64x48 2spp brick table", 64, 0,
                                 volume=vol3, cam=CAM3, table=True, mat="ao", **k2c_small),
        "config 4 scatter": k2_case("config 4 scatter 128^3 metal 64x48 2spp brick table", 128,
                                    0, volume=vol4, table=True, mat="metal", **k2c_small),
        "config 5 dof": k2_case("config 5 gyroid 256^3 metal dof 0.025 64x48 2spp brick table",
                                256, 0, table=True, mat="metal", dof=0.025, **k2c_small),
    }
    k2_err = max(k2_err, new_cases["config 3 mesh"][0])
    k2c_err = max(k2c_err, new_cases["config 4 scatter"][0], new_cases["config 5 dof"][0])

    # -- 4. the golden images on the card -------------------------------------
    from PIL import Image

    def golden_volume(kind, vres):
        """tests/test_goldens.py's `_volume`, from the port's modules."""
        if kind == "terrain":
            return generators.make_terrain({"vres": [vres] * 3})
        if kind == "heatmap":
            yy, xx = np.mgrid[0:vres, 0:vres]
            gray = ((np.sin(xx * 0.4) * np.cos(yy * 0.3) * 0.5 + 0.5) * 200).astype(np.uint8)
            return mesh.make_heatmap(gray, amp=0.15, res=vres)
        return mesh.voxelize_scatter(verts, vres, seed=3)

    for gname, case in {**GOLDENS, **VOLUME_GOLDENS}.items():
        case = dict(case)
        kind = case.pop("volume", None)
        if kind is None:
            argb = api.test_render(out_path=None, verbose=False, device="cuda", **case)
        else:
            vres, theta = case.pop("vres"), case.pop("theta")
            case.pop("dist")
            argb, _ = api.render_frame(golden_volume(kind, vres), (vres,) * 3, device="cuda",
                                       **camera(dict(CAM, eyepos=(theta, 2.25, 0.35))), **case)
        got = imageio.argb_to_rgba(argb).astype(np.int32)
        want = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{gname}.png")).convert("RGBA"))
        want = want.astype(np.int32)
        require(got.shape == want.shape, f"golden {gname} shape {got.shape} != {want.shape}")
        diff = np.abs(got[..., :3] - want[..., :3])
        mad, off8 = float(diff.mean()), float((diff > 8).mean())
        log(f"golden {gname} on cuda: mad {mad:.6f} (< 0.15), frac_off8 {off8:.6%} (< 0.5%)")
        require(mad < 0.15 and off8 < 0.005, f"{gname} golden thresholds missed")

    # -- 5. the brick table of the main path's volume -----------------------
    t0 = time.perf_counter()
    vol_np, res = api.default_volume(256)
    vol = volume_from_numpy(vol_np, dev)
    main_kw = dict(vres=list(res), mat="ao", eyepos=compute_eyepos(135, 2.25, 0.35),
                   targetpos=[0, -0.4, 0])
    opts = render_options(width=512, height=512, iter=16, **main_kw)
    tables = make_mc_tables(16, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"main path setup: gyroid {res} ({vol.numel() / 1e6:.1f} MB uint8 on the card), "
        f"{opts.width}x{opts.height}, 16 spp, ao: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bricks = accel_mod.build_accel(vol, res, opts.isoVal)
    torch.cuda.synchronize()
    t_accel = time.perf_counter() - t0
    hist = check_accel(bricks, vol_np, res, opts.isoVal)
    log(f"build_accel 256^3 edge {bricks.edge} on the host: {t_accel:.3f} s, rows "
        f"{tuple(bricks.rows.shape)} ({bricks.rows.numel() * 4 / 2**20:.2f} MiB); STOP bits == "
        f"numpy v > isoVal, D bounded by the grid boundary; bricks by D {hist}")

    # -- 6. K2 with the brick table vs K2 without it, and vs its plain version
    for w in (128, 512):
        o = render_options(width=w, height=w, iter=16, **main_kw)
        a_raw = torch.zeros((o.num_pixels, 3), device=dev)
        a_acc = torch.zeros_like(a_raw)
        for p in range(2):
            op = o.replace(time=torch.tensor(p * render_mod.TIME_STEP_INIT))
            k2.render_pass(vol, op, tables[p], a_raw)
            k2.render_pass(vol, op, tables[p], a_acc, bricks)
        torch.cuda.synchronize()
        require(torch.equal(a_acc, a_raw), f"K2 with the brick table differs at {w}^2")
        log(f"K2 with vs without the brick table at {w}^2, 2 passes: bit-equal "
            f"({o.num_pixels} px)")
    o0 = opts.replace(time=torch.tensor(0.0))
    zero = torch.zeros((opts.num_pixels, 3), device=dev)
    acc_k = k2.render_pass(vol, o0, tables[0], zero.clone(), bricks)
    acc_k_raw = k2.render_pass(vol, o0, tables[0], zero.clone())
    plain = {}
    for name, a in (("accel", bricks), ("raw", None)):
        march.SAMPLES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_p = k2.render_pass_plain(vol, o0, tables[0], zero, a)
        torch.cuda.synchronize()
        plain[name] = dict(ms=(time.perf_counter() - t0) * 1e3, samples=march.SAMPLES,
                           agree=accum_agreement(acc_k if a is not None else acc_k_raw, acc_p))
        frac, exact, err = plain[name]["agree"]
        log(f"K2 vs plain at 512^2 ({name}): {frac:.6f} of px within tolerance, "
            f"{exact:.6f} bit-equal, max abs diff {err:.6g}; plain {plain[name]['ms']:.1f} ms, "
            f"{march.SAMPLES} march samples read")
        require(frac >= MIN_PIXELS_OK, f"K2 at 512^2 ({name}) agrees on {frac:.4%} < 99.5%")
    k2_err = max(k2_err, plain["accel"]["agree"][2], plain["raw"]["agree"][2])

    # -- 6b. one launch of a frame's 16 passes vs 16 one-pass launches ------
    times = torch.arange(16, dtype=torch.float32) * render_mod.TIME_STEP_INIT
    a_frame = k2.render_passes(vol, opts, tables, times, zero.clone(), bricks)
    a_single = zero.clone()
    for p in range(16):
        k2.render_pass(vol, opts.replace(time=times[p]), tables[p], a_single, bricks)
    torch.cuda.synchronize()
    require(torch.equal(a_frame, a_single), "16-pass launch differs from 16 one-pass launches")
    log(f"K2 one launch of 16 passes vs 16 one-pass launches at 512^2: bit-equal "
        f"({opts.num_pixels} px)")
    # K1's pack as K2's epilogue, at a frame whose sides are no multiple of
    # the 8x4 warp tile
    o = render_options(width=100, height=37, iter=2, **main_kw)
    a_r, argb_r = torch.zeros((o.num_pixels, 3), device=dev), torch.zeros(
        o.num_pixels, dtype=torch.int32, device=dev)
    k2.render_passes(vol, o, tables[:2], times[:2], a_r, bricks, argb_r)
    require(torch.equal(argb_r, k1.tonemap_pack_plain(a_r, o.gamma)),
            "K2's packed image at 100x37 differs from K1's plain pack of its accum")
    log(f"K2's fused pack at 100x37, 2 passes: bit-equal to K1's plain pack of the accum "
        f"({o.num_pixels} px)")
    # -- 6c. K2c: with vs without the table, one launch vs one-pass launches,
    # its fused pack
    metal_kw = dict(main_kw, mat="metal")
    opts_m = render_options(width=512, height=512, iter=16, **metal_kw)
    a_raw, a_acc = zero.clone(), zero.clone()
    for p in range(2):
        op = opts_m.replace(time=times[p])
        k2.render_pass(vol, op, tables[p], a_raw)
        k2.render_pass(vol, op, tables[p], a_acc, bricks)
    torch.cuda.synchronize()
    require(torch.equal(a_acc, a_raw), "K2c with the brick table differs at 512^2")
    log(f"K2c (metal) with vs without the brick table at 512^2, 2 passes: bit-equal "
        f"({opts_m.num_pixels} px)")
    # K2c vs its plain version on the main path's own inputs: the first
    # pass at 512^2 over the 256^3 volume and its table (the 16-pass check
    # below ties the other passes to one-pass launches)
    k2c_512, k2c_plain512_ms, k2c_plain512_samples = first_pass_vs_plain(
        "metal 512^2 1 pass vres256 brick table, the main path's inputs", vol,
        opts_m.replace(time=times[0]), tables[0], bricks)
    k2c_err = max(k2c_err, k2c_512[2])
    a_frame_m = k2.render_passes(vol, opts_m, tables, times, zero.clone(), bricks)
    a_single = zero.clone()
    for p in range(16):
        k2.render_pass(vol, opts_m.replace(time=times[p]), tables[p], a_single, bricks)
    torch.cuda.synchronize()
    require(torch.equal(a_frame_m, a_single),
            "K2c's 16-pass launch differs from 16 one-pass launches")
    log("K2c (metal) one launch of 16 passes vs 16 one-pass launches at 512^2: bit-equal")
    o = render_options(width=100, height=37, iter=2, **metal_kw)
    a_r, argb_r = torch.zeros((o.num_pixels, 3), device=dev), torch.zeros(
        o.num_pixels, dtype=torch.int32, device=dev)
    k2.render_passes(vol, o, tables[:2], times[:2], a_r, bricks, argb_r)
    require(torch.equal(argb_r, k1.tonemap_pack_plain(a_r, o.gamma)),
            "K2c's packed image at 100x37 differs from K1's plain pack of its accum")
    log("K2c's fused pack at 100x37, 2 passes: bit-equal to K1's plain pack of the accum")
    march.SAMPLES = 0
    t0 = time.perf_counter()
    a_plain = zero.clone()
    for p in range(16):
        a_plain = k2.render_pass_plain(vol, opts.replace(time=times[p]), tables[p], a_plain,
                                       bricks)
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    frac, exact, err = accum_agreement(a_frame, a_plain)
    k2_err = max(k2_err, err)
    log(f"K2 frame vs plain frame at 512^2, 16 passes: {frac:.6f} of px within tolerance, "
        f"{exact:.6f} bit-equal, max abs diff {err:.6g}; plain {plain_frame_ms:.1f} ms, "
        f"{march.SAMPLES} march samples read")
    require(frac >= MIN_PIXELS_OK, f"K2 frame at 512^2 agrees on {frac:.4%} < 99.5%")
    k2_lanes = k2.count_lanes(vol, opts, tables, times, zero.clone(), bricks)
    log(f"K2 counting build, one frame: {k2_lanes['samples']} march samples; active-lane "
        "share " + lanes_line(k2_lanes, k2.COUNTED_LOOPS))

    # -- 7. the main path, with the brick table; then without it -------------
    render_mod.render_image(vol, opts, tables, accel=bricks)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    frames, argb, accum = timed_frames(render_mod, vol, opts, tables, bricks)
    launches, packs = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES,
                       "K2c": k2.REFLECTIVE_LAUNCHES}, k2.PACKS
    frame_s = sorted(frames)[1]
    digest, argb_digest = frame_digests(accum, argb)
    log(f"main path (brick table): frames {['%.4f' % f for f in frames]} s, median "
        f"{frame_s:.4f} s; launches {launches}, packs in K2 {packs}; accum sha256 {digest}; "
        f"argb sha256 {argb_digest}")
    require(launches == {"K1": 0, "K2": 3, "K2c": 0} and packs == 3,
            f"expected 1 K2 launch a frame, packing the image, over 3 frames, got {launches} "
            f"and {packs} packs")
    require((digest, argb_digest) == DIGESTS["ao"],
            f"main path frame differs from its parent's: accum {digest}, image {argb_digest}")
    require(torch.equal(accum, a_frame), "main path accum differs from the checked frame")
    plain_argb = k1.tonemap_pack_plain(accum, opts.gamma).cpu().numpy().view(np.uint32)
    require(np.array_equal(argb.reshape(-1), plain_argb),
            "main path image differs from K1's plain pack of its accum")
    log("main path image: bit-equal to K1's plain pack of the accum")
    require(bool(torch.isfinite(accum).all()), "main path accum not finite")
    require(bool(((argb >> 24) == 0xFF).all()), "main path alpha bytes not all 0xFF")
    n_colors = len(np.unique(argb))
    log(f"main path image: {argb.shape}, {n_colors} distinct colours")
    require(n_colors > 100, f"main path image has only {n_colors} distinct colours")
    render_mod.render_image(vol, opts, tables)  # warm-up
    frames_raw, _, accum_raw = timed_frames(render_mod, vol, opts, tables, None)
    frame_raw_s = sorted(frames_raw)[1]
    require(torch.equal(accum, accum_raw), "main path frame differs without the brick table")
    # K2 alone, a frame per launch: the passes blend into acc_k, whose
    # values do not matter here; with the pack into argb_k, or without
    n_px = opts.num_pixels
    argb_k = torch.empty(n_px, dtype=torch.int32, device=dev)

    def k2_frame(a, pack):
        return lambda: k2.render_passes(vol, opts, tables, times, acc_k, a,
                                        argb_k if pack else None)

    k2_ms1 = bench_prims.kernel_ms(k2_frame(bricks, False), 4)
    k2_pack1 = bench_prims.kernel_ms(k2_frame(bricks, True), 4)
    k2_raw_ms = bench_prims.kernel_ms(k2_frame(None, True), 4)
    k2_pack2 = bench_prims.kernel_ms(k2_frame(bricks, True), 4)
    k2_ms2 = bench_prims.kernel_ms(k2_frame(bricks, False), 4)
    k2_ms, k2_pack_ms = (k2_ms1 + k2_ms2) / 2, (k2_pack1 + k2_pack2) / 2
    fused_ms = k2_pack_ms - k2_ms
    busy = k2_pack_ms / (frame_s * 1e3)
    log(f"main path without the brick table: frames {['%.4f' % f for f in frames_raw]} s, "
        f"median {frame_raw_s:.4f} s; bit-equal accum. K2 per frame (16 passes) at 512^2 "
        f"with the brick table: {k2_ms1:.4f}, {k2_ms2:.4f} ms without the pack (first and "
        f"last), {k2_pack1:.4f}, {k2_pack2:.4f} ms with it (the main path's; "
        f"{k2_pack_ms / 16:.4f} ms a pass); the fused pack's cost {fused_ms:.5f} ms; "
        f"{k2_raw_ms:.4f} ms without the table ({k2_raw_ms / 16:.4f}); K2 device time over "
        f"the median frame: {busy:.4f}")

    # -- 7b. the reflective path: the reference's default still (`metal`) ----
    # once through api.test_render, then its frames and K2c on their own
    zero_counts()
    t0 = time.perf_counter()
    argb_m = api.test_render(width=512, height=512, iter=16, vres=256, mat="metal",
                             out_path=None, verbose=False, device="cuda")
    torch.cuda.synchronize()
    first_m_s = time.perf_counter() - t0
    launches_m, packs_m = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES,
                           "K2c": k2.REFLECTIVE_LAUNCHES}, k2.PACKS
    require(launches_m == {"K1": 0, "K2": 1, "K2c": 1} and packs_m == 1,
            f"expected one K2c launch, packing the image, got {launches_m} and {packs_m} packs")
    frames_m, argb_m2, accum_m = timed_frames(render_mod, vol, opts_m, tables, bricks, n=5)
    frame_m_s = sorted(frames_m)[2]
    require(np.array_equal(argb_m, argb_m2), "api.test_render's metal image differs from "
            "render_image's")
    require(torch.equal(accum_m, a_frame_m), "metal path accum differs from the checked frame")
    require(bool(torch.isfinite(accum_m).all()), "metal path accum not finite")
    require(np.array_equal(argb_m2.reshape(-1), k1.tonemap_pack_plain(accum_m, opts_m.gamma)
                           .cpu().numpy().view(np.uint32)),
            "metal path image differs from K1's plain pack of its accum")
    n_colors_m = len(np.unique(argb_m))
    require(n_colors_m > 100, f"metal path image has only {n_colors_m} distinct colours")
    digest_m, argb_digest_m = frame_digests(accum_m, argb_m2)
    require((digest_m, argb_digest_m) == DIGESTS["metal"],
            f"metal frame differs from its parent's: accum {digest_m}, image {argb_digest_m}")

    def k2c_frame():
        return k2.render_passes(vol, opts_m, tables, times, acc_k, bricks, argb_k)

    k2c_ms = [bench_prims.kernel_ms(k2c_frame, 3) for _ in range(2)]
    k2c_lanes = k2.count_lanes(vol, opts_m, tables, times, zero.clone(), bricks)
    log(f"reflective path (metal, 512^2, 16 spp, brick table) through api.test_render: "
        f"{first_m_s:.3f} s with the volume and table builds; launches {launches_m}, packs in "
        f"K2c {packs_m}; {n_colors_m} distinct colours; frames of render_image "
        f"{['%.4f' % f for f in frames_m]} s, median {frame_m_s:.4f} s; K2c per frame "
        f"{k2c_ms[0]:.4f}, {k2c_ms[1]:.4f} ms ({sum(k2c_ms) / 32:.4f} ms a pass); accum sha256 "
        f"{digest_m}; argb sha256 {argb_digest_m}; on {card}")
    log(f"K2c counting build, one metal frame: {k2c_lanes['samples']} march samples; "
        "active-lane share " + lanes_line(k2c_lanes, k2.COUNTED_LOOPS))

    # -- 8. the primitive probes E1-E5 through their entry point -------------
    for name in prims.LAUNCHES:
        prims.LAUNCHES[name] = 0
    bench = bench_prims.run(dev, n=20, log=log)
    e_launches = dict(prims.LAUNCHES)
    require(all(v > 0 for v in e_launches.values()), f"a probe kernel never ran: {e_launches}")
    x = bench_prims.inputs(dev)
    e_err, e_plain_ms = {}, {}
    calls = {
        "E1": ("e1_row_fetch", (x["e1_table"], x["e1_sidx"])),
        "E3": ("e3_probe", (x["e3_rows"], x["e3_w"], x["e3_b"])),
        "E4": ("e4_transpose", (x["e4_x"],)),
        "E5": ("e5_while", (x["e5_x_timed"],)),
        **{f"E2/{d}": ("e2_gather", (x[f"e2_table_{d}"], x[f"e2_idx_{d}"]))
           for d in prims.E2_DEPTHS},
    }
    for key, (fn, args) in calls.items():
        got, want = getattr(prims, fn)(*args), getattr(prims, fn + "_plain")(*args)
        got, want = (got, want) if key != "E5" else (torch.cat([got[0].reshape(-1), got[1]]),
                                                     torch.cat([want[0].reshape(-1), want[1]]))
        e_err[key] = int((got.long() - want.long()).abs().max())
        require(e_err[key] == 0, f"{key} differs from its plain version")
        e_plain_ms[key] = cuda_ms(lambda: getattr(prims, fn + "_plain")(*args), 3)
    table, sidx = x["e1_table"], x["e1_sidx"]
    rows3, w3, b3 = x["e3_rows"], x["e3_w"], x["e3_b"]
    e3_64 = bench_prims.kernel_ms(lambda: prims.e3_probe(rows3, w3, b3, reps=64), 50)
    e3_1024 = bench_prims.kernel_ms(lambda: prims.e3_probe(rows3, w3, b3, reps=1024), 50)
    e3_src = open(os.path.join(build.CSRC_DIR, "prims.cu")).read()
    e3_lanes = int(re.search(r"constexpr int kE3Lanes = (\d+)", e3_src).group(1))
    log(f"E3 time by reps ({e3_lanes} lanes a ray): 64 -> {e3_64 * 1e3:.2f} us, 1024 -> "
        f"{e3_1024 * 1e3:.2f} us (x{e3_1024 / e3_64:.2f})")
    require(e3_1024 > 1.5 * e3_64, "E3's probes do not cost time: were they folded?")
    e1_16 = bench_prims.kernel_ms(lambda: prims.e1_row_fetch(table, sidx, 16), 50)
    e1_64 = bench_prims.kernel_ms(lambda: prims.e1_row_fetch(table, sidx, 64), 50)
    log(f"E1 time by REPS_IN: 16 -> {e1_16 * 1e3:.2f} us, 64 -> {e1_64 * 1e3:.2f} us "
        f"(x{e1_64 / e1_16:.2f})")
    require(e1_64 > 1.5 * e1_16, "E1's rounds do not cost time: were they optimised away?")
    xt = x["e4_x"]
    e4_16 = bench_prims.kernel_ms(lambda: prims.e4_transpose(xt, 16), 50)
    e4_1024 = bench_prims.kernel_ms(lambda: prims.e4_transpose(xt, 1024), 50)
    log(f"E4 time by reps: 16 -> {e4_16 * 1e3:.2f} us, 1024 -> {e4_1024 * 1e3:.2f} us "
        f"(x{e4_1024 / e4_16:.2f})")
    require(e4_1024 > 2 * e4_16, "E4's reps do not cost time: were they folded?")
    e5_100, e5_1000 = bench["E5/short"]["us"], bench["E5"]["us"]
    log(f"E5 time by trips: 100 -> {e5_100:.2f} us, 1000 -> {e5_1000:.2f} us "
        f"(x{e5_1000 / e5_100:.2f}), {bench['E5']['ns_per_trip']:.2f} ns a trip")
    require(e5_1000 > 2 * e5_100, "E5's trips do not cost time: was the loop folded?")
    rounds = (sidx.long()[None, :] + torch.arange(prims.REPS_IN, device=dev)[:, None]) % prims.S
    e1_lib_ms = bench_prims.kernel_ms(lambda: torch.index_select(table, 0, rounds[-1]), 50)
    rounds = rounds.reshape(-1)
    e1_equal_ms = bench_prims.kernel_ms(lambda: torch.index_select(table, 0, rounds), 50)
    e4_lib = torch.empty(xt.shape[::-1], dtype=torch.int32, device=dev)
    torch.mul(xt.t(), prims.REPS_IN, out=e4_lib)
    require(torch.equal(e4_lib, prims.e4_transpose(xt)), "E4 differs from torch.mul(x.t(), 64)")
    e4_lib_ms = bench_prims.kernel_ms(lambda: torch.mul(xt.t(), prims.REPS_IN, out=e4_lib), 50)
    # E2's yardstick: one torch.gather of all 64 rounds' rows at depth 4096,
    # the index built outside the timed call; it reads what E2 reads but
    # writes every round instead of summing them
    e2_tab, e2_idx = x["e2_table_4096"], x["e2_idx_4096"]
    e2_ix = ((e2_idx.long()[None] + torch.arange(prims.REPS_IN, device=dev)[:, None, None])
             % e2_tab.shape[0]).reshape(-1, e2_tab.shape[1])
    e2_gathered = torch.gather(e2_tab, 0, e2_ix)
    require(torch.equal(prims.e2_gather(e2_tab, e2_idx), prims._wrap(
        e2_gathered.long().reshape(prims.REPS_IN, *e2_idx.shape).sum(0)).int()),
        "E2 differs from the sum of torch.gather's rounds")
    e2_equal_ms = bench_prims.kernel_ms(lambda: torch.gather(e2_tab, 0, e2_ix), 50)
    log(f"E1 library yardsticks torch.index_select: the last round {e1_lib_ms * 1e3:.2f} us, "
        f"all {rounds.numel()} rows of the {prims.REPS_IN} rounds (equal reads) "
        f"{e1_equal_ms * 1e3:.2f} us; E4 torch.mul(x.t(), 64, out=(128, K)): "
        f"{e4_lib_ms * 1e3:.2f} us; E0 torch.take loop {bench['E0']['us']:.1f} us")
    log(f"E2 equal-reads yardstick (a yardstick, not the same function: it reads the same "
        f"elements but writes each round instead of summing): torch.gather of all "
        f"{e2_ix.shape[0]} rows of the {prims.REPS_IN} rounds at depth {e2_tab.shape[0]} "
        f"{e2_equal_ms * 1e3:.2f} us, E2 {bench['E2/4096']['us']:.2f} us; launch floor "
        f"(torch.cuda._sleep(0)) {bench['floor']['us']:.2f} us")
    # bytes a second: the row bytes of E1's rounds, the shared-memory bytes E4's reps read
    e1_rate = prims.K * prims.REPS_IN * table.shape[1] * 4 / (bench["E1"]["us"] * 1e-6)
    e4_rate = xt.numel() * 4 * prims.REPS_IN / (bench["E4"]["us"] * 1e-6)
    log(f"E1 rows staged {e1_rate / 1e12:.3f} TB/s; E4 shared memory read {e4_rate / 1e12:.3f} TB/s")

    # -- 8b. BASELINE configs 3 and 4 at full size (512^2, 16 spp; the
    # main path's MC tables, seed 0, as scripts/run_configs.py:32 takes them)
    configs, accum_8b = {}, {}
    for key, vol_c, vres_c, mat_c, cam_c in (("config 3", vol3, 64, "ao", CAM3),
                                             ("config 4", vol4, 128, "metal", CAM)):
        v = volume_from_numpy(vol_c, dev)
        o = render_options(width=512, height=512, iter=16, vres=vres_c, mat=mat_c, **camera(cam_c))
        b = accel_mod.build_accel(v, o.voxelRes, o.isoVal)
        render_mod.render_image(v, o, tables, accel=b)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        fr, argb_c, acc_c = timed_frames(render_mod, v, o, tables, b, n=3)
        cnt = counts()
        reflective = o.reflectIter > 0
        require(cnt == {"K1": 0, "K2": 3, "K2c": 3 if reflective else 0, "packs": 3},
                f"{key}: expected one {'K2c' if reflective else 'K2'} launch a frame, packing "
                f"the image, over 3 frames, got {cnt}")
        require(bool(torch.isfinite(acc_c).all()), f"{key} accum not finite")
        require(np.array_equal(argb_c.reshape(-1), k1.tonemap_pack_plain(acc_c, o.gamma)
                               .cpu().numpy().view(np.uint32)),
                f"{key} image differs from K1's plain pack of its accum")
        n_colors_c = len(np.unique(argb_c))
        require(n_colors_c > 100, f"{key} image has only {n_colors_c} distinct colours")
        k_ms = [bench_prims.kernel_ms(lambda: k2.render_passes(v, o, tables, times, acc_k, b,
                                                               argb_k), 3) for _ in range(2)]
        # the kernel against its plain version on this config's own inputs:
        # the first pass of the 512^2 frame over the mesh volume and its table
        agree_c, plain_c_ms, plain_c_samples = first_pass_vs_plain(
            f"{key} {vres_c}^3 {mat_c} 512^2 1 pass brick table, the config's inputs", v,
            o.replace(time=times[0]), tables[0], b)
        if reflective:
            k2c_err = max(k2c_err, agree_c[2])
        else:
            k2_err = max(k2_err, agree_c[2])
        dg = frame_digests(acc_c, argb_c)
        accum_8b[key] = acc_c
        lanes_c = k2.count_lanes(v, o, tables, times, torch.zeros_like(acc_c), b)
        configs[key] = dict(frames_s=fr, frame_s=sorted(fr)[1], kernel_ms=k_ms, launches=cnt,
                            accum_sha256=dg[0], argb_sha256=dg[1], colours=n_colors_c,
                            samples=lanes_c["samples"], agree_512_pass=agree_c[0],
                            max_abs_err_512_pass=agree_c[2], plain_ms_512_pass=plain_c_ms,
                            plain_samples_512_pass=plain_c_samples,
                            active_lanes={n: lanes_c[n]["active"] for n in k2.COUNTED_LOOPS},
                            warp_iterations={n: lanes_c[n]["iters"] for n in k2.COUNTED_LOOPS})
        log(f"{key} counting build, one frame: {lanes_c['samples']} march samples; active-lane "
            "share " + lanes_line(lanes_c, k2.COUNTED_LOOPS))
        log(f"{key} ({vres_c}^3 mesh volume, {mat_c}, 512^2, 16 spp, brick table) through "
            f"render_image: frames {['%.4f' % f for f in fr]} s, median {sorted(fr)[1]:.4f} s; "
            f"{'K2c' if reflective else 'K2'} per frame {k_ms[0]:.4f}, {k_ms[1]:.4f} ms; "
            f"launches {cnt}; {n_colors_c} distinct colours; accum sha256 {dg[0]}; argb sha256 "
            f"{dg[1]}")
        require(dg == DIGESTS[key], f"{key} frame differs from its parent's: accum {dg[0]}, "
                f"image {dg[1]}")

    # -- 8c. BASELINE config 5 at full size through render_checkpointed -----
    # (1024^2, metal, dof 0.025, 100 spp, seed 0, the 256^3 gyroid, default
    # budgets): chunks of 10 passes, an interrupted run resumed, a full
    # resume, each bit-equal to one straight launch of the 100 passes
    opts5 = render_options(width=1024, height=1024, iter=100, vres=list(res), mat="metal",
                           dof=0.025, **camera(CAM))
    t0 = time.perf_counter()
    tables5 = make_mc_tables(100, seed=0, device=dev)
    tables5_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    argb5, acc5 = render_mod.render_image(vol, opts5, tables5, accel=bricks)
    torch.cuda.synchronize()
    straight5_s = time.perf_counter() - t0
    cnt_straight5 = counts()
    require(cnt_straight5 == {"K1": 0, "K2": 1, "K2c": 1, "packs": 1},
            f"config 5 straight: expected one K2c launch, got {cnt_straight5}")

    class Interrupt(Exception):
        pass

    def stop_after_3_chunks(done, total):
        if done >= 30:
            raise Interrupt

    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "cfg5")
        zero_counts()
        t0 = time.perf_counter()
        argb5c, acc5c = checkpoint.render_checkpointed(vol, opts5, tables5, ck, chunk=10,
                                                       accel=bricks)
        torch.cuda.synchronize()
        chunked5_s = time.perf_counter() - t0
        cnt_chunked5 = counts()
        require(cnt_chunked5 == {"K1": 0, "K2": 10, "K2c": 10, "packs": 10},
                f"config 5 chunked: expected 10 K2c launches, got {cnt_chunked5}")
        require(np.array_equal(argb5c, argb5) and torch.equal(acc5c, acc5),
                "config 5 through render_checkpointed differs from one straight launch")
        ck_i = os.path.join(td, "cfg5-interrupted")
        try:
            checkpoint.render_checkpointed(vol, opts5, tables5, ck_i, chunk=10, accel=bricks,
                                           progress=stop_after_3_chunks)
            require(False, "the interrupting progress callback did not stop the render")
        except Interrupt:
            pass
        require(checkpoint.load_accum(ck_i, opts5)[1]["passes_done"] == 30,
                "the interrupted render's checkpoint does not hold 30 passes")
        argb5i, acc5i = checkpoint.render_checkpointed(vol, opts5, tables5, ck_i, chunk=10,
                                                       accel=bricks)
        require(np.array_equal(argb5i, argb5) and torch.equal(acc5i, acc5),
                "config 5 interrupted after 3 chunks and resumed differs from one straight launch")
        zero_counts()
        argb5r, acc5r = checkpoint.render_checkpointed(vol, opts5, tables5, ck, chunk=10,
                                                       accel=bricks)
        torch.cuda.synchronize()
        cnt_resume5 = counts()
        require(cnt_resume5 == {"K1": 1, "K2": 0, "K2c": 0, "packs": 0},
                f"config 5 fully resumed: expected K1 alone once, got {cnt_resume5}")
        require(np.array_equal(argb5r, argb5) and torch.equal(acc5r, acc5),
                "config 5 fully resumed differs from one straight launch")
        ck_bytes = os.path.getsize(ck + ".npz")
    want5 = np.asarray(Image.open(SHOWCASE).convert("RGBA")).astype(np.int32)
    diff5 = np.abs(imageio.argb_to_rgba(argb5).astype(np.int32)[..., :3] - want5[..., :3])
    mad5, off8_5 = float(diff5.mean()), float((diff5 > 8).mean())
    dg5 = frame_digests(acc5, argb5)
    # K2c alone on config 5's frame (a launch of ~1 s: CUDA events suffice)
    times5 = torch.arange(100, dtype=torch.float32) * render_mod.TIME_STEP_INIT
    acc5_k = torch.zeros_like(acc5)
    argb5_k = torch.empty(opts5.num_pixels, dtype=torch.int32, device=dev)
    k2c5_ms = cuda_ms(lambda: k2.render_passes(vol, opts5, tables5, times5, acc5_k, bricks,
                                               argb5_k), 1)
    configs["config 5"] = dict(straight_s=straight5_s, chunked_s=chunked5_s,
                               s_per_spp=chunked5_s / 100, kernel_ms=k2c5_ms,
                               checkpoint_overhead_s=chunked5_s - straight5_s,
                               checkpoint_bytes=ck_bytes, tables_s=tables5_s,
                               launches_chunked=cnt_chunked5, launches_resume=cnt_resume5,
                               showcase_mad=mad5, showcase_frac_off8=off8_5,
                               accum_sha256=dg5[0], argb_sha256=dg5[1])
    log(f"config 5 (1024^2, metal, dof 0.025, 100 spp, gyroid 256^3, brick table): straight "
        f"launch {straight5_s:.3f} s (K2c {k2c5_ms:.2f} ms with the pack); render_checkpointed "
        f"chunk=10: {chunked5_s:.3f} s, {chunked5_s / 100:.5f} s/spp, launches {cnt_chunked5}, "
        f"checkpoint overhead {chunked5_s - straight5_s:.3f} s ({ck_bytes} B a checkpoint); "
        f"bit-equal to the straight launch, so is the run interrupted after 3 chunks and "
        f"resumed; full resume launches {cnt_resume5}, bit-equal; MC tables {tables5_s:.2f} s "
        f"on the host; accum sha256 {dg5[0]}; argb sha256 {dg5[1]}")
    log(f"config 5 vs docs/showcase-config5-100spp.png (the JAX package's frame): mad "
        f"{mad5:.6f} (< 0.15), frac_off8 {off8_5:.6%} (< 0.5%)")
    require(dg5 == DIGESTS["config 5"], f"config 5 frame differs from its parent's: accum "
            f"{dg5[0]}, image {dg5[1]}")
    require(mad5 < 0.15 and off8_5 < 0.005, "config 5 misses the golden thresholds of "
            "docs/showcase-config5-100spp.png")

    # -- 8d. api.test_anim at 512^2, 2 spp, ao, 3 frames -------------------
    out = io.StringIO()
    zero_counts()
    with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(out):
        paths = api.test_anim(512, 512, 2, 256, "ao", out_dir=td, frames=3, device="cuda")
        frames_anim = [np.asarray(Image.open(p_).convert("RGB")) for p_ in paths]
    cnt_anim = counts()
    anim_s = [float(x) for x in re.findall(r"rendered frame #\d+ in ([0-9.]+)s", out.getvalue())]
    require(cnt_anim == {"K1": 0, "K2": 3, "K2c": 0, "packs": 3},
            f"test_anim: expected one K2 launch a frame, packing the image, got {cnt_anim}")
    require(len(anim_s) == 3, f"test_anim printed {out.getvalue()!r}")
    require(not np.array_equal(frames_anim[0], frames_anim[1])
            and not np.array_equal(frames_anim[1], frames_anim[2]), "test_anim frames repeat")
    t1 = 1 / 3
    fresh, _ = api.render_frame(
        vol_np, res, iter=2, device="cuda", width=512, height=512, mat="ao", fov=115.0,
        times=torch.arange(2, dtype=torch.float32) * render_mod.TIME_STEP_ANIM,
        targetpos=[0, -0.15, 0], eyepos=compute_eyepos(t1 * 350.0, 2.25, 0.44 + t1 * 0.01))
    require(not np.array_equal(imageio.argb_to_rgba(fresh)[..., :3], frames_anim[1]),
            "test_anim frame 1 equals a fresh render: the accum was not carried")
    configs["test_anim"] = dict(frames_s=anim_s, launches=cnt_anim)
    log(f"test_anim (512^2, 2 spp, ao, 3 frames, one accum carried): frames "
        f"{['%.4f' % f for f in anim_s]} s (each with its PNG write); launches {cnt_anim}; frames "
        f"differ, frame 1 differs from a fresh render of its camera")

    # -- 8e. the CLI in a subprocess ---------------------------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "cli.png")
        cmds = {"render": ["render", "--mat", "ao", "--width", "256", "--height", "144",
                           "--iter", "2", "--vres", "128", "-o", png], "info": ["info"]}
        for name, argv in cmds.items():
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "raymarchcl_tpu_torch", *argv], cwd=REPO,
                               env=env, capture_output=True, text=True, timeout=600)
            require(r.returncode == 0, f"CLI {name} exited {r.returncode}: {r.stderr[-2000:]}")
            log(f"CLI {name} ({time.perf_counter() - t0:.2f} s): "
                + " | ".join(r.stdout.strip().splitlines()))
        img = imageio.load_gray(png)
        require(img.shape == (144, 256) and img.std() > 0, "CLI render: a flat or misshapen PNG")

    # -- 8f. the multi-device paths (parallel/tiling.py), all on cuda:0 ------
    from raymarchcl_tpu_torch.ops.camera import camera_ray_lookat
    from raymarchcl_tpu_torch.ops.sampling import init_render_state
    from raymarchcl_tpu_torch.parallel import tiling
    from raymarchcl_tpu_torch.scripts import gallery
    from raymarchcl_tpu_torch.utils import metrics, stats

    t_phase = time.perf_counter()
    multi = {}
    # K2 and K2c over a ragged pixel range against their plain versions: the
    # last of 3 tiles of a 100x37 frame starts mid-row and ends in pad rows,
    # which render pixel N-1 again
    for mat_r, n_p in (("ao", 2), ("metal", 1)):
        o = render_options(width=100, height=37, iter=n_p, **dict(main_kw, mat=mat_r))
        blk = -(-o.num_pixels // 3)
        lo, real = 2 * blk, o.num_pixels - 2 * blk
        a_k = torch.zeros((blk, 3), device=dev)
        g_k = torch.zeros(blk, dtype=torch.int32, device=dev)
        k2.render_passes(vol, o, tables[:n_p], times[:n_p], a_k, bricks, g_k, pix_lo=lo,
                         pix_count=blk)
        a_p = torch.zeros((blk, 3), device=dev)
        t0 = time.perf_counter()
        for p in range(n_p):
            a_p = k2.render_pass_plain(vol, o.replace(time=times[p]), tables[p], a_p, bricks,
                                       pix_lo=lo)
        torch.cuda.synchronize()
        plain_r_ms = (time.perf_counter() - t0) * 1e3
        frac, exact, err = accum_agreement(a_k, a_p)
        kname = "K2c" if o.reflectIter > 0 else "K2"
        # the range's worst pixel against the whole-frame launch: the range's
        # rows equal the whole frame's bit for bit, so its error is the
        # whole-frame launch's own at that pixel (plain: that pixel alone)
        a_w = k2.render_passes(vol, o, tables[:n_p], times[:n_p],
                               torch.zeros((o.num_pixels, 3), device=dev), bricks)
        require(torch.equal(a_k[:real], a_w[lo:]),
                f"{kname} pixel range: its rows differ from the whole-frame launch's")
        pid = min(lo + int((a_k - a_p).abs().amax(dim=1).argmax()), o.num_pixels - 1)
        a_1 = torch.zeros((1, 3), device=dev)
        for p in range(n_p):
            a_1 = k2.render_pass_plain(vol, o.replace(time=times[p]), tables[p], a_1, bricks,
                                       pix_lo=pid)
        err_w = float((a_w[pid] - a_1[0]).abs().max())
        log(f"{kname} pixel range vs plain [{mat_r} 100x37 {n_p} pass(es), tile 3 of 3: rows "
            f"{blk} from pixel {lo} (x {lo % o.width} of row {lo // o.width}), {blk - real} pad "
            f"rows]: {frac:.6f} within rtol=atol=5e-3, {exact:.6f} bit-equal, max abs diff "
            f"{err:.6g}; plain {plain_r_ms:.1f} ms; rows bit-equal to the whole-frame launch's; "
            f"worst pixel {pid} (x {pid % o.width}, y {pid // o.width}): range {err:.6g}, "
            f"whole-frame launch vs that pixel's plain {err_w:.6g}")
        require(frac >= MIN_PIXELS_OK, f"{kname} pixel range agrees on {frac:.4%} < 99.5%")
        require(blk > real and torch.equal(a_k[real:], a_k[real - 1:real].expand(blk - real, 3)),
                f"{kname} pixel range: the pad rows differ from pixel N-1's row")
        require(torch.equal(g_k, k1.tonemap_pack_plain(a_k, o.gamma)),
                f"{kname} pixel range: the packed rows differ from K1's plain pack")
        if o.reflectIter > 0:
            k2c_err = max(k2c_err, err)
        else:
            k2_err = max(k2_err, err)
        multi[f"range_{mat_r}"] = dict(agree=frac, max_abs_err=err, plain_ms=plain_r_ms)

    def frames_of(fn, n=3):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            res_ = fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out, res_

    # the main path over 4 tiles of cuda:0: its digests are the untiled frame's
    mesh4 = tiling.make_mesh([dev] * 4)
    tiling.render_image_tiled(vol, opts, tables, mesh=mesh4, accel=bricks)  # warm-up
    zero_counts()
    fr_t, (argb_t, acc_t) = frames_of(
        lambda: tiling.render_image_tiled(vol, opts, tables, mesh=mesh4, accel=bricks))
    cnt_tiled = counts()
    require(cnt_tiled == {"K1": 0, "K2": 12, "K2c": 0, "packs": 12},
            f"tiled main path: expected 4 packing K2 launches a frame, got {cnt_tiled}")
    require(frame_digests(acc_t, argb_t) == DIGESTS["ao"],
            f"tiled main path differs from the untiled frame: {frame_digests(acc_t, argb_t)}")
    t_blk = n_px // 4

    def tile_launch(t):
        k2.render_passes(vol, opts, tables, times, acc_k[t * t_blk:(t + 1) * t_blk], bricks,
                         argb_k[t * t_blk:(t + 1) * t_blk], pix_lo=t * t_blk, pix_count=t_blk)

    k2_tiles_ms = bench_prims.kernel_ms(lambda: [tile_launch(t) for t in range(4)], 4)
    # each row band alone: on a card of its own, a tiled frame waits for the slowest
    k2_tile_ms = [bench_prims.kernel_ms(lambda t=t: tile_launch(t), 4) for t in range(4)]
    log(f"main path tiled over 4 x cuda:0 (render_image_tiled): frames "
        f"{['%.4f' % f for f in fr_t]} s, median {sorted(fr_t)[1]:.4f} s (untiled {frame_s:.4f});"
        f" launches {cnt_tiled}; K2's 4 tile launches {k2_tiles_ms:.4f} ms a frame (one launch "
        f"{k2_pack_ms:.4f}; each tile alone {['%.4f' % m for m in k2_tile_ms]} ms); accum and "
        f"argb sha256 equal the untiled frame's")
    # the metal frame's first pass, tiled the same way
    argb_m1, acc_m1 = render_mod.render_image(vol, opts_m, tables[:1], times[:1], accel=bricks)
    zero_counts()
    argb_mt, acc_mt = tiling.render_image_tiled(vol, opts_m, tables[:1], times[:1], mesh=mesh4,
                                                accel=bricks)
    cnt_mt = counts()
    require(np.array_equal(argb_mt, argb_m1) and torch.equal(acc_mt, acc_m1),
            "tiled metal first pass differs from the untiled one")
    log(f"metal first pass at 512^2 tiled over 4 x cuda:0: bit-equal to untiled; launches "
        f"{cnt_mt}")
    # the main path's passes sharded 4 ways, and over a 2x2 (passes, tiles) mesh
    for key, mesh_p, fn_p in (("spp 4", mesh4, tiling.render_image_spp_sharded),
                              ("2d 2x2", tiling.make_mesh2d(2, 2, [dev] * 4),
                               tiling.render_image_2d)):
        fn_p(vol, opts, tables, mesh=mesh_p, accel=bricks)  # warm-up
        zero_counts()
        fr_p, (argb_p, acc_p) = frames_of(lambda: fn_p(vol, opts, tables, mesh=mesh_p,
                                                       accel=bricks))
        cnt_p = counts()
        require(cnt_p == {"K1": 3, "K2": 12, "K2c": 0, "packs": 0},
                f"{key}: expected 4 K2 launches and K1 alone a frame, got {cnt_p}")
        close = bool(torch.allclose(acc_p, accum, rtol=2e-5, atol=1e-6))
        err_p = float((acc_p - accum).abs().max())
        flips = float((argb_p != argb).mean())
        log(f"main path {key} over cuda:0 ({fn_p.__name__}): frames "
            f"{['%.4f' % f for f in fr_p]} s, median {sorted(fr_p)[1]:.4f} s; launches {cnt_p}; "
            f"accum within rtol=2e-5, atol=1e-6 of one launch: {close} (max abs diff "
            f"{err_p:.3g}); packed pixels differing {flips:.6f}")
        require(close and flips < 0.01, f"{key}: accum or image off the one-launch frame")
        multi[key] = dict(frames_s=fr_p, launches=cnt_p, max_abs_err=err_p, argb_differ=flips)
    # two processes in a gloo group, each rendering its tile on cuda:0
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    env2 = dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "raymarchcl_tpu_torch.scripts.render_tiled",
                               "--backend", "gloo"], cwd=REPO, env=dict(env2, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [proc.communicate(timeout=300) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    two_s = time.perf_counter() - t0
    for proc, (out, err_txt) in zip(procs, outs):
        require(proc.returncode == 0,
                f"render_tiled rank exited {proc.returncode}: {err_txt[-2000:]}")
    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for r_ in ranks:
        require((r_["accum_sha256"], r_["argb_sha256"]) == DIGESTS["ao"] and r_["world"] == 2
                and r_["initialize"] == [True, False],
                f"two-process tiled main path: rank {r_['rank']} got {r_}")
    log(f"two processes (gloo, each rank on cuda:0) render_tiled of the main path "
        f"(512^2, 16 spp): {two_s:.2f} s of processes, render_image_tiled "
        f"{[round(r_['seconds'], 4) for r_ in ranks]} s; both ranks hold the untiled frame's "
        f"accum and argb sha256")
    multi["two_processes"] = dict(process_s=two_s, render_s=[r_["seconds"] for r_ in ranks])
    # diagnostics of utils/: the hit fraction of the main path, the occupancy
    # of a 128^2 primary pass (the plain march on CUDA tensors)
    t0 = time.perf_counter()
    hit_frac = metrics.measured_hit_fraction(vol, opts, tables[0], bricks)
    torch.cuda.synchronize()
    hit_s = time.perf_counter() - t0
    require(0.0 < hit_frac <= 1.0, f"measured_hit_fraction {hit_frac}")
    o128 = render_options(width=128, height=128, iter=1, **main_kw)
    st128 = init_render_state(o128, tables[0], torch.arange(o128.num_pixels, device=dev))
    rp, rd = camera_ray_lookat(o128, st128)
    t0 = time.perf_counter()
    occ = stats.raymarch_occupancy(vol, o128, rp, rd, o128.maxDist, o128.maxIter,
                                   torch.ones(o128.num_pixels, dtype=torch.bool, device=dev),
                                   accel=bricks)
    occ_s = time.perf_counter() - t0
    require(occ["rounds"] > 1 and 0.0 <= occ["wasted_lane_ratio"] < 1.0, f"occupancy {occ}")
    log(f"measured_hit_fraction (main path, 512^2 primary pass, brick table): {hit_frac:.6f} "
        f"in {hit_s:.3f} s; raymarch_occupancy (128^2): {occ['rounds']} rounds, "
        f"wasted_lane_ratio {occ['wasted_lane_ratio']:.4f}, {occ_s:.3f} s")
    multi.update(hit_fraction=hit_frac, hit_fraction_s=hit_s, occupancy_rounds=occ["rounds"],
                 wasted_lane_ratio=occ["wasted_lane_ratio"], occupancy_s=occ_s)
    # the gallery at its defaults (256x144, 2 spp) on the card
    zero_counts()
    with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        gal_paths = gallery.main([td])
        gal_s = time.perf_counter() - t0
        gal_imgs = [np.asarray(Image.open(p_).convert("RGB")) for p_ in gal_paths]
    cnt_gal = counts()
    require(len(gal_imgs) == 6 and all(im.shape == (144, 256, 3) and im.std() > 1.0
                                       for im in gal_imgs), "gallery: six PNGs, none flat")
    require(cnt_gal == {"K1": 0, "K2": 6, "K2c": 4, "packs": 6},
            f"gallery: expected six packing launches, four of them K2c, got {cnt_gal}")
    log(f"gallery (scripts/gallery.py, 256x144, 2 spp): six PNGs in {gal_s:.2f} s; launches "
        f"{cnt_gal}")
    multi.update(tiled_frames_s=fr_t, tiled_launches=cnt_tiled, k2_tiles_ms=k2_tiles_ms,
                 k2_tile_ms=k2_tile_ms, gallery_s=gal_s, phase_s=time.perf_counter() - t_phase)
    log(f"multi-device phase: {multi['phase_s']:.1f} s")

    # -- 8g. the headline benchmark and the measurement scripts ------------
    from raymarchcl_tpu_torch.scripts import bench_anim, preview_quality, run_configs

    t_phase = time.perf_counter()
    entry = {}
    # python -m raymarchcl_tpu_torch bench at its defaults: its gate, one
    # JSON line; the launch counts of its timed frames come from its stderr
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "raymarchcl_tpu_torch", "bench"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    require(r.returncode == 0, f"bench exited {r.returncode}: {r.stderr[-2000:]}")
    b = json.loads(r.stdout.strip().splitlines()[-1])
    m = re.search(r"launches in the (\d+) timed frames: (\{.*\})", r.stderr)
    require(m is not None, f"bench printed no launch counts: {r.stderr[-2000:]}")
    cnt_bench = json.loads(m[2])
    require(b["invariants"] is True and "invariant main_path_digests: OK" in r.stderr
            and b["metric"] == "gyroid512_16spp_ao_frame_time" and len(b["samples"]) == 5
            and b["device"] == card and b["value"] == sorted(b["samples"])[2],
            f"bench: {b}; {r.stderr[-1000:]}")
    require(cnt_bench == {"K1": 0, "K2": 5, "K2c": 0, "packs": 5},
            f"bench: expected one packing K2 launch a timed frame, got {cnt_bench}")
    entry["bench"] = dict(b, process_s=bench_s, launches=cnt_bench)
    log(f"bench (python -m raymarchcl_tpu_torch bench, {bench_s:.2f} s of process): value "
        f"{b['value']:.6f} s, samples {['%.6f' % x for x in b['samples']]}, hit fraction "
        f"{b['primary_hit_fraction']:.6f}, invariants {b['invariants']} ("
        + ", ".join(re.findall(r"invariant (\w+): OK", r.stderr)) + f"); launches {cnt_bench}")
    # the five BASELINE configs in process at full spp (config 5 at the JAX
    # script's 4): each frame keeps its digests; configs 1 and 2 are also
    # held to the plain version on their first pass
    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rows = run_configs.main([])
    cnt_cfg = counts()
    for row in rows:
        log(f"run_configs {row['config']}: {row['width']}x{row['height']}, {row['spp']} spp, "
            f"{row['seconds']:.6f} s; accum sha256 {row['accum_sha256']}; argb sha256 "
            f"{row['argb_sha256']}; digests equal {row['digests_equal']}")
    require(all(row["digests_equal"] is True for row in rows) and len(rows) == 5,
            "run_configs: a config's frame differs from its DIGESTS entry")
    # two frames a config, a launch of up to 16 passes each (config 2: two)
    require(cnt_cfg == {"K1": 0, "K2": 12, "K2c": 4, "packs": 12},
            f"run_configs: expected 12 packing launches, 4 of them K2c, got {cnt_cfg}")
    for key, w_c, n_c, kw_c in (("config 1", 224, 1, {}), ("config 2", 512, 25, {"fogPow": 0.1})):
        o = render_options(width=w_c, height=w_c, iter=n_c, vres=list(res), mat="ao",
                           **camera(CAM), **kw_c)
        agree_c, plain_c_ms, _ = first_pass_vs_plain(
            f"{key} {w_c}^2 ao 1 pass vres256 brick table{', fogPow 0.1' if kw_c else ''}", vol,
            o.replace(time=times[0]), make_mc_tables(n_c, seed=0, device=dev)[0], bricks)
        k2_err = max(k2_err, agree_c[2])
        entry[key] = dict(agree_pass=agree_c[0], max_abs_err_pass=agree_c[2],
                          plain_ms_pass=plain_c_ms)
    entry["run_configs"] = dict(rows=rows, launches=cnt_cfg)
    # bench_anim with 3 steady frames, preview_quality at its defaults
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        anim = bench_anim.main(["--frames", "3"])
    cnt_banim = counts()
    require(cnt_banim == {"K1": 0, "K2": 8, "K2c": 0, "packs": 8} and anim["device"] == card
            and len(anim["steady_state_s_per_frame"]) == 3,
            f"bench_anim: {anim}, launches {cnt_banim} (expected 4 frames and 4 previews)")
    log(f"bench_anim (512^2, 2 spp, ao, 3 steady frames): first frame "
        f"{anim['first_frame_incl_compile_s']:.4f} s, steady "
        f"{['%.6f' % x for x in anim['steady_state_s_per_frame']]} s, preview 256^2 "
        f"{anim['preview_256_s']:.6f} s; launches {cnt_banim}")
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        pq = preview_quality.main([])
    cnt_pq = counts()
    require(cnt_pq == {"K1": 0, "K2": 4, "K2c": 0, "packs": 4} and 0.0 < pq["ssim"] <= 1.0,
            f"preview_quality: {pq}, launches {cnt_pq} (expected 2 full and 2 preview frames)")
    log(f"preview_quality (256^2, ao, full 4 spp vs preview): full {pq['full_s']:.6f} s, preview "
        f"{pq['preview_s']:.6f} s, speed-up {pq['speedup']:.3f}x, SSIM {pq['ssim']:.4f}; "
        f"launches {cnt_pq}")
    entry.update(bench_anim=dict(anim, launches=cnt_banim),
                 preview_quality=dict(pq, launches=cnt_pq), phase_s=time.perf_counter() - t_phase)
    log(f"entry-point phase: {entry['phase_s']:.1f} s")

    # -- 8h. the card's frames against the JAX package's at full size --------
    t_phase = time.perf_counter()
    reference_phase(dev, {"gyroid": (vol_np, 256), "voxelize_ks(64, 1)": (vol3, 64),
                          "voxelize_scatter(128, seed=3)": (vol4, 128)},
                    {"ao-512": accum, "config-3": accum_8b["config 3"]})
    log(f"reference phase: {time.perf_counter() - t_phase:.1f} s")

    # -- 9. the kernels line ---------------------------------------------------
    # K1 on its own reads accum and writes the image; fused, it writes the
    # image from registers
    k1_bound, k1_fused_bound = bound(n_px * 16, 0), bound(n_px * 4, 0)
    # a frame: the volume, 16 MC tables, the brick rows and the pass times
    # read once, accum read and written, the image written; 9 operations per
    # march sample the counting build took (the raw march's: the plain
    # version's 1-pass count times 16)
    k2_bytes = (vol.numel() + tables.numel() * 4 + 2 * n_px * 12 + n_px * 4
                + bricks.rows.numel() * 4 + times.numel() * 4)
    k2_bound = bound(k2_bytes, k2_lanes["samples"] * OPS_PER_SAMPLE)
    k2_raw_bound = bound(k2_bytes - bricks.rows.numel() * 4,
                         16 * plain["raw"]["samples"] * OPS_PER_SAMPLE)
    # K2c: the same bytes, the march samples of the metal frame
    k2c_bound = bound(k2_bytes, k2c_lanes["samples"] * OPS_PER_SAMPLE)
    # E bounds: each table element the rounds touch counts once, at these inputs
    reps, k, lanes = prims.REPS_IN, prims.K, prims.LANES
    e1_rows = touched(x["e1_sidx"].cpu().numpy()[:, None], prims.S, reps)
    e2_elems = {d: touched(x[f"e2_idx_{d}"].cpu().numpy(), d, reps) for d in prims.E2_DEPTHS}
    e3_words = touched(x["e3_w"].cpu().numpy().reshape(1, -1), lanes,
                       reps // prims.E3_U + prims.E3_U - 1)
    trips = int(x["e5_x_timed"][:, 0].max())
    e2_bound = {d: bound(e2_elems[d] * 4 + 2 * 8 * lanes * 4, reps * 8 * lanes)
                for d in prims.E2_DEPTHS}
    e_bounds = {
        "E1": bound(e1_rows * lanes * 4 + k * 4 + k * lanes * 4, 0),
        "E2": e2_bound[4096],
        "E3": bound(e3_words * 4 + 3 * k * 4, reps * k * 4),
        "E4": bound(2 * k * lanes * 4, reps * k * lanes),
        "E5": bound(2 * 8 * lanes * 4 + 4, trips * 8),
    }
    log(f"E bounds count: E1 {e1_rows} of {prims.S} table rows, E2 {e2_elems} table "
        f"elements by depth, E3 {e3_words} of {k * lanes} row words, E5 {trips} trips")
    path_counts = {
        "main": dict(launches, packs=packs), "metal path": dict(launches_m, packs=packs_m),
        "config 3": configs["config 3"]["launches"], "config 4": configs["config 4"]["launches"],
        "config 5 straight": cnt_straight5, "config 5 chunked": cnt_chunked5,
        "config 5 fully resumed": cnt_resume5, "test_anim": cnt_anim,
        "main tiled 4 x cuda:0": cnt_tiled, "metal first pass tiled": cnt_mt,
        "main spp 4": multi["spp 4"]["launches"], "main 2d 2x2": multi["2d 2x2"]["launches"],
        "gallery": cnt_gal, "bench (timed frames)": cnt_bench, "run_configs": cnt_cfg,
        "bench_anim": cnt_banim, "preview_quality": cnt_pq}
    kernels = [
        # the main path packs in K2's epilogue (`launches`: its packs); ms
        # and bound_ms are the kernel on its own, which render.pack_argb runs
        kernel_entry("K1 tonemap_pack", "raymarchcl_tpu_torch/csrc/tonemap.cu",
                     "raymarchcl_tpu/ops/kernels/tonemap_pallas.py:37", packs, k1_err,
                     k1_ms, k1_plain_ms, k1_bound, None, launches_standalone=cnt_resume5["K1"],
                     launches_standalone_on="config 5 fully resumed (render.pack_argb)",
                     launches_by_path={p_: {"fused": c["packs"], "alone": c["K1"]}
                                       for p_, c in path_counts.items()},
                     fused_in="raymarchcl_tpu_torch/csrc/render_pass.cu", fused_ms=fused_ms,
                     bound_ms_fused=k1_fused_bound[0]),
        kernel_entry("K2 render_pass", "raymarchcl_tpu_torch/csrc/render_pass.cu",
                     "raymarchcl_tpu/ops/render.py:56", launches["K2"], k2_err, k2_pack_ms,
                     plain_frame_ms, k2_bound, None, ms_per_pass=k2_pack_ms / 16,
                     ms_without_pack=k2_ms, ms_tiled_4=k2_tiles_ms,
                     ms_raw=k2_raw_ms, plain_ms_per_pass=plain["accel"]["ms"],
                     plain_ms_per_pass_raw=plain["raw"]["ms"], bound_ms_raw=k2_raw_bound[0],
                     samples=k2_lanes["samples"],
                     plain_samples_per_pass=plain["accel"]["samples"],
                     plain_samples_per_pass_raw=plain["raw"]["samples"],
                     active_lanes={n: k2_lanes[n]["active"] for n in k2.COUNTED_LOOPS},
                     warp_iterations={n: k2_lanes[n]["iters"] for n in k2.COUNTED_LOOPS},
                     launches_by_path={p_: c["K2"] - c["K2c"] for p_, c in path_counts.items()},
                     ptxas={n: v for n, v in k2_regs.items() if n.startswith("K2 ")}),
        # the bounce loop of shade_after_march (shade.py:363) in K2's
        # reflective instance; ms is a metal frame at 512^2 (16 passes),
        # plain_ms the plain version's 2 passes at 64x48
        kernel_entry("K2c render_pass (reflective)", "raymarchcl_tpu_torch/csrc/render_pass.cu",
                     "raymarchcl_tpu/ops/shade.py:363", launches_m["K2c"], k2c_err,
                     sum(k2c_ms) / 2, k2c_cases["metal"][1], k2c_bound, None,
                     ms_runs=k2c_ms, ms_per_pass=sum(k2c_ms) / 32, frame_s=frame_m_s,
                     plain_size="64x48, 2 passes, vres 64",
                     plain_ms_512_pass=k2c_plain512_ms, agree_512_pass=k2c_512[0],
                     max_abs_err_512_pass=k2c_512[2],
                     plain_samples_512_pass=k2c_plain512_samples,
                     plain_ms_by_preset={m: v[1] for m, v in k2c_cases.items()},
                     max_abs_err_by_preset={m: v[0] for m, v in k2c_cases.items()},
                     samples=k2c_lanes["samples"],
                     active_lanes={n: k2c_lanes[n]["active"] for n in k2.COUNTED_LOOPS},
                     warp_iterations={n: k2c_lanes[n]["iters"] for n in k2.COUNTED_LOOPS},
                     accum_sha256=digest_m, argb_sha256=argb_digest_m,
                     launches_by_path={p_: c["K2c"] for p_, c in path_counts.items()},
                     ptxas={n: v for n, v in k2_regs.items() if n.startswith("K2c")}),
    ]
    srcs = {"E1": ("e1_row_fetch", 71), "E2": ("e2_sublane_gather", 107),
            "E3": ("e3_probe", 136), "E4": ("e4_transpose", 174), "E5": ("e5_while", 199)}
    for key, (fn, line) in srcs.items():
        b = "E2/4096" if key == "E2" else key
        extra = {}
        if key == "E2":
            extra = dict(ms_by_depth={d: bench[f"E2/{d}"]["us"] / 1e3 for d in prims.E2_DEPTHS},
                         plain_ms_by_depth={d: e_plain_ms[f"E2/{d}"] for d in prims.E2_DEPTHS},
                         bound_ms_by_depth={d: e2_bound[d][0] for d in prims.E2_DEPTHS},
                         equal_reads_ms=e2_equal_ms)
        if key == "E1":
            extra = dict(ms_reps16=e1_16, ms_reps64=e1_64, equal_reads_ms=e1_equal_ms,
                         row_bytes_per_s=e1_rate)
        if key == "E3":
            extra = dict(lanes_per_ray=e3_lanes, ms_reps64=e3_64, ms_reps1024=e3_1024)
        if key == "E4":
            extra = dict(ms_reps16=e4_16, ms_reps1024=e4_1024, smem_bytes_per_s=e4_rate)
        if key == "E5":
            extra = dict(trips=trips, ms_trips100=e5_100 / 1e3,
                         ns_per_trip=bench["E5"]["ns_per_trip"])
        kernels.append(kernel_entry(
            f"{key} {fn}", "raymarchcl_tpu_torch/csrc/prims.cu",
            f"scripts/bench_pallas_prims.py:{line}", e_launches[key],
            max(v for k_, v in e_err.items() if k_.split("/")[0] == key),
            bench[b]["us"] / 1e3, e_plain_ms[b], e_bounds[key],
            {"E1": e1_lib_ms, "E4": e4_lib_ms}.get(key), **extra))
    log(json.dumps({"kernels": kernels, "launch_floor_ms": bench["floor"]["us"] / 1e3,
                    "frame_s": frame_s, "frame_raw_s": frame_raw_s, "frame_metal_s": frame_m_s,
                    "busy_untraced": busy, "accum_sha256": digest, "argb_sha256": argb_digest,
                    "accel_build_s": t_accel, "configs": configs,
                    "new_inputs": {k: {"max_abs_err": v[0], "plain_ms": v[1]}
                                   for k, v in new_cases.items()}, "multi_device": multi,
                    "entry_points": entry, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
