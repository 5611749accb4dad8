"""A CPU model of a pooled schedule for K2c, held bit for bit to the plain
version.

K2c, the reflective instances of csrc/render_pass.cu, shades each pixel's
pass in one thread: its primary ray, its bounces, and each shading point's
AO probes and shadow rays, in the reference's order. The pooled schedule
modelled here splits that work over a warp's 8x4 pixels in three phases:
(1) each lane marches its chain (the primary ray, then its bounces,
BOUNCE_SLOTS a segment) into a pool of shading points; (2) the warp's AO
probes and shadow rays are numbered over the pool, light- or probe-major
(task t: point t % n of the n points compacted in slot order, light or
probe t // n), and lane l runs tasks l, l + 32, ...; the probes run in
chunks of PROBE_CHUNK, speculatively, and fold in probe order with
ambient_occlusion's stop; (3) each lane combines its bounces in order and
lights its primary point last with their sum. PERF.md §6 records this
schedule's kernels measured on the H100; none was faster than the
per-thread loop, which K2c keeps. The model runs the three phases with the
plain functions (the chains from raymarch's per-level hit records, the
tasks evaluated in a shuffled order, the combine in the reference's order)
and must give `render_pass_plain`'s accum exactly (torch.equal): pooling
changes no pixel."""

import os
import re

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel as accel_mod
from raymarchcl_tpu_torch.ops import march, sampling, shade
from raymarchcl_tpu_torch.ops.camera import camera_ray_lookat, compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import build
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.vecmath import (V3, fma, fma3, normalize, reflect, reflect_fused,
                                              where3)
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

_SRC = open(os.path.join(build.CSRC_DIR, "render_pass.cu")).read()
TILE_W, TILE_H = (int(v) for v in re.search(r"kTileW = (\d+), kTileH = (\d+);", _SRC).groups())
BOUNCE_SLOTS = 3  # bounces a segment of the pool holds (slots: 32 a level)
PROBE_CHUNK = 6  # AO probes run between two folds
VRES = [40, 40, 48]


def _stack(recs, key):
    """A per-level field as (levels, N) tensors (V3 fields as a V3)."""
    if isinstance(recs[0][key], V3):
        return V3(*(torch.stack([getattr(r[key], c) for r in recs]) for c in "xyz"))
    return torch.stack([r[key] for r in recs])


def _take(v, lev, pix):
    return V3(v.x[lev, pix], v.y[lev, pix], v.z[lev, pix]) if isinstance(v, V3) else v[lev, pix]


def chains(vol, opts, table, accel):
    """Phase 1: each pixel's chain. Level 0 is the primary hit (smooth
    normal, glossy norm_p), level b its b-th bounce (reflect_fused about the
    last normal, origin at 0.0075, fast normal); `point` marks a lit point,
    `reached` a ray the chain marched."""
    n = opts.num_pixels
    state = sampling.init_render_state(opts, table, torch.arange(n))
    ray_pos, ray_dir = camera_ray_lookat(opts, state)
    ones = torch.ones(n, dtype=torch.bool)
    isec = march.raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, ones,
                          accel=accel)
    hit = isec["distance"] < opts.maxDist
    mat = torch.clamp(isec["object_id"], 0, 3)
    _, r0, smoothness = shade.mat_gather(opts, mat)
    norm_p = fma3(state["mc_normal"], 1.0 / (smoothness * 200.0 + 5.0), isec["normal"])
    levels = [dict(pos=isec["pos"], n=norm_p, dir=ray_dir, org=ray_pos, dist=isec["distance"],
                   mat=mat, point=hit, reached=ones)]
    alive = hit & (r0 > 0.0)
    r_dir, r_pos, r_norm = ray_dir, isec["pos"], norm_p
    for _ in range(opts.reflectIter):
        r_dir = where3(alive, reflect_fused(r_dir, r_norm), r_dir)
        origin = fma3(r_dir, 0.0075, r_pos)
        b = march.raymarch(vol, opts, origin, r_dir, opts.maxDist, opts.maxIter, alive,
                           accel=accel, smooth=False)
        b_hit = b["object_id"] >= 0
        b_mat = torch.clamp(b["object_id"], 0, 3)
        levels.append(dict(pos=b["pos"], n=b["normal"], dir=r_dir, org=origin,
                           dist=b["distance"], mat=b_mat, point=alive & b_hit, reached=alive))
        alive = alive & b_hit & (opts.mat_r0[b_mat] >= 0.001)
        r_pos, r_norm = b["pos"], b["normal"]
    return state, levels


def lane_pixels(opts):
    """(warps, 32) pixel ids of each warp's lanes under the kernel's 8x4
    tiles, -1 for a lane outside a ragged frame."""
    w, h = opts.resolution
    tiles_x, tiles_y = -(-w // TILE_W), -(-h // TILE_H)
    out = np.full((tiles_x * tiles_y, 32), -1, np.int64)
    for t in range(tiles_x * tiles_y):
        for lane in range(32):
            x = (t % tiles_x) * TILE_W + lane % TILE_W
            y = (t // tiles_x) * TILE_H + lane // TILE_W
            if x < w and y < h:
                out[t, lane] = y * w + x
    return out


def segment_levels(reflect_iter, seg):
    """The chain levels in a segment's slots (slot level 0 is the primary
    hit, in segment 0 only)."""
    first = 1 + seg * BOUNCE_SLOTS
    bounces = list(range(first, min(first + BOUNCE_SLOTS, reflect_iter + 1)))
    return ([0] if seg == 0 else []) + bounces


def number_tasks(pixels, live, seg_levels, k):
    """The kernel's numbering of one segment's tasks: per warp the live
    points compacted in slot order (slot = level-in-segment * 32 + lane;
    a lane outside the frame holds none), task t -> (point t % n, index
    t // n) of the n points, lane t % 32 running it. `live` (levels, N)
    marks the points; returns (level, pixel, index, lane) rows of every
    warp's tasks."""
    rows = []
    for lanes in pixels:
        points = [(level, lanes[lane]) for level in seg_levels for lane in range(32)
                  if lanes[lane] >= 0 and bool(live[level, lanes[lane]])]
        n = len(points)
        rows += [(*points[t % n], t // n, t % 32) for t in range(n * k)]
    return np.array(rows, np.int64).reshape(-1, 4)


def shuffled(rows, rng):
    """Tasks in a random order, in a few uneven batches (lanes take them as
    they come free)."""
    rows = rows[rng.permutation(len(rows))]
    cuts = np.sort(rng.integers(0, len(rows) + 1, 3))
    return [b for b in np.split(rows, cuts) if len(b)]


def skipped_shadow(opts, lmax):
    """The shadow factor of a ray the kernel does not march (out of range
    or irrelevant): what raymarch(active=False) gives, distance startDist,
    rewritten to 1000 when startDist >= lmax."""
    start = torch.full_like(lmax, float(opts.startDist))
    return (torch.where(start >= lmax, 1000.0, start) >= lmax).float()


def run_shadows(vol, opts, table, state, recs, batch, accel):
    """Shadow tasks (level, pixel, light): shade.light_geometry's ray of the
    task's light, its sf by shade.shadow where the ray is marched. Returns
    (sf, marched)."""
    lev, pix, light = (torch.from_numpy(batch[:, i]) for i in range(3))
    pos, n, d = (_take(_stack(recs, key), lev, pix) for key in ("pos", "n", "dir"))
    lt = shade.light_geometry(opts, table, state["px"][pix], state["py"][pix], pos, d, n,
                              torch.ones(len(lev), dtype=torch.bool))
    idx = torch.arange(len(lev))

    def pick(key):
        vals = [l[key] for l in lt]
        if isinstance(vals[0], V3):
            return V3(*(torch.stack([getattr(v, c) for v in vals])[light, idx] for c in "xyz"))
        return torch.stack(vals)[light, idx]

    org, ldir, lmax, act = pick("origin"), pick("ldir"), pick("lmax"), pick("act")
    sf = skipped_shadow(opts, lmax)
    if bool(act.any()):
        a = act.nonzero()[:, 0]
        sf[a] = shade.shadow(vol, opts, V3(org.x[a], org.y[a], org.z[a]),
                             V3(ldir.x[a], ldir.y[a], ldir.z[a]), lmax[a],
                             torch.ones(len(a), dtype=torch.bool), accel)
    return sf, act


def run_probes(vol, opts, table, recs, batch, accel):
    """AO tasks (level, pixel, probe): one probe of shade.ambient_occlusion
    each; returns its factor 1 - max((d - dist) * aoAmp * (1/d), 0)."""
    lev, pix, probe = (torch.from_numpy(batch[:, i]) for i in range(3))
    pos, n = (_take(_stack(recs, key), lev, pix) for key in ("pos", "n"))
    steps = opts.maxVoxelIter // 2
    probes = range(opts.aoIter + 1)
    d = torch.tensor([shade.ao_step_dist(opts, i) for i in probes], dtype=torch.float32)[probe]
    cap = torch.tensor([shade.ao_trunc_steps(opts, steps, i) for i in probes])[probe]
    seed = (sampling.ao_seed(opts, pos) + 37 * (probe + 1)) & sampling.U32_MASK
    j = sampling.rand_xyz(table, seed)
    sn = normalize(V3(fma(j.x, 0.2, n.x), fma(j.y, 0.2, n.y), fma(j.z, 0.2, n.z)))
    sd = march.distance_to_scene(vol, opts, fma3(sn, d, pos), sn, steps,
                                 torch.ones(len(lev), dtype=torch.bool), max_k_dyn=cap,
                                 want_material=False, accel=accel)
    return 1.0 - torch.clamp((d - sd["dist"]) * opts.aoAmp * (1.0 / d), min=0.0)


def model_pass(vol, opts, table, accum, accel=None, seed=0, log=None):
    """One pass through the three phases; returns the blended accum (a new
    tensor). `log`, a dict, collects the tasks run: 'ao' (level, pixel,
    probe) rows, 'ao_speculative' those the fold skipped, 'shadow' (level,
    pixel, light) rows and 'marched' their flags, 'pixels' the lane map."""
    rng = np.random.default_rng(seed)
    state, recs = chains(vol, opts, table, accel)
    n_lev, n, n_lights = len(recs), opts.num_pixels, opts.numLights
    point = _stack(recs, "point")
    pixels = lane_pixels(opts)
    ao = torch.ones(n_lev, n)
    sf = torch.zeros(n_lev, n, n_lights)
    log = {} if log is None else log
    log.update(pixels=pixels, ao=[], ao_speculative=[], shadow=[], marched=[])
    # phase 2, segment by segment
    n_seg = 1 + max(0, -(-opts.reflectIter // BOUNCE_SLOTS) - 1)
    for seg in range(n_seg):
        levels = segment_levels(opts.reflectIter, seg)
        in_seg = torch.zeros(n_lev, 1, dtype=torch.bool)
        in_seg[levels] = True
        tasks = number_tasks(pixels, point, levels, n_lights)[:, :3]
        for batch in shuffled(tasks, rng):
            got, marched = run_shadows(vol, opts, table, state, recs, batch, accel)
            sf[batch[:, 0], batch[:, 1], batch[:, 2]] = got
            log["shadow"].append(batch)
            log["marched"].append(marched.numpy())
        for c0 in range(0, opts.aoIter + 1, PROBE_CHUNK):
            nk = min(PROBE_CHUNK, opts.aoIter + 1 - c0)
            live = point & in_seg & (ao > 0.01)
            tasks = number_tasks(pixels, live, levels, nk)[:, :3]
            fac = torch.zeros(n_lev, n, nk)
            for batch in shuffled(tasks, rng):
                fac[batch[:, 0], batch[:, 1], batch[:, 2]] = run_probes(
                    vol, opts, table, recs, batch + [0, 0, c0], accel)
                log["ao"].append(batch + [0, 0, c0])
            # the fold: the chunk's factors in probe order while ao > 0.01
            for j in range(nk):
                go = live & (ao > 0.01)
                spec = live & ~go
                log["ao_speculative"] += [(lv, px, c0 + j) for lv, px in spec.nonzero().tolist()]
                ao = torch.where(go, ao * fac[:, :, j], ao)
    # phase 3: the bounces in order, then the primary point with their sum
    px, py = state["px"], state["py"]
    acc = V3(*(torch.zeros(n) for _ in range(3)))
    for b in range(1, n_lev):
        r = recs[b]
        albedo, r0, smoothness = shade.mat_gather(opts, r["mat"])
        lt = shade.light_geometry(opts, table, px, py, r["pos"], r["dir"], r["n"], r["point"])
        lit = shade.light_combine(opts, r["dir"], r["n"], albedo, r0, smoothness,
                                  shade.sky_gradient(opts, reflect(r["dir"], r["n"])), ao[b], lt,
                                  [sf[b, :, i] for i in range(n_lights)])
        col = where3(r["point"], lit, shade.sky_gradient(opts, r["dir"]))
        acc = where3(r["reached"], acc + shade.apply_atmosphere(
            opts, table, px, py, r["org"], r["dir"], r["dist"], col), acc)
    r = recs[0]
    albedo, r0, smoothness = shade.mat_gather(opts, r["mat"])
    reflect_col = shade.sky_gradient(opts, reflect(r["dir"], r["n"]))
    if opts.reflectIter > 0:
        reflect_col = where3(r0 > 0.0, acc, reflect_col)
    lt = shade.light_geometry(opts, table, px, py, r["pos"], r["dir"], r["n"], r["point"])
    lit = shade.light_combine(opts, r["dir"], r["n"], albedo, r0, smoothness, reflect_col, ao[0],
                              lt, [sf[0, :, i] for i in range(n_lights)])
    col = where3(r["point"], lit, shade.sky_gradient(opts, r["dir"]))
    col = shade.apply_atmosphere(opts, table, px, py, r["org"], r["dir"], r["dist"], col)
    return fma((col * opts.exposure).to_array() - accum, opts.frameBlend, accum)


@pytest.fixture(scope="module")
def volume():
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": VRES}))
    return vol, accel_mod.build_accel(vol, VRES, 32)


def _opts(mat, width=12, height=8, t=0.333, **kw):
    return render_options(width=width, height=height, vres=VRES, iter=1, t=t, mat=mat,
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0],
                          maxIter=48, maxVoxelIter=96, shadowIter=48, **kw)


FOUR_LIGHTS = dict(
    numLights=4,
    lightPos=torch.tensor([[0, 2, 0, 0], [3, 0, 3, 0], [-2, 1, 2, 0], [1, 3, -1, 0]],
                          dtype=torch.float32),
    lightColor=torch.tensor([[28, 18, 8, 0], [16, 36, 56, 0], [10, 20, 30, 0], [30, 10, 5, 0]],
                            dtype=torch.float32))
CASES = {
    **{f"{mat}-{mode}": (mat, mode, {}) for mat in ("metal", "metal2", "orange-stripes")
       for mode in ("table", "raw")},
    "metal-aoIter16": ("metal", "table", dict(aoIter=16)),
    "metal-4lights": ("metal", "table", FOUR_LIGHTS),
    "metal-reflectIter5": ("metal", "table", dict(reflectIter=5)),  # two segments
    "metal-aoAmp4": ("metal", "raw", dict(aoAmp=torch.tensor(4.0))),  # the AO stop fires
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_bit_equal_to_plain(volume, case):
    mat, mode, changes = CASES[case]
    vol, bricks = volume
    acc_in = bricks if mode == "table" else None
    opts = _opts(mat).replace(**changes)
    table = sampling.make_mc_tables(1, seed=3)[0]
    accum = torch.from_numpy(np.random.default_rng(5).uniform(0, 2, (opts.num_pixels, 3))
                             .astype(np.float32))
    want = k2.render_pass_plain(vol, opts, table, accum, acc_in)
    log = {}
    got = model_pass(vol, opts, table, accum, acc_in, seed=1, log=log)
    assert torch.equal(got, want)
    assert len(log["ao"]) and len(log["shadow"])
    if case == "metal-aoAmp4":
        assert log["ao_speculative"]  # the stop fired inside a chunk
    if case == "metal-reflectIter5":  # some chain reached the second segment
        assert any((b[:, 0] > BOUNCE_SLOTS).any() for b in log["shadow"])


def _plain_tasks(vol, opts, table, accel, monkeypatch):
    """The (level, pixel, probe) AO probes and (level, pixel, light) shadow
    rays the plain version marches, from its calls: object_lighting runs
    for bounce 1..reflectIter, then for the primary point; in each, the
    probes' distance_to_scene calls in order, then shadow per light."""
    calls = {"lighting": -1, "probe": 0, "light": 0}
    ao, shadows = set(), set()

    def level():
        c = calls["lighting"]
        return c + 1 if c < opts.reflectIter else 0

    real_lighting, real_dts = shade.object_lighting, shade.distance_to_scene
    real_shadow = shade.shadow

    def lighting(*args, **kw):
        calls.update(lighting=calls["lighting"] + 1, probe=0, light=0)
        return real_lighting(*args, **kw)

    def dts(vol_, opts_, rpos, rdir, steps, active, *args, **kw):
        ao.update((level(), p, calls["probe"]) for p in active.nonzero()[:, 0].tolist())
        calls["probe"] += 1
        return real_dts(vol_, opts_, rpos, rdir, steps, active, *args, **kw)

    def shadow(vol_, opts_, p, ldir, lmax, active, accel_=None):
        shadows.update((level(), q, calls["light"]) for q in active.nonzero()[:, 0].tolist())
        calls["light"] += 1
        return real_shadow(vol_, opts_, p, ldir, lmax, active, accel_)

    monkeypatch.setattr(shade, "object_lighting", lighting)
    monkeypatch.setattr(shade, "distance_to_scene", dts)
    monkeypatch.setattr(shade, "shadow", shadow)
    k2.render_pass_plain(vol, opts, table, torch.zeros(opts.num_pixels, 3), accel)
    monkeypatch.undo()
    assert calls["lighting"] == opts.reflectIter  # reflectIter bounces + the primary
    return ao, shadows


@pytest.mark.parametrize("case", ["ragged-12x6", "ragged-aoAmp4"])
def test_task_numbering_covers_plain_once(volume, case, monkeypatch):
    """Over a frame whose tiles are ragged (12x6 under 8x4 tiles), every
    AO probe and shadow ray the plain version marches is a task of the
    kernel's numbering exactly once, and only pixels in the frame get
    tasks; the extra probe tasks are exactly the speculative ones the fold
    skipped, and a shadow task is marched exactly where the plain version
    marches it."""
    vol, bricks = volume
    opts = _opts("metal", width=12, height=6)
    if case == "ragged-aoAmp4":
        opts = opts.replace(aoAmp=torch.tensor(4.0))
    table = sampling.make_mc_tables(1, seed=3)[0]
    want_ao, want_shadow = _plain_tasks(vol, opts, table, bricks, monkeypatch)
    log = {}
    model_pass(vol, opts, table, torch.zeros(opts.num_pixels, 3), bricks, seed=2, log=log)
    assert (log["pixels"] == -1).any()  # lanes outside the frame
    ao_rows = [tuple(r) for b in log["ao"] for r in b.tolist()]
    sh_rows = [tuple(r) for b in log["shadow"] for r in b.tolist()]
    marched = np.concatenate(log["marched"])
    assert len(set(ao_rows)) == len(ao_rows) and len(set(sh_rows)) == len(sh_rows)
    in_frame = set(range(opts.num_pixels))
    assert {r[1] for r in ao_rows + sh_rows} <= in_frame
    spec = set(log["ao_speculative"])
    assert set(ao_rows) - spec == want_ao and spec <= set(ao_rows)
    assert {r for r, m in zip(sh_rows, marched) if m} == want_shadow
    assert (len(spec) > 0) == (case == "ragged-aoAmp4")
    # every lit point has one task per light
    points = {(lv, px) for lv, px, _ in sh_rows}
    assert len(sh_rows) == len(points) * opts.numLights


@pytest.mark.parametrize("near", [True, False])
def test_skipped_shadow_is_inactive_raymarch(near):
    """A shadow task the kernel does not march gives raymarch(active=False)'s
    factor: 1 for a point nearer the light than startDist (lmax <= startDist:
    the miss rewrite), else 0."""
    opts = _opts("metal").replace(startDist=torch.tensor(0.05))
    lmax = torch.tensor([0.01, 0.05, 0.0, -0.2]) if near else torch.tensor([0.06, 0.5, 3.0, 9.0])
    k = len(lmax)
    p, d = V3(*(torch.zeros(k) for _ in range(3))), V3(torch.zeros(k), torch.ones(k),
                                                       torch.zeros(k))
    vol = torch.zeros(int(np.prod(VRES)), dtype=torch.uint8)  # never read: nothing marches
    want = shade.shadow(vol, opts, p, d, lmax, torch.zeros(k, dtype=torch.bool))
    got = skipped_shadow(opts, lmax)
    assert torch.equal(got, want)
    assert bool((got == (1.0 if near else 0.0)).all())


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_numbering_balances_lanes(k):
    """Over a ragged 20x7 frame and random live points on four levels, the
    numbering names each (level, pixel, index) once, only pixels in the
    frame, and gives a warp's lanes task counts that differ by at most 1."""
    opts = _opts("metal", width=20, height=7)
    pixels = lane_pixels(opts)
    assert (pixels == -1).any()
    live = torch.from_numpy(np.random.default_rng(k).random((4, opts.num_pixels)) < 0.6)
    rows = number_tasks(pixels, live, [0, 1, 2, 3], k)
    keys = {tuple(r[:3]) for r in rows.tolist()}
    assert len(keys) == len(rows) == int(live.sum()) * k
    assert keys == {(lv, px, i) for lv, px in live.nonzero().tolist() for i in range(k)}
    start = 0
    for lanes in pixels:  # each warp's rows, in order
        n = int(sum(bool(live[lv, p]) for lv in range(4) for p in lanes if p >= 0)) * k
        per_lane = np.bincount(rows[start:start + n, 3], minlength=32)
        assert per_lane.max() - per_lane.min() <= 1 and per_lane.sum() == n
        assert set(rows[start:start + n, 1].tolist()) <= set(lanes[lanes >= 0].tolist())
        start += n
    assert start == len(rows)
