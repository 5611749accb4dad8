"""K2's frame launch on the CPU: the kernel's index formulas (warp-tile
pixel map, brick-local STOP-bit test) mirrored in Python and checked
exhaustively, `render_passes` against single passes and against the JAX
package's render, and the per-pass times that go beside the frame's
parameter block."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.models import generators as j_generators
from raymarchcl_tpu.ops import render as j_render
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.ops.kernels import build
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.kernels.tonemap import tonemap_pack_plain
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.scripts import profile_frame

torch.set_num_threads(1)

VRES = [32, 32, 32]
SMALL = dict(width=16, height=12, iter=2, vres=VRES, mat="ao", maxIter=48, maxVoxelIter=96,
             shadowIter=48, eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])


def _kernel_tile():
    """(kTileW, kTileH) as csrc/render_pass.cu declares them."""
    src = open(os.path.join(build.CSRC_DIR, "render_pass.cu")).read()
    m = re.search(r"constexpr int kTileW = (\d+), kTileH = (\d+);", src)
    return int(m.group(1)), int(m.group(2))


def tile_pixels(tile, width, height):
    """The kernel's pixel map: warp tile `tile` (row-major over the frame's
    tiles), lane -> (lane % kTileW, lane / kTileW) in the tile; -1 where the
    lane lies outside the frame (masked)."""
    tw, th = _kernel_tile()
    tiles_x = (width + tw - 1) // tw
    lane = np.arange(32)
    x = (tile % tiles_x) * tw + lane % tw
    y = (tile // tiles_x) * th + lane // tw
    return np.where((x < width) & (y < height), y * width + x, -1)


@pytest.mark.parametrize("size", [(512, 512), (64, 48), (100, 37), (1, 1)])
def test_warp_tile_map_is_a_bijection(size):
    w, h = size
    tw, th = _kernel_tile()
    assert tw * th == 32
    n_tiles = ((w + tw - 1) // tw) * ((h + th - 1) // th)
    tiles = np.stack([tile_pixels(t, w, h) for t in range(n_tiles)])
    assert (tiles >= 0).any(axis=1).all()  # no tile lies wholly outside the frame
    pids = tiles[tiles >= 0]
    assert pids.size == w * h
    np.testing.assert_array_equal(np.sort(pids), np.arange(w * h))


def kernel_hit(rows, res, edge, q):
    """The brick march's sample test in csrc/render_pass.cu: the brick's
    distance word D, and in a brick with D == 0 the STOP bit L & 31 of word
    L >> 5 of its row, L = (lz*edge + ly)*edge + lx."""
    sh, m = edge.bit_length() - 1, edge - 1
    nbx, nby, _ = accel.brick_dims(res, edge)
    rw = accel.row_words(edge)
    qx, qy, qz = q
    bid = ((qz >> sh) * nby + (qy >> sh)) * nbx + (qx >> sh)
    lbit = ((((qz & m) << sh) + (qy & m)) << sh) + (qx & m)
    dist = rows[bid * rw + rw - 2]
    word = rows[bid * rw + (lbit >> 5)]
    return (dist == 0) & (((word >> (lbit & 31)) & 1) == 1)


def _volume(name):
    if name == "random-12x9x21":
        rng = np.random.default_rng(3)
        res = (12, 9, 21)  # no brick multiple
        return (rng.random(res[0] * res[1] * res[2]) * 255).astype(np.uint8), res
    res = (48, 48, 48)
    return generators.make_gyroid_volume({"vres": list(res)}), res


@pytest.mark.parametrize("edge", [4, 8, 16])
@pytest.mark.parametrize("name", ["random-12x9x21", "gyroid-48"])
def test_stop_bit_sample_test_equals_iso(name, edge):
    """At every in-grid voxel the kernel's brick-local test is v > isoVal,
    the raw march's hit test."""
    iso = 32
    vol, res = _volume(name)
    rows = accel.build_accel(vol, res, iso, edge).rows.numpy().view(np.uint32).reshape(-1)
    rx, ry, rz = res
    qz, qy, qx = np.meshgrid(np.arange(rz), np.arange(ry), np.arange(rx), indexing="ij")
    got = kernel_hit(rows.astype(np.int64), res, edge, (qx.ravel(), qy.ravel(), qz.ravel()))
    want = vol > iso  # flat index z*rx*ry + y*rx + x, the meshgrid's order
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def scene():
    vol = j_generators.make_gyroid_volume({"vres": VRES})
    tables = np.asarray(js.make_mc_tables(SMALL["iter"], seed=3))
    return vol, tables


def test_render_passes_equals_single_passes_and_jax(scene):
    """Passes [0, 2) in one call equal [0, 1) then [1, 2) bit for bit, with
    and without the brick table, and the frame agrees with the JAX
    package's render_image accum at the parity tolerance."""
    vol_np, tables_np = scene
    vol, tables = volume_from_numpy(vol_np), tables_from_numpy(tables_np)
    opts = render_options(**SMALL)
    times = torch.arange(2, dtype=torch.float32) * t_render.TIME_STEP_INIT
    bricks = accel.build_accel(vol, opts.voxelRes, opts.isoVal)
    for acc_t in (None, bricks):
        both = k2.render_passes(vol, opts, tables, times, torch.zeros((opts.num_pixels, 3)),
                                acc_t)
        split = torch.zeros((opts.num_pixels, 3))
        k2.render_passes(vol, opts, tables[:1], times[:1], split, acc_t)
        k2.render_passes(vol, opts, tables[1:], times[1:], split, acc_t)
        assert torch.equal(both, split)
    _, j_acc = j_render.render_image(jnp.asarray(vol_np), j_render_options(**SMALL),
                                     jnp.asarray(tables_np), accel=None)
    ok = np.isclose(both.numpy(), np.asarray(j_acc), rtol=5e-3, atol=5e-3).all(axis=1)
    assert ok.mean() >= 0.995, f"{(~ok).sum()}/{ok.size} pixels diverged"
    assert float(both.abs().sum()) > 0


@pytest.mark.parametrize("kind", ["tensor", "list", "float64"])
def test_pass_times_as_opts_replace(kind):
    """Each pass's time reaches the kernel as opts.replace(time=t) carries
    it into a single pass (float32, rounded once)."""
    opts = render_options(width=8, height=6, vres=8, iter=4)
    raw = np.array([0.0, 0.333, 0.666, 1 / 3])
    times = {"tensor": torch.from_numpy(raw.astype(np.float32)), "list": list(raw),
             "float64": torch.from_numpy(raw)}[kind]
    got = k2.pass_times(times)
    assert got.dtype == torch.float32 and got.shape == (4,) and got.device.type == "cpu"
    for p in range(4):
        want = opts.replace(time=times[p]).time
        assert got[p].item() == want.item()
        assert got[p].item() == float(np.float32(raw[p]))


def test_render_passes_checks(scene):
    vol_np, tables_np = scene
    vol, tables = volume_from_numpy(vol_np), tables_from_numpy(tables_np)
    opts = render_options(**SMALL)
    acc = torch.zeros((opts.num_pixels, 3))
    with pytest.raises(ValueError, match="times"):
        k2.render_passes(vol, opts, tables, torch.zeros(3), acc)
    with pytest.raises(ValueError, match="table"):
        k2.render_passes(vol, opts, tables[0], torch.zeros(1), acc)
    with pytest.raises(ValueError, match="brick table"):
        k2.count_lanes(vol, opts, tables, torch.zeros(2), acc, None)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.count_lanes(vol, opts, tables, torch.zeros(2), acc,
                       accel.build_accel(vol, opts.voxelRes, opts.isoVal))


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_render_passes_argb_checked(scene, bad):
    """The argb a caller hands render_passes must be (N,) contiguous int32
    on accum's device; it is refused before any pass runs."""
    vol_np, tables_np = scene
    vol, tables = volume_from_numpy(vol_np), tables_from_numpy(tables_np)
    opts = render_options(**SMALL)
    n = opts.num_pixels
    argb = {"shape": torch.zeros((n, 1), dtype=torch.int32),
            "dtype": torch.zeros(n, dtype=torch.int64),
            "strided": torch.zeros(2 * n, dtype=torch.int32)[::2]}[bad]
    acc = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="argb"):
        k2.render_passes(vol, opts, tables, torch.zeros(2), acc, argb=argb)
    assert not acc.any()


def test_render_passes_argb_packs_final_accum(scene):
    """On the CPU render_passes packs the final accum (K1's plain version)
    into argb: after two passes, after one pass onto an accum passed back
    in, and with no pass at all (the accum as given)."""
    vol_np, tables_np = scene
    vol, tables = volume_from_numpy(vol_np), tables_from_numpy(tables_np)
    opts = render_options(**SMALL)
    times = torch.arange(2, dtype=torch.float32) * t_render.TIME_STEP_INIT
    acc = torch.zeros((opts.num_pixels, 3))
    argb = torch.zeros(opts.num_pixels, dtype=torch.int32)
    before = (k2.LAUNCHES, k2.PACKS)
    k2.render_passes(vol, opts, tables, times, acc, argb=argb)
    assert torch.equal(argb, tonemap_pack_plain(acc, opts.gamma))
    k2.render_pass(vol, opts.replace(time=0.5), tables[0], acc, argb=argb)  # accum passed back
    assert torch.equal(argb, tonemap_pack_plain(acc, opts.gamma))
    acc.fill_(0.25)
    k2.render_passes(vol, opts, tables[:0], times[:0], acc, argb=argb)
    assert torch.equal(argb, tonemap_pack_plain(acc, opts.gamma))
    assert len(torch.unique(argb)) == 1 and (k2.LAUNCHES, k2.PACKS) == before


def test_profile_idle_by_place():
    """profile_frame's reading of a chrome trace: idle time before, between
    and after a frame's device events, overlaps merged, host events and
    events outside the frames ignored."""
    def ev(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}

    events = [
        ev(profile_frame.FRAME, "user_annotation", 100.0, 100.0),
        ev(profile_frame.FRAME, "gpu_user_annotation", 110.0, 80.0),
        ev("cudaLaunchKernel", "cuda_runtime", 101.0, 5.0),
        ev("fill", "gpu_memset", 110.0, 5.0),  # before: 10
        ev("k2", "kernel", 120.0, 50.0),  # between: 5
        ev("k1", "kernel", 160.0, 20.0),  # overlaps k2
        ev("copy", "gpu_memcpy", 185.0, 5.0),  # between: 5; after: 10
        ev("other", "kernel", 300.0, 10.0),  # outside every frame
        ev(profile_frame.FRAME, "user_annotation", 400.0, 10.0),  # no device event
    ]
    got = profile_frame.idle_by_place(events)
    assert got == {"before": 20.0, "between": 10.0, "after": 10.0, "busy": 70.0, "wall": 110.0}
