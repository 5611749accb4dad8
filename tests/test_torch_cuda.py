"""Each CUDA kernel of the PyTorch port against its plain version, on a GPU.

Marked `cuda`; without a CUDA device they skip. The file imports no JAX, so
on a machine with a GPU and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.io import checkpoint
from raymarchcl_tpu_torch.models import generators, mesh
from raymarchcl_tpu_torch.ops import accel, render, sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import build, prims
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.parallel import tiling
from raymarchcl_tpu_torch.scripts import bench_prims


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_cuda_bit_equal(cuda_device):
    rng = np.random.default_rng(0)
    acc = rng.uniform(-0.5, 30, (4096, 3)).astype(np.float32)
    acc[:2] = [[0.0, 1e30, np.inf], [-1.5, np.nan, -np.inf]]
    acc = torch.from_numpy(acc).to(cuda_device)
    before = k1.LAUNCHES
    got = k1.tonemap_pack(acc, 1.5)
    assert k1.LAUNCHES == before + 1
    assert torch.equal(got, k1.tonemap_pack_plain(acc, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.0, 0.333])
def test_k2_cuda_matches_plain(cuda_device, t):
    vres = [32, 32, 96]
    opts = render_options(width=32, height=24, vres=vres, iter=1, t=t, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to(cuda_device)
    table = sampling.make_mc_tables(1, seed=0, device=cuda_device)[0]
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    want = k2.render_pass_plain(vol, opts, table, acc.clone())
    before = k2.LAUNCHES
    k2.render_pass(vol, opts, table, acc)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
def test_k2_cuda_brick_table_bit_equal(cuda_device):
    """K2 over the brick table: bit-equal to K2 without it, and within the
    tolerance of its plain version over the table."""
    vres = [48, 48, 48]
    opts = render_options(width=64, height=48, vres=vres, iter=1, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to(cuda_device)
    bricks = accel.build_accel(vol, vres, opts.isoVal)
    assert bricks.rows.device == vol.device
    table = sampling.make_mc_tables(1, seed=0, device=cuda_device)[0]
    raw = k2.render_pass(vol, opts, table, torch.zeros((opts.num_pixels, 3), device=cuda_device))
    before = k2.LAUNCHES
    got = k2.render_pass(vol, opts, table, torch.zeros_like(raw), bricks)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    assert torch.equal(got, raw)
    want = k2.render_pass_plain(vol, opts, table, torch.zeros_like(raw), bricks)
    ok = torch.isclose(got, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


def _gyroid_case(device, width, height, n_passes, mat="ao"):
    vres = [48, 48, 48]
    opts = render_options(width=width, height=height, vres=vres, iter=n_passes, mat=mat,
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to(device)
    tables = sampling.make_mc_tables(n_passes, seed=0, device=device)
    times = torch.arange(n_passes, dtype=torch.float32) * 0.333
    return opts, vol, tables, times, accel.build_accel(vol, vres, opts.isoVal)


@pytest.mark.cuda
def test_k2_cuda_render_passes_bit_equal_single_passes(cuda_device):
    """One launch of 2 passes equals 2 one-pass launches bit for bit."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 64, 48, 2)
    before = k2.LAUNCHES
    frame = k2.render_passes(vol, opts, tables, times,
                             torch.zeros((opts.num_pixels, 3), device=cuda_device), bricks)
    assert k2.LAUNCHES == before + 1
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    for p in range(2):
        k2.render_pass(vol, opts.replace(time=times[p]), tables[p], acc, bricks)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 3
    assert torch.equal(frame, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 48), (100, 37)])
def test_k2_cuda_ragged_tiles_match_plain(cuda_device, size):
    """Frames whose sides are no multiple of the 8x4 warp tile: every
    pixel is rendered once, within the tolerance of the plain version."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, *size, 1)
    acc = torch.full((opts.num_pixels, 3), 0.25, device=cuda_device)
    want = k2.render_pass_plain(vol, opts.replace(time=times[0]), tables[0], acc.clone(), bricks)
    k2.render_passes(vol, opts, tables, times, acc, bricks)
    torch.cuda.synchronize()
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
def test_k2_cuda_counting_build_same_accum(cuda_device):
    """The counting build renders the same accum as the normal build, and
    its counts are consistent (lanes <= 32 x iterations, samples taken; an
    `ao` frame has no bounce)."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 64, 48, 2)
    _check_counting_build(opts, vol, tables, times, bricks, bounces=False)


def _check_counting_build(opts, vol, tables, times, bricks, bounces):
    want = k2.render_passes(vol, opts, tables, times,
                            torch.zeros((opts.num_pixels, 3), device=vol.device), bricks)
    acc = torch.zeros_like(want)
    counts = k2.count_lanes(vol, opts, tables, times, acc, bricks)
    assert torch.equal(acc, want)
    for name in k2.COUNTED_LOOPS:
        c = counts[name]
        if name.startswith("bounce") and not bounces:
            assert c["iters"] == c["lanes"] == 0, (name, c)
        else:
            assert 0 < c["iters"] <= c["lanes"] <= 32 * c["iters"], (name, c)
    assert counts["samples"] == sum(counts[n]["lanes"] for n in k2.SAMPLE_LOOPS) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["E1", "E2", "E3", "E4", "E5"])
def test_prims_cuda_equal_plain(cuda_device, key):
    """Each primitive probe at the script's sizes (every E2 depth) is
    exactly equal to its plain version."""
    x = bench_prims.inputs(cuda_device)
    cases = {
        "E1": [("e1_row_fetch", (x["e1_table"], x["e1_sidx"]))],
        "E2": [("e2_gather", (x[f"e2_table_{d}"], x[f"e2_idx_{d}"])) for d in prims.E2_DEPTHS],
        "E3": [("e3_probe", (x["e3_rows"], x["e3_w"], x["e3_b"]))],
        "E4": [("e4_transpose", (x["e4_x"],))],
        "E5": [("e5_while", (x["e5_x"],)), ("e5_while", (x["e5_x_timed"],))],
    }[key]
    for fn, args in cases:
        before = prims.LAUNCHES[key]
        got = getattr(prims, fn)(*args)
        want = getattr(prims, fn + "_plain")(*args)
        torch.cuda.synchronize()
        assert prims.LAUNCHES[key] == before + 1
        for g, w in zip(got, want) if key == "E5" else [(got, want)]:
            assert torch.equal(g, w), fn


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 16, 64])
def test_e1_cuda_ragged_equal_plain(cuda_device, reps):
    """E1's ring of bulk copies at row counts and widths other than the
    script's (one row, a partial last block, 4-word rows, negative and
    out-of-range start rows): exactly the plain version, one launch each."""
    rng = np.random.default_rng(reps)
    for s, w, k in ((4096, 128, 1024), (37, 4, 5), (100, 12, 300), (9, 256, 1)):
        table = torch.from_numpy(rng.integers(-2**31, 2**31, (s, w)).astype(np.int32))
        sidx = torch.from_numpy(rng.integers(-3 * s, 3 * s, k).astype(np.int32))
        table, sidx = table.to(cuda_device), sidx.to(cuda_device)
        before = prims.LAUNCHES["E1"]
        got = prims.e1_row_fetch(table, sidx, reps)
        torch.cuda.synchronize()
        assert prims.LAUNCHES["E1"] == before + 1
        assert torch.equal(got, prims.e1_row_fetch_plain(table, sidx, reps)), (s, w, k)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 16, 64])
def test_e4_cuda_ragged_equal_plain(cuda_device, reps):
    """E4's swizzled tiles at ragged shapes (the scalar edge path), on a
    view that is not 16-byte aligned, and at the script's shape: exactly the
    plain version, one launch each."""
    rng = np.random.default_rng(reps)
    flat = torch.from_numpy(rng.integers(-2**31, 2**31, 65 * 64).astype(np.int32))
    xs = [torch.from_numpy(rng.integers(-2**31, 2**31, shape).astype(np.int32))
          for shape in ((1024, 128), (37, 70), (1, 5), (33, 9), (5, 1))]
    unaligned = flat.to(cuda_device)[1:1 + 64 * 64].view(64, 64)
    assert unaligned.data_ptr() % 16
    for x in [x.to(cuda_device) for x in xs] + [unaligned]:
        before = prims.LAUNCHES["E4"]
        got = prims.e4_transpose(x, reps)
        torch.cuda.synchronize()
        assert prims.LAUNCHES["E4"] == before + 1
        assert torch.equal(got, prims.e4_transpose_plain(x, reps)), tuple(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (5, 37), (1, 1), (33, 200)])
def test_e2_cuda_ragged_equal_plain(cuda_device, shape):
    """E2's lanes-an-output schedule at shapes other than the script's
    (one output, partial warps and blocks), depths 1, 8 and 4096, reps 1, 7
    and 64, and start rows that are random, negative and near INT32_MAX
    (where idx + j wraps): exactly the plain version, one launch each."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    for depth in (1, 8, 4096):
        table = torch.from_numpy(rng.integers(-2**31, 2**31, (depth, shape[1]))
                                 .astype(np.int32)).to(cuda_device)
        starts = {"random": rng.integers(0, depth, shape),
                  "negative": rng.integers(-2**31, 0, shape),
                  "near_max": 2**31 - 1 - rng.integers(0, 80, shape)}
        for kind, idx in starts.items():
            idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
            for reps in (1, 7, 64):
                before = prims.LAUNCHES["E2"]
                got = prims.e2_gather(table, idx, reps)
                torch.cuda.synchronize()
                assert prims.LAUNCHES["E2"] == before + 1
                assert torch.equal(got, prims.e2_gather_plain(table, idx, reps)), \
                    (depth, kind, reps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (37, 27), (1, 1), (1024, 1), (32, 32)])
def test_e5_cuda_shapes_equal_plain(cuda_device, shape):
    """E5's one-warp loop at tiles other than the script's, with 0, 1 and
    1000 trips and INT32_MIN outside column 0 (it wraps in the loop):
    exactly the plain version's output and trips, one launch each."""
    r, c = shape
    rng = np.random.default_rng(r * c)
    for trips in (0, 1, 1000):
        xs = rng.integers(-2**31, 2**31, shape)
        xs[:, 0] = rng.integers(-50, trips + 1, r)
        xs[rng.integers(0, r), 0] = trips
        if c > 1:
            xs[rng.integers(0, r), 1 + rng.integers(0, c - 1)] = -2**31
        x = torch.from_numpy(xs.astype(np.int32)).to(cuda_device)
        before = prims.LAUNCHES["E5"]
        out, n = prims.e5_while(x)
        torch.cuda.synchronize()
        assert prims.LAUNCHES["E5"] == before + 1
        want, want_n = prims.e5_while_plain(x)
        assert int(want_n[0]) == trips
        assert torch.equal(n, want_n) and torch.equal(out, want), trips


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 128])
def test_e3_cuda_ragged_equal_plain(cuda_device, width):
    """E3's lanes-a-ray schedule at the CPU model's shapes: row widths 1, 3
    and 128, u 1, 8 and 33 (bits repeat), reps 1, 7 (no round at u 8 and 33),
    64 and 1024, one ray and a partial block, word offsets random, negative
    and near INT32_MAX (where w + j + i wraps): exactly the plain version,
    one launch each."""
    rng = np.random.default_rng(width)
    for k in (1, 37, 1024):
        rows = torch.from_numpy(rng.integers(-2**31, 2**31, (k, width)).astype(np.int32))
        b = torch.from_numpy(rng.integers(-2**31, 2**31, (k, 1)).astype(np.int32))
        starts = {"random": rng.integers(-2**31, 2**31, (k, 1)),
                  "negative": rng.integers(-2**31, 0, (k, 1)),
                  "near_max": 2**31 - 1 - rng.integers(0, 1100, (k, 1))}
        for kind, w in starts.items():
            w = torch.from_numpy(w.astype(np.int32))
            args = [a.to(cuda_device) for a in (rows, w, b)]
            for u in (1, 8, 33):
                for reps in (1, 7, 64, 1024):
                    before = prims.LAUNCHES["E3"]
                    got = prims.e3_probe(*args, u=u, reps=reps)
                    torch.cuda.synchronize()
                    assert prims.LAUNCHES["E3"] == before + 1
                    assert torch.equal(got, prims.e3_probe_plain(*args, u, reps)), \
                        (k, kind, u, reps)


@pytest.mark.cuda
def test_e3_cuda_degenerate_shapes_refused(cuda_device):
    """E3 refuses on the card what it refuses on the CPU, and launches
    nothing for it; reps < u gives zeros."""
    x = bench_prims.inputs(cuda_device)
    rows, w, b = x["e3_rows"], x["e3_w"], x["e3_b"]
    before = prims.LAUNCHES["E3"]
    for args, kw in (((rows[:, :0], w, b), {}), ((rows, w, b), {"u": 0}),
                     ((rows, w, b), {"reps": 0}), ((rows, w[:-1], b), {}),
                     ((rows, w, b.reshape(1, -1)), {})):
        with pytest.raises(ValueError, match="E3"):
            prims.e3_probe(*args, **kw)
    assert prims.LAUNCHES["E3"] == before
    got = prims.e3_probe(rows, w, b, u=8, reps=7)
    torch.cuda.synchronize()
    assert got.shape == (rows.shape[0], 1) and not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("size", [(64, 48), (100, 37)])
def test_k2_cuda_fused_pack_bit_equal(cuda_device, size, with_table):
    """K1's pack as K2's epilogue: the argb of a two-pass frame, of one pass
    onto an accum passed back in, and of no pass (the accum as given) is
    bit-equal to K1's plain version of the final accum, ragged tiles
    included; the accum is the one K2 renders without the pack."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, *size, 2)
    bricks = bricks if with_table else None
    n = opts.num_pixels
    want_acc = k2.render_passes(vol, opts, tables, times,
                                torch.zeros((n, 3), device=cuda_device), bricks)
    acc = torch.zeros((n, 3), device=cuda_device)
    argb = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    before = (k2.LAUNCHES, k2.PACKS, k1.LAUNCHES)
    k2.render_passes(vol, opts, tables, times, acc, bricks, argb)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.PACKS, k1.LAUNCHES) == (before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(acc, want_acc)
    assert torch.equal(argb, k1.tonemap_pack_plain(acc, opts.gamma))
    k2.render_pass(vol, opts.replace(time=0.5), tables[0], acc, bricks, argb)
    torch.cuda.synchronize()
    assert torch.equal(argb, k1.tonemap_pack_plain(acc, opts.gamma))
    acc.uniform_(-1.0, 40.0)
    k2.render_passes(vol, opts, tables[:0], times[:0], acc, bricks, argb)
    torch.cuda.synchronize()
    assert torch.equal(argb, k1.tonemap_pack_plain(acc, opts.gamma))


@pytest.mark.cuda
@pytest.mark.parametrize("ao_iter", [16, 20])
def test_k2_cuda_any_ao_iter(cuda_device, ao_iter):
    """K2 at aoIter 16 and 20 (the probe table beside the pass times, no
    fixed cap): within the tolerance of its plain version."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 32, 24, 1)
    opts = opts.replace(aoIter=ao_iter)
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    want = k2.render_pass_plain(vol, opts.replace(time=times[0]), tables[0], acc.clone(), bricks)
    k2.render_passes(vol, opts, tables, times, acc, bricks)
    torch.cuda.synchronize()
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["metal", "metal2", "orange-stripes"])
def test_k2c_cuda_matches_plain(cuda_device, mat):
    """K2's reflective instance (K2c) on a two-pass frame: within the
    tolerance of its plain version on >= 99.5% of pixels, bit-equal with
    and without the brick table, one launch of both passes bit-equal to two
    one-pass launches."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 40, 24, 2, mat)
    assert opts.reflectIter > 0
    n = opts.num_pixels
    before = k2.LAUNCHES
    acc = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device),
                           bricks)
    raw = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device))
    single = torch.zeros((n, 3), device=cuda_device)
    for p in range(2):
        k2.render_pass(vol, opts.replace(time=times[p]), tables[p], single, bricks)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 4
    assert torch.equal(acc, raw) and torch.equal(acc, single)
    want = torch.zeros((n, 3), device=cuda_device)
    for p in range(2):
        want = k2.render_pass_plain(vol, opts.replace(time=times[p]), tables[p], want, bricks)
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995
    assert not torch.equal(acc, k2.render_passes(vol, opts.replace(reflectIter=0), tables, times,
                                                  torch.zeros((n, 3), device=cuda_device),
                                                  bricks))


@pytest.mark.cuda
def test_k2c_cuda_counting_build(cuda_device):
    """The counting build of the reflective instance: the same accum as
    K2c, its bounce loops counted."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 64, 48, 2, "metal")
    _check_counting_build(opts, vol, tables, times, bricks, bounces=True)


@pytest.mark.cuda
def test_k2c_cuda_fused_pack_bit_equal(cuda_device):
    """K1's pack as K2c's epilogue at a ragged frame: bit-equal to K1's plain
    pack of the accum."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 100, 37, 2, "metal")
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    argb = torch.zeros(opts.num_pixels, dtype=torch.int32, device=cuda_device)
    k2.render_passes(vol, opts, tables, times, acc, bricks, argb)
    torch.cuda.synchronize()
    assert torch.equal(argb, k1.tonemap_pack_plain(acc, opts.gamma))


K2C_OPTIONS = {
    "aoIter16": ("metal", (40, 24), dict(aoIter=16)),
    "4lights": ("metal", (40, 24), dict(
        numLights=4,
        lightPos=torch.tensor([[0, 2, 0, 0], [3, 0, 3, 0], [-2, 1, 2, 0], [1, 3, -1, 0]],
                              dtype=torch.float32),
        lightColor=torch.tensor([[28, 18, 8, 0], [16, 36, 56, 0], [10, 20, 30, 0],
                                 [30, 10, 5, 0]], dtype=torch.float32))),
    "reflectIter1": ("metal", (40, 24), dict(reflectIter=1)),
    "reflectIter3": ("orange-stripes", (40, 24), dict(reflectIter=3)),
    "reflectIter5": ("metal", (40, 24), dict(reflectIter=5)),  # more than any preset's 3
    "aoAmp4": ("metal", (40, 24), dict(aoAmp=torch.tensor(4.0))),  # the AO stop fires
    "ragged100x37": ("metal2", (100, 37), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2C_OPTIONS))
def test_k2c_cuda_options_match_plain(cuda_device, case):
    """K2c away from the presets' options (aoIter 16, 4 lights, 1, 3 and 5
    bounces, an AO product that stops, a ragged frame): within the tolerance
    of its plain version on >= 99.5% of pixels, and bit-equal with and
    without the brick table."""
    mat, size, changes = K2C_OPTIONS[case]
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, *size, 1, mat)
    opts = opts.replace(**changes)
    n = opts.num_pixels
    acc = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device),
                           bricks)
    raw = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(acc, raw)
    want = k2.render_pass_plain(vol, opts.replace(time=times[0]), tables[0],
                                torch.zeros((n, 3), device=cuda_device), bricks)
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
def test_k2c_cuda_16_passes_bit_equal_single_passes(cuda_device):
    """One K2c launch of 16 passes equals 16 one-pass launches bit for bit."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 64, 48, 16, "metal")
    frame = k2.render_passes(vol, opts, tables, times,
                             torch.zeros((opts.num_pixels, 3), device=cuda_device), bricks)
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    for p in range(16):
        k2.render_pass(vol, opts.replace(time=times[p]), tables[p], acc, bricks)
    torch.cuda.synchronize()
    assert torch.equal(frame, acc)


TREFOIL = os.path.join(os.path.dirname(__file__), "..", "assets", "trefoil.stl")
MESH_CASES = {  # BASELINE configs 3 and 4's volumes (scripts/run_configs.py:70-98)
    "ks64-ao": ("ks", 64, "ao", dict(eyepos=compute_eyepos(120, 2.0, 0.5), targetpos=[0, 0, 0])),
    "scatter128-metal": ("scatter", 128, "metal", dict(eyepos=compute_eyepos(135, 2.25, 0.35),
                                                       targetpos=[0, -0.4, 0])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_k2_cuda_mesh_volume_matches_plain(cuda_device, case):
    """K2 and K2c over a voxelized mesh (a sparse volume): bit-equal with
    and without the brick table, within the tolerance of the plain version
    on >= 99.5% of pixels."""
    kind, res, mat, cam = MESH_CASES[case]
    verts = mesh.read_stl(TREFOIL)
    vol_np = mesh.voxelize_ks(verts, res, 1) if kind == "ks" else mesh.voxelize_scatter(
        verts, res, seed=3)
    opts = render_options(width=48, height=32, vres=res, iter=2, mat=mat, **cam)
    vol = torch.from_numpy(vol_np).to(cuda_device)
    bricks = accel.build_accel(vol, opts.voxelRes, opts.isoVal)
    tables = sampling.make_mc_tables(2, seed=0, device=cuda_device)
    times = torch.arange(2, dtype=torch.float32) * 0.333
    n = opts.num_pixels
    acc = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device),
                           bricks)
    raw = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(acc, raw)
    want = torch.zeros((n, 3), device=cuda_device)
    for p in range(2):
        want = k2.render_pass_plain(vol, opts.replace(time=times[p]), tables[p], want, bricks)
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
def test_k2c_cuda_dof_matches_plain(cuda_device):
    """K2c with depth of field at config 5's 0.025 (the eye jitters per
    pass): within the tolerance of its plain version, and bit-equal with
    and without the brick table."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 48, 32, 2, "metal")
    opts = opts.replace(dof=0.025)
    n = opts.num_pixels
    acc = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device),
                           bricks)
    raw = k2.render_passes(vol, opts, tables, times, torch.zeros((n, 3), device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(acc, raw)
    want = torch.zeros((n, 3), device=cuda_device)
    for p in range(2):
        want = k2.render_pass_plain(vol, opts.replace(time=times[p]), tables[p], want, bricks)
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995
    assert not torch.equal(acc, k2.render_passes(vol, opts.replace(dof=0.001), tables, times,
                                                  torch.zeros((n, 3), device=cuda_device),
                                                  bricks))


@pytest.mark.cuda
def test_checkpointed_cuda_chunks_and_full_resume(cuda_device, tmp_path):
    """render_checkpointed on the card: chunks of 2 of 5 passes (one K2c
    launch each) are bit-equal to one straight launch; a fully resumed call
    launches K1 once and K2 never, with the same image."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 64, 48, 5, "metal")
    opts = opts.replace(dof=0.025)
    argb, acc = render.render_image(vol, opts, tables, accel=bricks)
    before = (k1.LAUNCHES, k2.LAUNCHES, k2.REFLECTIVE_LAUNCHES)
    argb_c, acc_c = checkpoint.render_checkpointed(vol, opts, tables, tmp_path / "ck", chunk=2,
                                                   accel=bricks)
    assert (k1.LAUNCHES, k2.LAUNCHES, k2.REFLECTIVE_LAUNCHES) == (
        before[0], before[1] + 3, before[2] + 3)
    assert acc_c.device.type == "cuda"
    np.testing.assert_array_equal(argb_c, argb)
    assert torch.equal(acc_c, acc)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    argb_r, acc_r = checkpoint.render_checkpointed(vol, opts, tables, tmp_path / "ck", chunk=2,
                                                   accel=bricks)
    assert (k1.LAUNCHES, k2.LAUNCHES) == (before[0] + 1, before[1])
    np.testing.assert_array_equal(argb_r, argb)
    assert torch.equal(acc_r, acc)


@pytest.mark.cuda
def test_params_layout_cuda(cuda_device):
    """The library reports the size of its parameter block, which its ctypes
    mirror must share (the loader refuses a library where they differ)."""
    assert build.library().rmcl_params_size() == ctypes.sizeof(k2.RmclParams)


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_k2_cuda_pixel_range_matches_plain(cuda_device, mat):
    """K2 (and K2c) over a ragged pixel range, the last of 3 tiles of a
    100x37 frame: it starts mid-row (pixel 2468 is x 68 of row 24) and ends
    in 2 pad rows, which render pixel N-1 again. Within the tolerance of the
    plain version over the same range; the pad rows equal row N-1's."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 100, 37, 2, mat)
    n, blk = opts.num_pixels, -(-opts.num_pixels // 3)
    lo = 2 * blk
    acc = torch.full((blk, 3), 0.25, device=cuda_device)
    argb = torch.zeros(blk, dtype=torch.int32, device=cuda_device)
    want = acc.clone()
    for p in range(2):
        want = k2.render_pass_plain(vol, opts.replace(time=times[p]), tables[p], want, bricks,
                                    pix_lo=lo)
    before = k2.LAUNCHES
    k2.render_passes(vol, opts, tables, times, acc, bricks, argb, pix_lo=lo, pix_count=blk)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995
    real = n - lo
    assert blk - real == 2 and torch.equal(acc[real:], acc[real - 1:real].expand(2, 3))
    assert torch.equal(argb, k1.tonemap_pack_plain(acc, opts.gamma))


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_k2_cuda_tiles_bit_equal_one_launch(cuda_device, mat):
    """A 100x37 frame in 3 tiles (3 pixel-range launches on one card)
    equals one launch of the whole frame bit for bit, accum and image."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 100, 37, 2, mat)
    argb_1, acc_1 = render.render_image(vol, opts, tables, times, accel=bricks)
    before = k2.LAUNCHES
    argb_t, acc_t = tiling.render_image_tiled(vol, opts, tables, times,
                                              mesh=tiling.make_mesh([cuda_device] * 3),
                                              accel=bricks)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 3
    np.testing.assert_array_equal(argb_t, argb_1)
    assert acc_t.shape == (3702, 3) and torch.equal(acc_t[:3700], acc_1)


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_bench_gate_holds_on_the_card(cuda_device, mat, tmp_path, monkeypatch):
    """scripts/bench.check_invariants on a small bench frame (no digest
    check: it is not the main path), and a run of the timed frames."""
    from raymarchcl_tpu_torch import api
    from raymarchcl_tpu_torch.scripts import bench

    monkeypatch.setattr(api, "VOLUME_CACHE_DIR", str(tmp_path))
    scene = bench.setup(64, 48, 4, 48, mat, True, cuda_device)
    res = bench.check_invariants(scene, default=False)
    assert res == {"accel_on_off": True, "chunked_vs_one_launch": True, "plain_64": True,
                   "pack_bit_equal": True}
    before = k2.LAUNCHES
    out = bench.run(scene, 2, 2, res, "card")
    assert k2.LAUNCHES - before == 3 * 2  # the warm-up and 2 frames, 2 launches each
    assert out["invariants"] is True and len(out["samples"]) == 2


@pytest.mark.cuda
def test_runtime_card_finds_the_card_by_uuid(cuda_device):
    """The card's UUID as torch reports it is one nvidia-smi lists, so
    runtime.card(device) names the card that renders, not the first one."""
    import subprocess

    from raymarchcl_tpu_torch import runtime

    uuid = str(torch.cuda.get_device_properties(cuda_device).uuid)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.split()
    assert f"GPU-{uuid}" in smi
    line = runtime.card(cuda_device)
    assert line in runtime.card().splitlines() and line.endswith(" W")


def _forget_launch_state():
    """Drop what the launches keep across frames, as a new process has
    none of it."""
    for cache in (k2._PLANS, k2._BLOCKS, k2._NEXT_TILE):
        cache.clear()


@pytest.mark.cuda
def test_launch_state_leaks_nothing_between_frames(cuda_device):
    """ao, then metal, then ao again, at other pass counts, poses and pixel
    ranges: each frame bit-equal, accum and image, to the same frame in
    the reverse order. The image a frame returned stays as it was after
    the later frames (no host buffer is written twice), and a still
    rendered again builds no parameter block's static part and copies no
    block to the card."""
    ao = _gyroid_case(cuda_device, 64, 48, 3, "ao")
    metal = _gyroid_case(cuda_device, 64, 48, 3, "metal")

    def whole(case, passes, eye):
        opts, vol, tables, times, bricks = case
        return render.render_image(vol, opts.replace(eyePos=eye), tables[:passes],
                                   times[:passes], accel=bricks)

    def band(case, passes, lo, count):
        opts, vol, tables, times, bricks = case
        acc = torch.zeros((count, 3), device=cuda_device)
        argb = torch.empty(count, dtype=torch.int32, device=cuda_device)
        k2.render_passes(vol, opts, tables[:passes], times[:passes], acc, bricks, argb,
                         pix_lo=lo, pix_count=count)
        return argb.cpu().numpy(), acc

    frames = [lambda: whole(ao, 2, compute_eyepos(135, 2.25, 0.35)),
              lambda: band(metal, 1, 2500, 600),  # ends in 28 pad rows
              lambda: whole(ao, 3, compute_eyepos(60, 2.0, 0.5)),
              lambda: band(ao, 2, 100, 1234)]
    forward = [frames[0]()]
    first = forward[0][0].copy()
    forward += [f() for f in frames[1:]]
    np.testing.assert_array_equal(forward[0][0], first)
    assert not np.shares_memory(forward[0][0], forward[2][0])
    backward = [f() for f in reversed(frames)][::-1]
    for (img_f, acc_f), (img_b, acc_b) in zip(forward, backward):
        np.testing.assert_array_equal(img_f, img_b)
        assert torch.equal(acc_f, acc_b)
    builds, hits, uploads = k2.PLAN_BUILDS, k2.PLAN_HITS, k2.BLOCK_UPLOADS
    img, _ = frames[0]()
    assert (k2.PLAN_BUILDS, k2.PLAN_HITS, k2.BLOCK_UPLOADS) == (builds, hits + 1, uploads)
    np.testing.assert_array_equal(img, first)
    np.testing.assert_array_equal(forward[0][0], first)


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_sharded_entries_equal_one_card(cuda_device, mat):
    """The tiled frame (3 bands, 3 pixel ranges) equals one card's bit for
    bit; the pass-sharded one (2 shards, other pass times each) equals it
    to float32 reassociation, and is bit-equal to itself rendered from a
    fresh launch state."""
    opts, vol, tables, times, bricks = _gyroid_case(cuda_device, 100, 37, 4, mat)
    n = opts.num_pixels
    argb_1, acc_1 = render.render_image(vol, opts, tables, times, accel=bricks)
    argb_t, acc_t = tiling.render_image_tiled(vol, opts, tables, times, accel=bricks,
                                              mesh=tiling.make_mesh([cuda_device] * 3))
    np.testing.assert_array_equal(argb_t, argb_1)
    assert torch.equal(acc_t[:n], acc_1)
    mesh = tiling.make_mesh([cuda_device] * 2)
    argb_s, acc_s = tiling.render_image_spp_sharded(vol, opts, tables, times, mesh=mesh,
                                                    accel=bricks)
    np.testing.assert_allclose(acc_s[:n].cpu().numpy(), acc_1.cpu().numpy(), rtol=2e-5,
                               atol=1e-6)
    assert (argb_s != argb_1).mean() < 0.01
    _forget_launch_state()
    argb_f, acc_f = tiling.render_image_spp_sharded(vol, opts, tables, times, mesh=mesh,
                                                    accel=bricks)
    np.testing.assert_array_equal(argb_f, argb_s)
    assert torch.equal(acc_f, acc_s)
