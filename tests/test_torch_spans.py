"""The port's profiler spans (utils/metrics.span) and the tiling counters
(parallel/tiling.COPIED_BYTES and CALLS).

On the CPU: the span helper is a shared null context without a profiler
and calls no record_function then; under a profiler the entries record
their spans nested as the benchmark's readers expect (rmcl_bench/program.py),
and the images are the same with the profiler on and off; an all-CPU mesh
copies nothing. The `cuda` cases (the K2 launch's spans, the occupancy
query, the bytes moved across two cards, the two cards' bands running at
once and cut from their measured times) skip without the cards they need. The file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel as accel_mod
from raymarchcl_tpu_torch.ops import render, sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.parallel import tiling
from raymarchcl_tpu_torch.utils import metrics

VRES = [32, 32, 32]
# short march budgets: the profiler records every op of the plain version
BUDGETS = dict(maxIter=8, maxVoxelIter=8, shadowIter=4, aoIter=1)


def _opts(mat="ao"):
    return render_options(width=8, height=8, vres=VRES, iter=2, mat=mat, **BUDGETS,
                          eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])


def _scene(device="cpu"):
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": VRES})).to(device)
    return vol, _opts(), sampling.make_mc_tables(2, seed=9, device=device)


def _events(prof, cat):
    """[(name, start, end, args)] of the complete events of category `cat`
    in the profiler's chrome trace, in order of start."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ev = [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("args") or {}) for e in events
          if e.get("ph") == "X" and e.get("cat") == cat]
    return sorted(ev, key=lambda s: s[1])


def _spans(prof):
    """[(name, start, end)] of the port's spans in the profiler's chrome
    trace (as the benchmark reads them: user annotations), in order of
    start."""
    return [e[:3] for e in _events(prof, "user_annotation") if e[0].startswith("rmcl.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def traced():
    """The untraced and traced images of render_image and of
    render_image_tiled over four CPU entries, with the traced spans."""
    torch.set_num_threads(1)
    vol, opts, tables = _scene()
    mesh = tiling.make_mesh(["cpu"] * 4)
    plain = render.render_image(vol, opts, tables)[0]
    plain_tiled = tiling.render_image_tiled(vol, opts, tables, mesh=mesh)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = render.render_image(vol, opts, tables)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof_tiled:
        img_tiled = tiling.render_image_tiled(vol, opts, tables, mesh=mesh)[0]
    return {"plain": plain, "plain_tiled": plain_tiled, "img": img, "img_tiled": img_tiled,
            "spans": _spans(prof), "spans_tiled": _spans(prof_tiled)}


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called without a profiler")

    monkeypatch.setattr(metrics, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = metrics.span("rmcl.a"), metrics.span("rmcl.b")
    assert first is second is metrics._NO_SPAN
    with first:
        with second:  # nests: the null context keeps no state
            pass


def test_span_under_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("rmcl.test.step"):
            torch.ones(2).sum()
    assert [s[0] for s in _spans(prof)] == ["rmcl.test.step"]


def test_render_image_spans(traced):
    spans = traced["spans"]
    # the CPU path launches nothing: no rmcl.k2.* spans
    assert [s[0] for s in spans] == ["rmcl.render_image", "rmcl.readback"]
    assert _inside(spans[1], spans[0])


def test_render_image_tiled_spans(traced):
    spans = traced["spans_tiled"]
    names = [s[0] for s in spans]
    # every band's inputs are staged before the first band launches
    assert names == (["rmcl.render_image_tiled"] + ["rmcl.tiling.inputs"] * 4
                     + ["rmcl.tiling.tile"] * 4 + ["rmcl.tiling.gather", "rmcl.readback"])
    entry, rest = spans[0], spans[1:]
    assert all(_inside(s, entry) for s in rest)
    inputs, first_tile = rest[:4], rest[4]
    assert all(i[2] <= first_tile[1] for i in inputs)
    assert all(a[2] <= b[1] for a, b in zip(rest, rest[1:]))  # one after another


def test_images_equal_with_the_profiler_on_and_off(traced):
    np.testing.assert_array_equal(traced["img"], traced["plain"])
    np.testing.assert_array_equal(traced["img_tiled"], traced["plain_tiled"])
    np.testing.assert_array_equal(traced["img_tiled"], traced["plain"])


@pytest.mark.parametrize("entry", ["tiled", "spp_sharded"])
def test_an_all_cpu_mesh_copies_nothing(entry):
    torch.set_num_threads(1)
    vol, opts, tables = _scene()
    bytes_before, calls_before = tiling.COPIED_BYTES, tiling.CALLS
    if entry == "tiled":
        tiling.render_image_tiled(vol, opts, tables, mesh=tiling.make_mesh(["cpu"] * 4))
    else:
        tiling.render_image_spp_sharded(vol, opts, tables, mesh=tiling.make_mesh(["cpu"] * 2))
    assert tiling.CALLS == calls_before + 1
    assert tiling.COPIED_BYTES == bytes_before


# --- on a card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_k2_launch_spans(cuda_device, mat):
    vol, _, tables = _scene(cuda_device)
    opts = _opts(mat)
    acc = accel_mod.build_accel(vol, opts.voxelRes, opts.isoVal)
    render.render_image(vol, opts, tables, accel=acc)  # builds or loads the library
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        img = render.render_image(vol, opts, tables, accel=acc)[0]
        torch.cuda.synchronize()
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["rmcl.render_image", "rmcl.k2.params", "rmcl.k2.block",
                                     "rmcl.k2.launch", "rmcl.readback"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))  # one after another
    np.testing.assert_array_equal(img, render.render_image(vol, opts, tables, accel=acc)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("reflective", [False, True])
def test_occupancy(cuda_device, reflective):
    occ = k2.occupancy(reflective)
    again = k2.occupancy(reflective, device=cuda_device)
    assert occ == again
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    assert occ["threads_per_block"] == 256 and occ["local_bytes"] == 0  # no spill
    assert occ["warps_per_sm"] == occ["blocks_per_sm"] * 256 // 32


def test_occupancy_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k2.occupancy(False) is None


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["tiled", "spp_sharded"])
def test_bytes_copied_across_cards(cuda_device, entry):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    vol, opts, tables = _scene("cuda:0")
    acc = accel_mod.build_accel(vol, opts.voxelRes, opts.isoVal)
    mesh = tiling.make_mesh(["cuda:0", "cuda:1"])
    replicas = vol.nbytes + tables.nbytes + acc.rows.nbytes
    blk = -(-opts.num_pixels // 2)
    bytes_before, calls_before = tiling.COPIED_BYTES, tiling.CALLS
    if entry == "tiled":
        tiling.render_image_tiled(vol, opts, tables, mesh=mesh, accel=acc)
        want = replicas + 2 * (blk * 3 * 4 + blk * 4)  # accum and image tiles out and back
    else:
        tiling.render_image_spp_sharded(vol, opts, tables, mesh=mesh, accel=acc)
        want = replicas + opts.num_pixels * 3 * 4  # the part back
    torch.cuda.synchronize()
    assert tiling.CALLS == calls_before + 1
    assert tiling.COPIED_BYTES - bytes_before == want


@pytest.mark.cuda
def test_tiled_bands_overlap_across_cards(cuda_device):
    """Band 1's render pass starts on its card before band 0's ends on the
    home card: band 1's inputs left the home card before band 0 launched."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    vres = [64, 64, 64]
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to("cuda:0")
    # default march budgets and bounces: each band's K2c takes milliseconds
    opts = render_options(width=512, height=256, vres=vres, iter=8, mat="metal",
                          eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = sampling.make_mc_tables(8, seed=9, device="cuda:0")
    acc = accel_mod.build_accel(vol, opts.voxelRes, opts.isoVal)
    mesh = tiling.make_mesh(["cuda:0", "cuda:1"])
    want = tiling.render_image_tiled(vol, opts, tables, mesh=mesh, accel=acc)[0]  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        img = tiling.render_image_tiled(vol, opts, tables, mesh=mesh, accel=acc)[0]
        for d in range(2):
            torch.cuda.synchronize(d)
    bands = {e[3].get("device"): e for e in _events(prof, "kernel")
             if "render_passes_kernel" in e[0]}
    assert sorted(bands) == [0, 1]
    assert bands[1][1] < bands[0][2]
    np.testing.assert_array_equal(img, want)


@pytest.mark.cuda
def test_tiled_bands_follow_their_times(cuda_device):
    """Over two cards each frame's band times are recorded (the first
    frame's dropped), and the next frame's bands are cut from them on strip
    edges; every frame stays the one-card render bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    vres = [64, 64, 64]
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to("cuda:0")
    opts = render_options(width=512, height=256, vres=vres, iter=4, mat="metal",
                          eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = sampling.make_mc_tables(4, seed=9, device="cuda:0")
    acc = accel_mod.build_accel(vol, opts.voxelRes, opts.isoVal)
    want = render.render_image(vol, opts, tables, accel=acc)[0]
    mesh = tiling.make_mesh(["cuda:0", "cuda:1"])
    tiling._bands.cache_clear()
    bands = tiling._bands(mesh, 512, 256)
    for frame in range(4):
        off = bands.offsets()
        assert off[0] == 0 and off[-1] == 512 * 256
        if frame > 1:
            assert bands.cost is not None and bool((bands.cost > 0).all())
            assert off[1] % (4 * 512) == 0
        else:
            assert off == [0, 256 * 256, 512 * 256]
        img = tiling.render_image_tiled(vol, opts, tables, mesh=mesh, accel=acc)[0]
        np.testing.assert_array_equal(img, want)
    tiling._bands.cache_clear()
