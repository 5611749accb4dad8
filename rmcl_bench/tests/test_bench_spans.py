"""The readers of what the port records about itself (rmcl_bench/program.py):
its spans on canned chrome traces, the tiling counters and the occupancy
query; and a tiny traced CPU run that reads them."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from rmcl_bench import run, spec
from rmcl_bench.trace import Trace

K2 = "void render_passes_kernel<Build<true, false, false> >(RmclParams, RangeWork)"
K2C = "void render_passes_kernel<Build<true, false, true> >(RmclParams, RangeWork)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >"

STILL_METRICS = ("host.params_ms.still", "host.block_ms.still", "host.launch_ms.still",
                 "host.readback_ms.still")
TILED_METRICS = ("tiling.inputs_ms", "tiling.band_wait_ms")


def _ev(name, ts, dur, cat, dev=0, corr=None):
    args = {"device": dev}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": dev,
            "args": args}


def _span(name, ts, dur):
    return _ev(name, ts, dur, "user_annotation")


def canned_still():
    """Two frames of 100 us. Frame 1: params 2 us, block 5, launch 3, K2 at
    19-60, the readback at 21-80 (20 us after K2). Frame 2: 1, 3, 2, K2 at
    115-150, the readback at 117-152 (2 us after). A span after the frames
    is left out."""
    return [_span("rmcl_bench.frame", 0, 100), _span("rmcl_bench.frame", 100, 100),
            _span("rmcl.render_image", 5, 90), _span("rmcl.k2.params", 10, 2),
            _span("rmcl.k2.block", 12, 5), _span("rmcl.k2.launch", 17, 3),
            _ev(K2, 19, 41, "kernel"), _span("rmcl.readback", 21, 59),
            _span("rmcl.k2.params", 110, 1), _span("rmcl.k2.block", 111, 3),
            _span("rmcl.k2.launch", 114, 2), _ev(K2, 115, 35, "kernel"),
            _span("rmcl.readback", 117, 35), _span("rmcl.k2.params", 250, 7)]


def canned_tiled():
    """Two frames of 1000 us over four cards. Frame 1: four tiles, each
    launching K2c on its card; the kernels start 1, 284, 268 and 247 us
    after their launch calls end (a fill launched in tile 1 waits longer
    and is no band); inputs 2 + 10 + 5 + 10 us. Frame 2: two tiles, K2c
    starting before its launch call ends (0) and 100 us after; inputs 3 +
    4 us."""
    ev = [_span("rmcl_bench.frame", 0, 1000), _span("rmcl_bench.frame", 1000, 1000)]
    launch = "cudaLaunchKernel"
    for card, (inputs, dur, k0) in enumerate([(2, 3, 19), (10, 3, 322), (5, 2, 325),
                                              (10, 2, 324)]):
        t0 = 10 + 20 * card
        ev += [_span("rmcl.tiling.tile", t0, 20), _span("rmcl.tiling.inputs", t0, inputs),
               _ev(launch, t0 + 5, dur, "cuda_runtime", corr=card + 1),
               _ev(K2C, k0, 300, "kernel", card, corr=card + 1)]
    ev += [_ev(launch, 40, 2, "cuda_runtime", corr=7), _ev(FILL, 900, 5, "kernel", 1, corr=7)]
    ev += [_span("rmcl.tiling.tile", 1010, 20), _span("rmcl.tiling.inputs", 1010, 3),
           _ev("cuLaunchKernelEx", 1015, 5, "cuda_driver", corr=8),
           _ev(K2C, 1018, 300, "kernel", 0, corr=8),
           _span("rmcl.tiling.tile", 1030, 20), _span("rmcl.tiling.inputs", 1030, 4),
           _ev(launch, 1035, 5, "cuda_runtime", corr=9),
           _ev(K2C, 1140, 300, "kernel", 1, corr=9)]
    return ev


def _ctx(events, kind="NVIDIA H100 80GB HBM3"):
    return {"trace": Trace(events), "cell": SimpleNamespace(data={}), "kind": kind,
            "frames": 2, "window_s": 0.5, "setup_s": 3.0, "accel_s": 0.25}


def _read(metric, ctx):
    return spec.load_reader(metric).read(ctx)


def test_still_span_readers_on_a_canned_trace():
    ctx = _ctx(canned_still())
    assert _read("host.params_ms.still", ctx) == pytest.approx(1.5e-3)
    assert _read("host.block_ms.still", ctx) == pytest.approx(4e-3)
    assert _read("host.launch_ms.still", ctx) == pytest.approx(2.5e-3)
    assert _read("host.readback_ms.still", ctx) == pytest.approx(11e-3)
    for m in TILED_METRICS:
        assert _read(m, ctx) is None


def test_tiled_span_readers_on_a_canned_trace():
    ctx = _ctx(canned_tiled())
    assert _read("tiling.inputs_ms", ctx) == pytest.approx((27 + 7) / 2 * 1e-3)
    assert _read("tiling.band_wait_ms", ctx) == pytest.approx((284 + 100) / 2 * 1e-3)
    for m in STILL_METRICS:
        assert _read(m, ctx) is None


@pytest.mark.parametrize("events", [[], canned_still()[:2]])
def test_span_readers_without_spans(events):
    """No trace spans of the port (a version from before them, or a frame
    with none): every span reader gives None."""
    for m in STILL_METRICS + TILED_METRICS:
        assert _read(m, _ctx(events)) is None
        assert _read(m, {"frames": 2}) is None  # an untraced run


def test_band_wait_needs_a_matched_launch():
    """Tiles whose launches match no render-pass kernel (the CPU's plain
    version launches none) give no band wait."""
    ev = [e for e in canned_tiled() if e["cat"] != "kernel" or e["name"] == FILL]
    assert _read("tiling.band_wait_ms", _ctx(ev)) is None
    assert _read("tiling.inputs_ms", _ctx(ev)) == pytest.approx(17e-3)


def test_copied_mb_reads_the_tiling_counters(monkeypatch):
    from raymarchcl_tpu_torch.parallel import tiling

    monkeypatch.setattr(tiling, "CALLS", 0)
    assert _read("tiling.copied_mb", _ctx([])) is None
    monkeypatch.setattr(tiling, "CALLS", 4)
    monkeypatch.setattr(tiling, "COPIED_BYTES", 4 * 161_218_560)
    assert _read("tiling.copied_mb", _ctx([])) == pytest.approx(161.21856)
    monkeypatch.delattr(tiling, "CALLS")  # a version without the counters
    assert _read("tiling.copied_mb", _ctx([])) is None


def test_occupancy_readers(monkeypatch):
    import torch

    from raymarchcl_tpu_torch.ops.kernels import render_pass

    assert _read("kernel.k2_occupancy", _ctx([], kind="cpu")) is None
    asked = []

    def occupancy(reflective, device=None):
        asked.append(reflective)
        return {"warps_per_sm": 16 if reflective else 24}

    monkeypatch.setattr(render_pass, "occupancy", occupancy)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(max_threads_per_multi_processor=2048))
    assert _read("kernel.k2_occupancy", _ctx([])) == pytest.approx(37.5)
    assert _read("kernel.k2c_occupancy", _ctx([])) == pytest.approx(25.0)
    assert asked == [False, True]
    monkeypatch.delattr(render_pass, "occupancy")  # a version without the query
    assert _read("kernel.k2c_occupancy", _ctx([])) is None


def test_tiny_traced_runs_read_the_spans(tiny_root):
    """On the CPU the tiled entry records its tile spans but launches no
    kernel: the inputs read a number, the band wait nothing; a still
    reads its readback and no rmcl.k2.* span."""
    res = run.run("tiny-ao.tiled8-x4", 2**31 + 11, 0.0, True, device="cpu", root=tiny_root,
                  t_start=time.perf_counter(), log=lambda *a: None)
    got = res["metrics"]
    assert isinstance(got["tiling.inputs_ms"]["value"], float)
    assert got["tiling.inputs_ms"]["unit"] == "ms"
    assert "tiling.band_wait_ms" not in got
    assert got["tiling.copied_mb"]["value"] == 0.0  # four CPU entries, one device
    assert "kernel.k2_occupancy" not in got and "kernel.k2c_occupancy" not in got
    res = run.run("tiny-ao.still8", 2**31 + 12, 0.0, True, device="cpu", root=tiny_root,
                  t_start=time.perf_counter(), log=lambda *a: None)
    got = res["metrics"]
    assert got["host.readback_ms.still"]["value"] >= 0.0
    assert not {"host.params_ms.still", "host.block_ms.still", "host.launch_ms.still"} & set(got)
