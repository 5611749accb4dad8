"""The harness on the CPU: cells, configurations and metrics found by name;
inputs that repeat for a seed; the trace readers on a canned chrome trace;
the result line's keys; BENCHMARK.json against the benchmark's contract."""

from __future__ import annotations

import functools
import io
import json
import os
import re
import shutil
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from rmcl_bench import entries, inputs, peaks, run, spec
from rmcl_bench.trace import Trace, idle_by_place, render_kind

BENCH, REPO = spec.BENCH_DIR, spec.ROOT

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# --- found by name -------------------------------------------------------------

STILL4 = {"entry": "render_image", "width": 4, "height": 4, "spp": 1,
          "camera": {"poses": 2, "dist": 2.25, "y": 0.35, "target": [0, -0.4, 0]},
          "budgets": {}, "trace_frames": 1}
# A volume source and an entry point that exist only as files of a checkout.
BALL = """import torch


def make(volume_cfg, device):
    n, r = int(volume_cfg["vres"]), float(volume_cfg["radius"])
    c = (torch.arange(n, device=device, dtype=torch.float32) + 0.5) / n - 0.5
    d = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2).sqrt()
    return torch.where((d - r).abs() < 1.0 / n, 255, 0).to(torch.uint8).reshape(-1)
"""
WRAPPED = """from raymarchcl_tpu_torch.ops.render import render_image


def make(scene):
    return lambda opts: render_image(scene.vol, opts, scene.tables, accel=scene.accel)
"""
# The accepted cells' volumes and entry points, as the harness resolved them
# before either could be a file.
ACCEPTED = {"gyroid256-ao.still512": "_render_image",
            "gyroid256-metal.still512": "_render_image",
            "gyroid256-metal.showcase1024-x4": "_render_image_tiled",
            "gyroid512-ao.still512": "_render_image"}


def _drop(root, files=(), configs=(), traffic=(), cells=(), per_layer=()):
    """New files under the checkout's rmcl_bench/ and new BENCHMARK.json
    entries; a new cell also reports frame_ms. No file there is edited."""
    bench_dir = os.path.join(root, "rmcl_bench")
    for rel, text in files:
        os.makedirs(os.path.dirname(os.path.join(bench_dir, rel)), exist_ok=True)
        with open(os.path.join(bench_dir, rel), "x") as f:
            f.write(text)
    b = spec.load_benchmark(root)
    for kind, items in (("configs", configs), ("traffic", traffic)):
        for name, data in items:
            with open(os.path.join(bench_dir, kind, f"{name}.json"), "x") as f:
                json.dump(data, f)
    for config, tr, check in cells:
        name = f"{config}.{tr}"
        with open(os.path.join(bench_dir, "workloads", f"{name}.json"), "x") as f:
            json.dump({"check": check}, f)
        b["workloads"].append({"name": name, "config": config, "traffic": tr, "chips": 1,
                               "why": "test"})
        next(m for m in b["end_to_end"] if m["name"] == "frame_ms")["workloads"].append(name)
    b["per_layer"] += list(per_layer)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


def test_dropped_files_are_found(tiny_root):
    """A new configuration, traffic mix, cell and per-layer metric: new files
    and new BENCHMARK.json entries, no other edit."""
    _drop(tiny_root, files=[("metrics/frame.count.py",
                             "def read(ctx):\n    return float(ctx['frames'])\n")],
          configs=[("tiny-metal2", {"volume": {"generator": "gyroid", "vres": 32},
                                    "mat": "metal2", "options": {}, "reduced": []})],
          traffic=[("still4", STILL4)],
          cells=[("tiny-metal2", "still4",
                  {"frames": 1, "pixels": 4,
                   "limits": {"accum_off_pct": 1.0, "image_off_pct": 1.0}})],
          per_layer=[{"name": "frame.count", "unit": "frames", "better": "higher",
                      "source": "host_clock", "layer": "entry", "moves": "frame_ms",
                      "workloads": ["tiny-metal2.still4"]}])
    cell = spec.find_cell("tiny-metal2.still4", tiny_root)
    assert cell.config["mat"] == "metal2" and cell.traffic["width"] == 4
    assert [m["name"] for m in cell.per_layer] == ["frame.count"]
    res = run.run("tiny-metal2.still4", 5, 0.0, True, device="cpu", root=tiny_root,
                  t_start=time.perf_counter(), log=lambda *a: None)
    assert res["correct"] and res["metrics"]["frame.count"]["value"] == 1.0


def test_dropped_volume_source_and_entry_point_are_found(tiny_root):
    """A volume source (`volumes/<generator>.py`, a thin 16^3 sphere with a
    key of its own) and an entry point (`entrypoints/<entry>.py`, wrapping
    render_image) that only the checkout's new files define run a cell end
    to end, judged against the reference."""
    _drop(tiny_root, files=[("volumes/ball.py", BALL),
                            ("entrypoints/render_image_wrapped.py", WRAPPED)],
          configs=[("ball16-ao", {"volume": {"generator": "ball", "vres": 16,
                                             "radius": 0.3},
                                  "mat": "ao", "options": {}, "reduced": []})],
          traffic=[("wrapped4", dict(STILL4, entry="render_image_wrapped"))],
          cells=[("ball16-ao", "wrapped4",
                  {"frames": 2, "pixels": 16,
                   "limits": {"accum_off_pct": 2.0, "image_off_pct": 1.0}})])
    cell = spec.find_cell("ball16-ao.wrapped4", tiny_root)
    assert cell.root == tiny_root
    vol = entries.volume_source(cell.config["volume"], tiny_root)("cpu")
    assert vol.dtype == torch.uint8 and vol.shape == (16**3,) and 0 < int(vol.count_nonzero())
    res = run.run("ball16-ao.wrapped4", 2**31 + 16, 0.0, False, device="cpu",
                  root=tiny_root, t_start=time.perf_counter(), log=lambda *a: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["value"] == 0.0 for v in res["checks"].values())
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_accepted_cells_resolve_as_before(name):
    cell = spec.find_cell(name)
    vol_cfg = cell.config["volume"]
    make = entries.volume_source(vol_cfg, REPO)
    assert make.func is inputs.gyroid_volume and make.args == (vol_cfg["vres"],)
    assert entries.entry_point(cell.traffic["entry"], REPO) is getattr(entries, ACCEPTED[name])


@pytest.mark.parametrize("kind", ["generator", "entry"])
def test_unknown_name_fails_at_setup(tiny_root, monkeypatch, kind):
    """An unknown volume generator or entry point stops the run before any
    frame, naming the known ones, and the command prints no result."""
    vol = {"generator": "nope" if kind == "generator" else "gyroid", "vres": 16}
    _drop(tiny_root, configs=[("nope-ao", {"volume": vol, "mat": "ao", "options": {},
                                           "reduced": []})],
          traffic=[("nope4", dict(STILL4, entry="nope" if kind == "entry" else "render_image"))],
          cells=[("nope-ao", "nope4", {"frames": 1, "pixels": 4,
                                       "limits": {"accum_off_pct": 2.0, "image_off_pct": 1.0}})])
    frames = []
    monkeypatch.setattr(entries.Scene, "frame", lambda self, eye: frames.append(eye))
    known = "gyroid" if kind == "generator" else "render_image, render_image_tiled"
    with pytest.raises(spec.UnknownName, match=f"no 'nope'; known: {known}$"):
        run.run("nope-ao.nope4", 1, 0.0, False, device="cpu", root=tiny_root,
                t_start=time.perf_counter(), log=lambda *a: None)
    assert frames == []
    monkeypatch.setattr(run, "run", functools.partial(run.run, device="cpu", root=tiny_root,
                                                      log=lambda *a: None))
    rc, out = _main_with_argv(["--workload", "nope-ao.nope4", "--seed", "1", "--seconds", "0"])
    assert rc != 0 and out == "" and frames == []


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        spec.find_cell("tiny-ao.nope", tiny_root)


# --- inputs from the seed ---------------------------------------------------------


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    seed = 2**31 + 2**30 + 17  # beyond 32 signed bits
    cam = {"poses": 36, "dist": 2.25, "y": 0.35}
    ring = inputs.camera_ring(cam, seed)
    assert ring.shape == (36, 3) and (ring == inputs.camera_ring(cam, seed)).all()
    assert not (ring == inputs.camera_ring(cam, seed + 1)).all()
    # every seed has the same ring up to a rotation: the same distance and height
    r2 = inputs.camera_ring(cam, seed + 1)
    assert torch.allclose(torch.from_numpy(ring[:, [0, 2]]).norm(dim=1),
                          torch.from_numpy(r2[:, [0, 2]]).norm(dim=1))
    t1 = inputs.mc_tables(2, seed, "cpu")
    assert torch.equal(t1, inputs.mc_tables(2, seed, "cpu"))
    assert not torch.equal(t1, inputs.mc_tables(2, seed + 1, "cpu"))
    assert torch.allclose(t1.norm(dim=-1), torch.ones(2, inputs.T_LEN), atol=1e-6)
    px = inputs.check_pixels(seed, 3, 512 * 512, 64)
    assert torch.equal(px, inputs.check_pixels(seed, 3, 512 * 512, 64))
    assert not torch.equal(px, inputs.check_pixels(seed + 1, 3, 512 * 512, 64))
    assert all(len(set(r.tolist())) == 64 for r in px)
    picks = [inputs.rng(seed, "keep").randrange(1000) for _ in range(2)]
    assert picks[0] == picks[1] != inputs.rng(seed + 1, "keep").randrange(1000)


def test_gyroid_volume_is_the_generator():
    """generators.clj:27-42, as the port's numpy generator makes it."""
    from raymarchcl_tpu_torch.models.generators import make_gyroid_volume

    ours = inputs.gyroid_volume(48, "cpu").numpy()
    assert (ours == make_gyroid_volume(48)).mean() > 0.9999
    assert set(ours.tolist()) <= {0, 64, 128, 255}


# --- the trace readers on a canned trace --------------------------------------------

K2 = "void render_passes_kernel<Build<true, false, false> >(RmclParams, RangeWork)"
K2C = "void render_passes_kernel<Build<true, false, true> >(RmclParams, RangeWork)"


def _ev(name, ts, dur, cat, dev=0):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": dev,
            "args": {"device": dev}}


def canned():
    """Two frames of 100 us on card 0; frame 1 runs K2 at 10-60 and a copy
    at 70-80 (before 10, between 10, after 20); frame 2 runs K2 at 130-150
    (before 30, after 50)."""
    ev = [_ev("rmcl_bench.frame", 0, 100, "user_annotation"),
          _ev("rmcl_bench.frame", 100, 100, "user_annotation"),
          _ev(K2, 10, 50, "kernel"), _ev("Memcpy DtoH", 70, 10, "gpu_memcpy"),
          _ev(K2, 130, 20, "kernel"), _ev("cudaMemcpyAsync", 62, 20, "cuda_runtime"),
          _ev("rmcl_bench.options", 100, 25, "user_annotation")]
    return ev


def canned_tiled():
    """Two frames running K2c on four cards, 40/20/20/20 us (imbalance 40 /
    25 = 1.6), then 30 us on each (1.0)."""
    ev = [_ev("rmcl_bench.frame", 0, 100, "user_annotation"),
          _ev("rmcl_bench.frame", 100, 100, "user_annotation")]
    for card, (a, b) in enumerate([(40, 30), (20, 30), (20, 30), (20, 30)]):
        ev += [_ev(K2C, 10, a, "kernel", card), _ev(K2C, 110, b, "kernel", card)]
    return ev


def _ctx(events, work=None):
    cell = SimpleNamespace(data={"work": work} if work else {})
    return {"trace": Trace(events), "cell": cell, "kind": "NVIDIA H100 80GB HBM3",
            "frames": 2, "window_s": 0.5, "setup_s": 3.0, "accel_s": 0.25}


def _read(metric, ctx):
    return spec.load_reader(metric).read(ctx)


def test_idle_by_place_on_canned_trace():
    tr = Trace(canned())
    idle = idle_by_place(tr.frames, tr.spans(0))
    assert idle == {"before": 40.0, "between": 10.0, "after": 70.0, "busy": 80.0,
                    "wall": 200.0}
    assert tr.busy_us(0) == 80.0
    assert tr.kernel_us_by_frame("k2") == [50.0, 20.0]
    assert tr.kernel_us_by_frame("k2c") == [0.0, 0.0]
    assert render_kind(K2) == "k2" and render_kind(K2C) == "k2c"
    assert render_kind("void at::native::fill") is None


def test_readers_on_canned_trace():
    ctx = _ctx(canned(), work={"ops_per_frame": 67e6, "bytes_per_frame": 1.0})
    assert _read("host.before_ms.still", ctx) == pytest.approx(0.020)
    assert _read("host.after_ms.still", ctx) == pytest.approx(0.035)
    assert _read("kernel.k2_ms", ctx) == pytest.approx(0.035)
    assert _read("kernel.k2c_ms", ctx) is None
    assert _read("device.idle_share", ctx) == pytest.approx(60.0)
    # 67e6 operations at 67 TFLOP/s: 1 us over 35 us a frame
    assert _read("kernel.k2_roofline", ctx) == pytest.approx(100.0 / 35.0)
    assert _read("kernel.k2c_roofline", ctx) is None
    assert _read("tiling.band_imbalance", ctx) is None
    assert _read("frame_ms", ctx) == pytest.approx(250.0)
    assert _read("setup_s", ctx) == 3.0 and _read("setup.accel_s", ctx) == 0.25
    assert _read("kernel.k2_roofline", _ctx(canned())) is None  # no frozen work
    assert _read("device.idle_share", _ctx([])) is None


def test_band_imbalance_on_canned_trace():
    ctx = _ctx(canned_tiled())
    assert _read("tiling.band_imbalance", ctx) == pytest.approx((1.6 + 1.0) / 2)
    assert _read("kernel.k2c_ms", ctx) == pytest.approx((100 + 120) / 2 * 1e-3)
    tr = ctx["trace"]
    assert tr.cards == [0, 1, 2, 3]
    assert tr.device_ops()[0][0] == K2C[:160]


def test_idle_gaps_by_host_activity():
    gaps = dict(Trace(canned()).idle_gaps(0))
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)  # the gap 60-70
    assert gaps["rmcl_bench.options"] == pytest.approx(30e-6)  # before frame 2
    assert sum(gaps.values()) == pytest.approx(120e-6)


def test_roofline_bounds():
    assert peaks.roofline_pct("NVIDIA H100 80GB HBM3", 67e12, 0, 2.0) == pytest.approx(50.0)
    assert peaks.roofline_pct("NVIDIA H100 80GB HBM3", 0, 3.35e12, 4.0) == pytest.approx(25.0)
    assert peaks.roofline_pct("cpu", 1, 1, 1) is None


# --- the result line -----------------------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(tiny_root, trace):
    logged = []
    res = run.run("tiny-ao.still8", 2**31 + 3, 0.0, bool(trace), device="cpu",
                  root=tiny_root, t_start=time.perf_counter(), log=logged.append)
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    # set-up names the host's CPU on stderr, before the window
    host = [i for i, line in enumerate(logged) if line.startswith("host: ")]
    assert len(host) == 1 and "logical cores" in logged[host[0]]
    assert host[0] < next(i for i, line in enumerate(logged) if line.startswith("window: "))
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def _main_with_argv(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(list(argv))
    return rc, out.getvalue()


def _main_with(monkeypatch, result, argv=("--workload", "x", "--seed", "1", "--seconds", "1")):
    monkeypatch.setattr(run, "run", lambda *a, **k: result)
    return _main_with_argv(argv)


def test_main_prints_the_result_last(monkeypatch):
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
              "device": {"platform": "gpu"},
              "checks": {"accum_off_pct": {"value": 0.0, "limit": 1.0}}}
    rc, out = _main_with(monkeypatch, result)
    assert rc == 0
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == RESULT_KEYS + ["checks"]


def test_main_refuses_jax_loaded(monkeypatch):
    import types

    monkeypatch.setitem(__import__("sys").modules, "jax", types.ModuleType("jax"))
    rc, out = _main_with(monkeypatch, {"checks": {}})
    assert rc != 0 and out == ""


def test_forbidden_names_compared_whole(monkeypatch):
    import types

    import raymarchcl_tpu_torch  # noqa: F401

    assert "raymarchcl_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(__import__("sys").modules, "raymarchcl_tpu.ops",
                        types.ModuleType("raymarchcl_tpu.ops"))
    assert "raymarchcl_tpu" in run.forbidden_modules()


def test_no_card_no_result():
    """Without a card (this sandbox), the command exits non-zero and
    prints nothing on standard output."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "rmcl_bench.run", "--workload",
                        "gyroid256-ao.still512", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the harness, a run
    fails before any result: the port is not there."""
    import subprocess
    import sys

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "rmcl_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time, json; from rmcl_bench import run; print(json.dumps(run.run("
            "'gyroid256-ao.still512', 1, 0.0, False, device='cpu')))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""
    assert "raymarchcl_tpu_torch" in p.stderr


# --- BENCHMARK.json against the contract -----------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["rmcl_bench"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    assert len(cells) == len(b["workloads"]) and len(configs) == len(b["configs"])
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"] == f"rmcl_bench/configs/{c['name']}.json"
        assert any(w["config"] == c["name"] for w in cells.values())
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m.get("workloads", cells):
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
    for name, w in cells.items():
        assert NAME.match(name) and name == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = spec.find_cell(name)
        got = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        entries.volume_source(cell.config["volume"], REPO)  # resolves, or UnknownName
        entries.entry_point(cell.traffic["entry"], REPO)
        assert set(cell.data["check"]["limits"]) == {"accum_off_pct", "image_off_pct"}
