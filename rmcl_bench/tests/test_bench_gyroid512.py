"""The reference's default volume, the 512^3 gyroid, through the harness on
the CPU: a whole run of a small cell over the real volume (8x8 frames,
2 spp, 2 poses, `ao`, render_image over the brick table) judged at the
limits committed for `gyroid512-ao.still512`; the reference's options at
512^3 against the port's; the two readers of the port's counters
(`setup.accel_voxels_s`, `kernel.k2_footprint_mb`), which give None where
the port records no such counter."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest

from rmcl_bench import check, run, spec

BENCH = spec.BENCH_DIR
CELL, STANDS_FOR = "gyroid512-ao.still8", "gyroid512-ao.still512"
TRAFFIC = {"entry": "render_image", "width": 8, "height": 8, "spp": 2,
           "camera": {"poses": 2, "dist": 2.25, "y": 0.35, "target": [0, -0.4, 0]},
           "budgets": {}, "trace_frames": 1}
READERS = ("setup.accel_voxels_s", "kernel.k2_footprint_mb")


def _write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json holds one small cell over the
    committed `gyroid512-ao` configuration, with the harness's readers."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "rmcl_bench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(BENCH, "configs"), bench / "configs")
    _write(bench / "traffic" / "still8.json", TRAFFIC)
    committed = spec.find_cell(STANDS_FOR)
    _write(bench / "workloads" / f"{CELL}.json",
           {"check": dict(committed.data["check"], frames=2, pixels=64)})
    real = spec.load_benchmark()
    _write(root / "BENCHMARK.json", dict(
        real, configs=[c for c in real["configs"] if c["name"] == "gyroid512-ao"],
        workloads=[{"name": CELL, "config": "gyroid512-ao", "traffic": "still8", "chips": 1,
                    "why": "test"}],
        end_to_end=[dict(m, workloads=[CELL]) if "workloads" in m else m
                    for m in real["end_to_end"]],
        per_layer=[dict(m, workloads=[CELL]) for m in real["per_layer"]]))
    return str(root)


@pytest.fixture(scope="module")
def result(root):
    return run.run(CELL, 2**31 + 512, 0.0, True, device="cpu", root=root,
                   t_start=time.perf_counter(), log=lambda *a: None)


def test_a_whole_run_over_the_512_gyroid_is_correct(result):
    assert result["correct"] and result["failed"] == 0
    assert result["checks"] == {"accum_off_pct": {"value": 0.0, "limit": 2.0},
                                "image_off_pct": {"value": 0.0, "limit": 1.0}}


def test_the_readers_read_the_run(result):
    got = {k: result["metrics"][k]["value"] for k in READERS}
    assert got["setup.accel_voxels_s"] > 0.0
    # the 512^3 volume, two passes' MC tables, 64^3 brick rows of 18 words
    assert got["kernel.k2_footprint_mb"] == (512**3 + 2 * 16384 * 16 + 64**3 * 72) / 1e6


@pytest.mark.parametrize("metric", READERS)
def test_the_readers_without_the_counters(monkeypatch, result, root, metric):
    from raymarchcl_tpu_torch.ops import accel
    from raymarchcl_tpu_torch.ops.kernels import render_pass

    reader = spec.load_reader(metric, root)
    assert reader.read({}) is not None  # the run's counters
    monkeypatch.delattr(accel, "LAST_BUILD")
    monkeypatch.delattr(render_pass, "BOUND_BYTES")
    assert reader.read({}) is None


def test_reference_options_at_512_are_the_ports(root):
    from raymarchcl_tpu_torch.options import render_options

    cell = spec.find_cell(CELL, root)
    ref = check.reference_options(cell)
    cam = cell.traffic["camera"]
    port = render_options(width=8, height=8, vres=512, iter=2, mat="ao",
                          targetpos=cam["target"], eyepos=[0.0, 0.35, 2.25])
    assert ref.voxelRes == port.voxelRes == (512, 512, 512, 262144)
    assert ref.voxelSize == port.voxelSize == 1.0 / 512
    for k in ("voxelBounds", "voxelBounds2", "voxelBoundsMin", "voxelBoundsMax",
              "invVoxelScale", "maxIter", "maxVoxelIter", "isoVal", "aoStepDist"):
        assert getattr(ref, k) == getattr(port, k), k
