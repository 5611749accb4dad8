"""BASELINE config 3, the voxelized mesh, through the harness on the CPU:
the cell `trefoil64-ao.still512-c3` and its files resolved by name; the
benchmark's own voxelizer (`reference/mesh.py`) against the program's,
byte for byte; a whole run of a small cell over the committed
`trefoil64-ao` configuration (the real 64^3 volume, 8x8 frames, 2 spp,
2 poses at config 3's camera) judged at the limits committed for the
cell; a voxel planted wrong in the program's volume, which stops the run
before its window; the reader `setup.voxelize_s`, which gives None where
the port records no such counter."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

import numpy as np
import pytest

from rmcl_bench import check, entries, run, spec
from rmcl_bench.reference import mesh as reference_mesh

BENCH = spec.BENCH_DIR
CELL, STANDS_FOR = "trefoil64-ao.still8", "trefoil64-ao.still512-c3"
STL = "assets/trefoil.stl"
TRAFFIC = {"entry": "render_image", "width": 8, "height": 8, "spp": 2,
           "camera": {"poses": 2, "dist": 2.0, "y": 0.5, "target": [0, 0, 0]},
           "budgets": {}, "trace_frames": 1}
SEED = 2**31 + 64


def _write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json holds one small cell over the
    committed `trefoil64-ao` configuration, with the harness's readers,
    volume sources and the STL file."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "rmcl_bench"
    for folder in ("metrics", "volumes", "configs"):
        shutil.copytree(os.path.join(BENCH, folder), bench / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "assets").mkdir()
    shutil.copy(os.path.join(spec.ROOT, STL), root / STL)
    _write(bench / "traffic" / "still8.json", TRAFFIC)
    committed = spec.find_cell(STANDS_FOR)
    _write(bench / "workloads" / f"{CELL}.json",
           {"check": dict(committed.data["check"], frames=2, pixels=64)})
    real = spec.load_benchmark()
    _write(root / "BENCHMARK.json", dict(
        real, configs=[c for c in real["configs"] if c["name"] == "trefoil64-ao"],
        workloads=[{"name": CELL, "config": "trefoil64-ao", "traffic": "still8", "chips": 1,
                    "why": "test"}],
        end_to_end=[dict(m, workloads=[CELL]) if "workloads" in m else m
                    for m in real["end_to_end"]],
        per_layer=[dict(m, workloads=[CELL]) for m in real["per_layer"]]))
    return str(root)


@pytest.fixture(scope="module")
def result(root):
    """The run's result, with the port's voxelizer counter as the run left
    it under `counter`."""
    from raymarchcl_tpu_torch.models import mesh

    res = run.run(CELL, SEED, 0.0, True, device="cpu", root=root,
                  t_start=time.perf_counter(), log=lambda *a: None)
    return dict(res, counter=copy.deepcopy(mesh.LAST_VOXELIZE))


@pytest.fixture(scope="module")
def trefoil():
    from raymarchcl_tpu_torch.models import mesh

    return mesh.read_stl(os.path.join(spec.ROOT, STL)), reference_mesh.read_stl(
        os.path.join(spec.ROOT, STL))


def test_the_harness_resolves_the_cell():
    cell = spec.find_cell(STANDS_FOR)
    assert cell.chips == 1
    assert cell.config["volume"] == {"generator": "stl_ks", "vres": 64, "stl": STL, "ks": 1}
    assert cell.config["mat"] == "ao" and cell.config["reduced"] == []
    assert cell.traffic["entry"] == "render_image"
    assert (cell.traffic["width"], cell.traffic["height"], cell.traffic["spp"]) == (512, 512, 16)
    assert cell.traffic["camera"] == {"poses": 36, "dist": 2.0, "y": 0.5, "target": [0, 0, 0]}
    assert cell.data["check"] == {"frames": 4, "pixels": 1024,
                                  "limits": {"accum_off_pct": 2.0, "image_off_pct": 1.0}}
    make = entries.volume_source(cell.config["volume"], cell.root)
    assert make.func.__module__ == "rmcl_bench.volumes.stl_ks"
    assert make.args == (cell.config["volume"],)
    assert entries.entry_point(cell.traffic["entry"], cell.root) is entries._render_image
    names = [m["name"] for m in cell.per_layer]
    assert "setup.voxelize_s" in names and "kernel.k2_ms" in names
    for name in names:
        assert callable(spec.load_reader(name).read), name
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms", "setup_s"]


def test_the_reference_reads_the_ports_vertices(trefoil):
    port, ref = trefoil
    assert ref.dtype == np.float64 and ref.shape == port.shape == (18000, 3)
    np.testing.assert_array_equal(ref.astype(np.float32), port)
    np.testing.assert_array_equal(ref, port.astype(np.float64))


def test_the_reference_reads_an_ascii_stl_as_the_port(tmp_path):
    from raymarchcl_tpu_torch.models import mesh

    p = tmp_path / "t.stl"
    p.write_text("solid t\n facet normal 0 0 1\n  outer loop\n"
                 "   vertex 0 0 0\n   vertex 1.5 0 0.1\n   vertex 0 2 0\n"
                 "  endloop\n endfacet\n facet normal 0 1 0\n  outer loop\n"
                 "   vertex 0 0 0\n   vertex -1.25 0.5 3e-1\n   vertex 0 2 0\n"
                 "  endloop\n endfacet\nendsolid t\n")
    np.testing.assert_array_equal(reference_mesh.read_stl(p), mesh.read_stl(p))


@pytest.mark.parametrize("vres,ks", [(64, 1), (40, 2)])
def test_the_reference_voxelizes_as_the_port(trefoil, vres, ks):
    from raymarchcl_tpu_torch.models import mesh

    port, ref = trefoil
    got, want = mesh.voxelize_ks(port, vres, ks), reference_mesh.voxelize_ks(ref, vres, ks)
    assert want.dtype == np.uint8 and want.shape == (vres**3,)
    assert set(np.unique(want)) == {0, 255}
    np.testing.assert_array_equal(got, want)
    if (vres, ks) == (64, 1):
        assert np.count_nonzero(want) == 38673


def test_a_whole_run_over_the_mesh_is_correct(result):
    assert result["correct"] and result["failed"] == 0
    assert result["checks"] == {"accum_off_pct": {"value": 0.0, "limit": 2.0},
                                "image_off_pct": {"value": 0.0, "limit": 1.0}}


def test_the_voxelizer_reader_reads_the_run(monkeypatch, result, root):
    from raymarchcl_tpu_torch.models import mesh

    counter = result["counter"]
    got = result["metrics"]["setup.voxelize_s"]
    assert got["unit"] == "s" and got["value"] > 0.0
    seconds = counter["seconds"]
    assert got["value"] == seconds["read_stl"] + seconds["voxelize"]
    assert seconds["read_stl"] > 0.0  # the voxelized vertices are the read's
    assert (counter["vertices"], counter["res"], counter["occupied"]) == (18000, 64, 38673)
    # the same volume's brick table, two passes' MC tables, the volume
    assert result["metrics"]["kernel.k2_footprint_mb"]["value"] == (
        64**3 + 2 * 16384 * 16 + 8**3 * 72) / 1e6
    reader = spec.load_reader("setup.voxelize_s", root)
    monkeypatch.delattr(mesh, "LAST_VOXELIZE")
    assert reader.read({}) is None


def test_a_planted_voxel_stops_the_run_before_its_window(monkeypatch, root):
    from raymarchcl_tpu_torch.models import mesh

    voxelize_ks = mesh.voxelize_ks

    def planted(verts, vres, ks):
        vol = voxelize_ks(verts, vres, ks)
        vol[12345] ^= 255  # one voxel flipped
        return vol

    def no_window(*a, **k):
        raise AssertionError("the window opened")

    monkeypatch.setattr(mesh, "voxelize_ks", planted)
    monkeypatch.setattr(run, "window", no_window)
    with pytest.raises(ValueError, match=r"1 of 262144 voxels .* differ"):
        run.run(CELL, SEED, 0.0, False, device="cpu", root=root,
                t_start=time.perf_counter(), log=lambda *a: None)


def test_reference_options_at_64_are_the_ports(root):
    from raymarchcl_tpu_torch.options import render_options

    cell = spec.find_cell(CELL, root)
    ref = check.reference_options(cell)
    cam = cell.traffic["camera"]
    port = render_options(width=8, height=8, vres=64, iter=2, mat="ao",
                          targetpos=cam["target"], eyepos=[0.0, 0.5, 2.0])
    assert ref.voxelRes == port.voxelRes == (64, 64, 64, 4096)
    assert ref.voxelSize == port.voxelSize == 1.0 / 64
    for k in ("voxelBounds", "voxelBounds2", "voxelBoundsMin", "voxelBoundsMax",
              "invVoxelScale", "maxIter", "maxVoxelIter", "isoVal", "aoStepDist"):
        assert getattr(ref, k) == getattr(port, k), k
