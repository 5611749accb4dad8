"""The benchmark's own tests (CPU; the `cuda` ones run on a card).

    python -m pytest rmcl_bench/tests -q

`tiny_root` builds a checkout of the harness with two tiny cells (a 32^3
gyroid, `ao`, 2 spp: 8x8 frames through render_image, and 8x6 frames with
depth of field tiled over four CPU "cards"), so that a whole run (set-up, window, check, trace)
takes seconds on the CPU. The tiny cells are judged at the limits committed
for the cells they stand for (`STANDS_FOR`).
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY = {
    "configs": {
        "tiny-ao": {"volume": {"generator": "gyroid", "vres": 32}, "mat": "ao", "options": {},
                    "reduced": []},
        "tiny-metal": {"volume": {"generator": "gyroid", "vres": 32}, "mat": "metal",
                       "options": {}, "reduced": []},
    },
    "traffic": {
        "still8": {"entry": "render_image", "width": 8, "height": 8, "spp": 2,
                   "camera": {"poses": 3, "dist": 2.25, "y": 0.35, "target": [0, -0.4, 0]},
                   "budgets": {}, "trace_frames": 2},
        "tiled8-x4": {"entry": "render_image_tiled", "width": 8, "height": 6, "spp": 2,
                      "camera": {"poses": 2, "dist": 2.25, "y": 0.35,
                                 "target": [0, -0.4, 0], "dof": 0.025},
                      "budgets": {"maxIter": 32, "maxVoxelIter": 48, "shadowIter": 32,
                                  "aoIter": 2},
                      "trace_frames": 1},
    },
    "workloads": {
        "tiny-ao.still8": {"check": {"frames": 2, "pixels": 24},
                           "work": {"ops_per_frame": 1e6, "bytes_per_frame": 1e5}},
        "tiny-ao.tiled8-x4": {"check": {"frames": 1, "pixels": 48}},
    },
}
# Each tiny cell is judged at the committed limits of the cell it stands for.
STANDS_FOR = {"tiny-ao.still8": "gyroid256-ao.still512",
              "tiny-ao.tiled8-x4": "gyroid256-metal.showcase1024-x4"}


def committed_limits(tiny_cell):
    with open(os.path.join(BENCH, "workloads", f"{STANDS_FOR[tiny_cell]}.json")) as f:
        return json.load(f)["check"]["limits"]


def tiny_benchmark():
    real = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    cells = [{"name": "tiny-ao.still8", "config": "tiny-ao", "traffic": "still8", "chips": 1,
              "why": "test"},
             {"name": "tiny-ao.tiled8-x4", "config": "tiny-ao", "traffic": "tiled8-x4",
              "chips": 4, "why": "test"}]
    per_layer = [dict(m, workloads=["tiny-ao.still8", "tiny-ao.tiled8-x4"])
                 for m in real["per_layer"]]
    e2e = [dict(m, workloads=["tiny-ao.still8", "tiny-ao.tiled8-x4"])
           if "workloads" in m else m for m in real["end_to_end"]]
    return dict(real, workloads=cells, per_layer=per_layer, end_to_end=e2e,
                configs=[{"name": c, "source": "test", "file": f"rmcl_bench/configs/{c}.json",
                          "reduced": [], "why": "test"} for c in TINY["configs"]])


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root holding BENCHMARK.json with the tiny cells and the
    harness's data folders (the metric readers copied)."""
    root = tmp_path / "checkout"
    bench = root / "rmcl_bench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind, files in TINY.items():
        (bench / kind).mkdir(parents=True)
        for name, data in files.items():
            if kind == "workloads":
                data = dict(data, check=dict(data["check"], limits=committed_limits(name)))
            (bench / kind / f"{name}.json").write_text(json.dumps(data))
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_benchmark()))
    return str(root)


@pytest.fixture
def stands_for():
    return dict(STANDS_FOR)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
