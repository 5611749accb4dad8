"""The port's headline benchmark (raymarchcl_tpu_torch/scripts/bench.py)
against the JAX package's bench.py: the gate refuses rather than
decorates (as tests/test_bench_gate.py holds bench.py to it), a failure is
never turned into a smaller configuration, and the JSON line has bench.py's
keys and meanings. The gate itself runs on the card (test_torch_cuda.py)."""

import ast
import json
import os
import statistics

import pytest
import torch

from raymarchcl_tpu_torch import api, runtime
from raymarchcl_tpu_torch.scripts import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BENCH_SIZE="16", BENCH_SPP="1", BENCH_VRES="32", BENCH_REPS="2")


def _jax_keys():
    """The keys of the JSON line bench.py's run() prints, read from its
    source (running it would compile the JAX render)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    dumps = next(n for n in ast.walk(run) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "dumps")
    return {k.value for k in dumps.args[0].keys}


@pytest.fixture
def on_fake_card(monkeypatch):
    """main() sees a card; setup builds nothing; returns the calls made."""
    calls = {"setup": [], "run": []}
    monkeypatch.setattr(runtime, "check_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(runtime, "card", lambda device=None: "Fake card, 700.00 W")
    monkeypatch.setattr(bench, "setup", lambda *a: calls["setup"].append(a) or "scene")
    monkeypatch.setattr(bench, "run", lambda *a: calls["run"].append(a))
    return calls


def test_bench_refuses_on_invariant_mismatch(on_fake_card, monkeypatch):
    monkeypatch.setattr(bench, "check_invariants", lambda scene, default: {"accel_on_off": False})
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code == 1
    # the JSON line is still produced (run was reached), with the gate's verdict
    assert len(on_fake_card["run"]) == 1
    assert on_fake_card["run"][0][3] == {"accel_on_off": False}


def test_bench_proceeds_on_invariants_ok(on_fake_card, monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "check_invariants",
                        lambda scene, default: seen.append(default) or {"accel_on_off": True,
                                                                        "plain_64": True})
    bench.main([])  # no SystemExit
    assert len(on_fake_card["run"]) == 1
    assert seen == [True]  # the default config is the main path: its digests are checked
    scene, reps, chunk, inv, device = on_fake_card["run"][0]
    assert (reps, chunk, device) == (5, 16, "Fake card, 700.00 W")
    assert on_fake_card["setup"] == [(512, 512, 16, 256, "ao", True, torch.device("cuda"))]


def test_bench_raising_run_propagates_without_a_smaller_config(on_fake_card, monkeypatch):
    monkeypatch.setattr(bench, "check_invariants", lambda scene, default: {"accel_on_off": True})

    def boom(*a):
        on_fake_card["run"].append(a)
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(bench, "run", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        bench.main([])
    assert len(on_fake_card["run"]) == 1 and len(on_fake_card["setup"]) == 1


def test_bench_cpu_line_has_jax_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(api, "VOLUME_CACHE_DIR", str(tmp_path))
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _jax_keys()
    assert out["metric"] == "gyroid16_1spp_ao_frame_time"  # bench.py's f-string
    assert out["unit"] == "s" and out["accel"] is True and out["device"] == "cpu"
    assert len(out["samples"]) == 2 and out["value"] == statistics.median(out["samples"])
    assert out["vs_baseline"] == pytest.approx(1.0 / out["value"])
    assert out["mrays_per_sec"] == pytest.approx(16 * 16 / out["value"] / 1e6)
    assert 0.0 < out["primary_hit_fraction"] <= 1.0
    assert out["invariants"] is None  # no gate without a card


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])  # the CLI's `bench`: tests/test_torch_cli.py


def test_bench_refuses_bad_counts(monkeypatch):
    monkeypatch.setenv("BENCH_HOST_CHUNK", "0")
    with pytest.raises(ValueError, match="BENCH_HOST_CHUNK"):
        bench.main(["--device", "cpu"])
