"""The port's measurement scripts against the JAX package's
(raymarchcl_tpu_torch/scripts/run_configs.py, bench_anim.py and
preview_quality.py against scripts/*.py): the same configs, keys and SSIM,
run on the CPU at tiny sizes."""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from raymarchcl_tpu.ops.camera import compute_eyepos as j_compute_eyepos
from raymarchcl_tpu_torch import api
from raymarchcl_tpu_torch.ops import render
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.scripts import bench_anim, preview_quality, run_configs
from raymarchcl_tpu_torch.scripts.digests import DIGESTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _main_of(name):
    tree = ast.parse(open(os.path.join(SCRIPTS, name)).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(fn, target):
    """The expression assigned to `target` in the function's body."""
    return next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == target)


def _jax_configs(s):
    """scripts/run_configs.py's configs list, evaluated from its source with
    the volumes as their names (building them needs the JAX package's
    voxelizers and the gyroid at 256^3)."""
    fn = _main_of("run_configs.py")
    env = dict(compute_eyepos=j_compute_eyepos, max=max, dict=dict, s=s,
               gy256="gy256", bunny64="bunny64", dragon="dragon")
    env["cam"] = eval(compile(ast.Expression(_assigned(fn, "cam")), "run_configs", "eval"), env)
    return eval(compile(ast.Expression(_assigned(fn, "configs")), "run_configs", "eval"), env)


def _json_keys(name):
    """The keys of the JSON line the script's main prints."""
    dumps = next(n for n in ast.walk(_main_of(name)) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "dumps")
    return {k.value for k in dumps.args[0].keys}


@pytest.mark.parametrize("s", [1, 4])
def test_run_configs_are_the_jax_scripts(s):
    port = run_configs.configs("gy256", "bunny64", "dragon", s=s)
    jax_cfgs = _jax_configs(s)
    assert [n for n, _ in port] == [n for n, _ in jax_cfgs]
    for (name, p), (_, j) in zip(port, jax_cfgs):
        j = dict(j)
        if name.startswith("5:"):
            assert j.pop("host_slices") == 4  # TPU scheduling: no pixel changes, not ported
        assert set(p) == set(j), name
        for k in j:
            assert np.array_equal(np.asarray(p[k]), np.asarray(j[k])), (name, k)
            assert np.asarray(p[k]).dtype == np.asarray(j[k]).dtype, (name, k)
    if s == 1:  # every config at full spp has its frame's digests
        assert {run_configs.digest_key(n, p["spp"]) for n, p in port} <= set(DIGESTS)


def test_render_timed_is_render_image():
    vol, res = api.default_volume(32, cache=False)
    kw = dict(width=12, height=8, mat="ao", eyepos=compute_eyepos(135, 2.25, 0.35),
              targetpos=[0, -0.4, 0])
    dt, argb, accum = run_configs.render_timed(vol, res, 3, host_chunk=2, device="cpu", **kw)
    opts = render_options(vres=list(res), iter=3, **kw)
    want_argb, want_acc = render.render_image(torch.from_numpy(vol), opts,
                                              make_mc_tables(3, seed=0),
                                              accel=api.build_accel_for(vol, opts))
    assert dt > 0
    assert np.array_equal(argb, want_argb) and torch.equal(accum, want_acc)


def test_run_configs_main_table_and_lines(tmp_path, monkeypatch, capsys):
    vol, res = api.default_volume(16, cache=False)
    cam = dict(eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    monkeypatch.setattr(run_configs, "volumes", lambda: (vol, vol, vol))
    monkeypatch.setattr(run_configs, "configs", lambda g, b, d, s=1: [
        ("8: tiny ao", dict(volume=g, vres=res, spp=2, width=8, height=6, mat="ao", **cam)),
        ("9: tiny metal", dict(volume=d, vres=res, spp=1, width=6, height=4, mat="metal",
                               **cam))])
    rows = run_configs.main(["--device", "cpu", "--host-chunk", "1"])
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in err.strip().splitlines()]
    assert [r["config"] for r in lines] == ["8: tiny ao", "9: tiny metal"] and lines == rows
    assert all(r["digests_equal"] is None and r["device"] == "cpu" and r["seconds"] > 0
               for r in lines)
    assert "| 8: tiny ao | 8x6 | 2 |" in out and "| 9: tiny metal | 6x4 | 1 |" in out


def test_bench_anim_prints_jax_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(api, "VOLUME_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bench_anim, "PREVIEW_SIZE", 16)  # 256 on the card
    bench_anim.main(["--size", "16", "--spp", "1", "--vres", "32", "--frames", "2",
                     "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == _json_keys("bench_anim.py")
    assert out["anim_config"] == "16^2/1spp/ao" and out["device"] == "cpu"
    assert len(out["steady_state_s_per_frame"]) == 2
    assert out["steady_state_median_s"] in out["steady_state_s_per_frame"]
    assert out["preview_256_s"] > 0


def _jax_preview_quality():
    spec = importlib.util.spec_from_file_location("jax_preview_quality",
                                                  os.path.join(SCRIPTS, "preview_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ssim_is_the_jax_scripts():
    jpq = _jax_preview_quality()
    rng = np.random.default_rng(11)
    argb = rng.integers(0, 2**32, (2, 37, 45), dtype=np.uint64).astype(np.uint32)
    a, b = preview_quality.argb_to_rgb(argb[0]), preview_quality.argb_to_rgb(argb[1])
    assert np.array_equal(a, jpq.argb_to_rgb(argb[0])) and a.dtype == np.uint8
    noisy = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    for x, y in ((a, b), (a, noisy), (a, a)):
        assert preview_quality.ssim(x, y) == jpq.ssim(x, y)
    assert preview_quality.ssim(a, a) == pytest.approx(1.0)


def test_preview_quality_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(api, "VOLUME_CACHE_DIR", str(tmp_path))
    res = preview_quality.main(["--size", "16", "--vres", "32", "--spp", "2", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("size=16 vres=32 mat=ao: full=") and "speedup=" in last
    assert -1.0 <= res["ssim"] <= 1.0 and res["speedup"] > 0
