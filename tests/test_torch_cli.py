"""The port's animation, preview and CLI entry points (api.test_anim,
api.preview_overrides, api.test_render(preview=True), __main__) and its
runtime module, against the JAX package's on the CPU. Volumes go through
`.vox` files in tmp_path, so no test shares the volume cache."""

import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from raymarchcl_tpu import api as j_api
from raymarchcl_tpu.__main__ import main as j_cli
from raymarchcl_tpu_torch import api, runtime
from raymarchcl_tpu_torch.__main__ import main as cli
from raymarchcl_tpu_torch.io import voxio
from raymarchcl_tpu_torch.io.imageio import load_gray
from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import render as render_mod
from raymarchcl_tpu_torch.ops.camera import compute_eyepos

torch.set_num_threads(1)

TREFOIL = os.path.join(os.path.dirname(__file__), "..", "assets", "trefoil.stl")


@pytest.fixture(scope="module")
def gyroid16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vol") / "g16.vox")
    voxio.save_volume(path, 16, generators.make_gyroid_volume({"vres": [16] * 3}))
    return path


def _rgb(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


def _close_images(a, b):
    """The golden thresholds (tests/test_goldens.py): mad < 0.15 and under
    0.5% of channels off by more than 8."""
    d = np.abs(a - b)
    assert a.shape == b.shape
    assert d.mean() < 0.15 and (d > 8).mean() < 0.005, (d.mean(), (d > 8).mean())


def test_anim_matches_jax_and_carries_accum(tmp_path, gyroid16, capsys):
    """3 frames at 24x16, 2 spp, ao: each frame within the golden
    thresholds of the JAX package's; frames differ (the camera orbits); and
    frame 1 differs from a fresh render of its configuration, as the
    accumulation carried across frames blends into it (core.clj:194-208)."""
    paths = api.test_anim(24, 16, 2, 16, "ao", vname=gyroid16, out_dir=str(tmp_path / "t"),
                          frames=3, device="cpu")
    assert [os.path.basename(p) for p in paths] == [f"frame-000{i}.png" for i in range(3)]
    assert capsys.readouterr().out.count("rendered frame #") == 3
    j_paths = j_api.test_anim(24, 16, 2, 16, "ao", vname=gyroid16,
                              out_dir=str(tmp_path / "j"), frames=3, verbose=False)
    imgs = [_rgb(p) for p in paths]
    for got, want in zip(imgs, j_paths):
        _close_images(got, _rgb(want))
    assert not np.array_equal(imgs[0], imgs[1]) and not np.array_equal(imgs[1], imgs[2])
    t = 1 / 3
    volume, vres = api.load_or_generate_volume(gyroid16, None)
    argb, _ = api.render_frame(
        volume, vres, iter=2, device="cpu",
        times=torch.arange(2, dtype=torch.float32) * render_mod.TIME_STEP_ANIM,
        width=24, height=16, mat="ao", fov=115.0, targetpos=[0, -0.15, 0],
        eyepos=compute_eyepos(t * 350.0, 2.25, 0.44 + t * 0.01))
    fresh = (argb & 0xFF).astype(np.uint8)
    assert not np.array_equal(fresh, load_gray(paths[1]))


def test_anim_needs_card_by_default(tmp_path, gyroid16, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.test_anim(8, 6, 1, 16, "ao", vname=gyroid16, out_dir=str(tmp_path), frames=1)


@pytest.mark.parametrize("kw,it", [({}, 1), ({}, 0), ({"aoIter": 4, "fov": 60}, 3),
                                   ({"maxIter": 8, "dof": 0.1}, 1)])
def test_preview_overrides_equal(kw, it):
    assert api.PREVIEW_BUDGETS == j_api.PREVIEW_BUDGETS
    assert api.preview_overrides(dict(kw), it) == j_api.preview_overrides(dict(kw), it)


def test_preview_render_matches_jax(gyroid16):
    kw = dict(width=24, height=16, iter=1, mat="ao", vname=gyroid16, out_path=None,
              verbose=False, preview=True, seed=3)
    got = api.test_render(device="cpu", **kw)
    want = np.asarray(j_api.test_render(**kw))
    _close_images(got.view(np.uint8).reshape(16, 24, 4)[..., :3].astype(np.int32),
                  want.view(np.uint8).reshape(16, 24, 4)[..., :3].astype(np.int32))
    full = api.test_render(device="cpu", **dict(kw, preview=False))
    assert not np.array_equal(got, full)  # the budgets took effect


@pytest.mark.parametrize("kind", ["gyroid", "terrain"])
def test_cli_gen_volume_byte_equal(tmp_path, kind, capsys):
    cli(["gen-volume", kind, "--vres", "16", "-o", str(tmp_path / "t.vox")])
    j_cli(["gen-volume", kind, "--vres", "16", "-o", str(tmp_path / "j.vox")])
    assert "wrote" in capsys.readouterr().out
    assert (tmp_path / "t.vox").read_bytes() == (tmp_path / "j.vox").read_bytes()


@pytest.mark.parametrize("mode", [["--mode", "point"], ["--mode", "ks", "--ks", "2"],
                                  ["--mode", "scatter", "--seed", "3"], []])
def test_cli_voxelize_byte_equal(tmp_path, mode):
    args = [TREFOIL, "--res", "32", *mode]
    cli(["voxelize", *args, "-o", str(tmp_path / "t.vox")])
    j_cli(["voxelize", *args, "-o", str(tmp_path / "j.vox")])
    got = (tmp_path / "t.vox").read_bytes()
    assert got == (tmp_path / "j.vox").read_bytes()
    vox, res = voxio.load_volume(str(tmp_path / "t.vox"))
    assert res == (32, 32, 32) and (vox > 0).sum() > 0


def test_cli_voxelize_small_binary_stl(tmp_path):
    stl = tmp_path / "tri.stl"
    with open(stl, "wb") as f:
        f.write(b"\x00" * 80 + struct.pack("<I", 1) + np.zeros(3, np.float32).tobytes())
        f.write(np.array([[0.2, 0.2, 0.5], [0.8, 0.2, 0.5], [0.5, 0.8, 0.5]], "<f4").tobytes())
        f.write(struct.pack("<H", 0))
    cli(["voxelize", str(stl), "--res", "16", "-o", str(tmp_path / "m.vox")])
    j_cli(["voxelize", str(stl), "--res", "16", "-o", str(tmp_path / "j.vox")])
    vox, res = voxio.load_volume(str(tmp_path / "m.vox"))
    assert res == (16, 16, 16) and (vox > 0).sum() > 0
    assert (tmp_path / "m.vox").read_bytes() == (tmp_path / "j.vox").read_bytes()


def test_cli_render_preview_on_cpu(tmp_path, gyroid16):
    out = tmp_path / "r.png"
    cli(["render", "--width", "32", "--height", "18", "--iter", "1", "--vname", gyroid16,
         "--mat", "ao", "--preview", "--device", "cpu", "-o", str(out)])
    img = load_gray(str(out))
    assert img.shape == (18, 32) and img.std() > 0  # not a flat frame


def test_cli_render_and_anim_need_card_by_default(tmp_path, gyroid16, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["render", "--width", "8", "--height", "6", "--vname", gyroid16,
             "-o", str(tmp_path / "r.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["anim", "--width", "8", "--height", "6", "--vname", gyroid16, "--frames", "1",
             "-o", str(tmp_path / "a")])
    assert not (tmp_path / "r.png").exists()


def test_cli_anim_on_cpu(tmp_path, gyroid16, capsys):
    cli(["anim", "--width", "12", "--height", "8", "--iter", "1", "--vname", gyroid16,
         "--mat", "ao", "--frames", "2", "--device", "cpu", "-o", str(tmp_path / "a")])
    assert "wrote 2 frames" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "a")) == ["frame-0000.png", "frame-0001.png"]


def test_cli_info(capsys):
    cli(["info"])
    out = capsys.readouterr().out
    assert f"platform: {runtime.select_platform()}" in out
    assert "card (name, power limit):" in out and "nvcc:" in out


def test_cli_rejects_unknown_command(monkeypatch):
    with pytest.raises(SystemExit):
        cli(["frobnicate"])
    # bench is ported (scripts/bench.py): like every render, on the card unless --device cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["bench"])


def test_runtime_devices(monkeypatch):
    assert runtime.max_device(platform="cpu") == torch.device("cpu")
    assert runtime.devices("cpu") == [torch.device("cpu")]
    assert runtime.check_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="platform"):
        runtime.devices("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runtime.select_platform() == "cpu"
    for call in (runtime.max_device, runtime.devices, lambda: runtime.check_device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_runtime_card_names_the_devices_card(monkeypatch):
    """card(device) is that card's line of nvidia-smi, found by its UUID
    (here the second card, listed first); card() is every card's; a CPU
    device has no card."""
    import subprocess
    from types import SimpleNamespace

    assert runtime.card("cpu") == "cpu"
    smi = "GPU-bbbb, Card B, 350.00 W\nGPU-aaaa, Card A, 700.00 W\n"
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: SimpleNamespace(returncode=0, stdout=smi))
    uuids = ["aaaa", "bbbb"]
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid=uuids[i]))
    assert runtime.card() == "Card B, 350.00 W\nCard A, 700.00 W"
    assert runtime.card("cuda:0") == "Card A, 700.00 W"
    assert runtime.card(torch.device("cuda", 1)) == "Card B, 350.00 W"
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: SimpleNamespace(returncode=9, stdout=""))
    assert runtime.card("cuda:0") == "unavailable (rc 9)"


def test_runtime_build_log_without_a_build(monkeypatch):
    from raymarchcl_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "build_info", {})
    log = runtime.build_log()
    assert log.startswith("build log:") and "no kernel library loaded" in log
    monkeypatch.setattr(build, "build_info", dict(path="/x/lib.so", seconds=1.5, cached=False,
                                                  log="ptxas info : Used 80 registers\n"))
    log = runtime.build_log()
    assert "library: /x/lib.so" in log and "nvcc: 1.50 s" in log and "80 registers" in log
