"""What decides `correct` has to fail where it should: whole runs of the
tiny cells on the CPU (the look for cards skipped) with the control in the
program's place, and with the timed path broken underneath in each way a
cell can break. A sound run of the same cell comes out correct."""

from __future__ import annotations

import json
import time

import pytest

import raymarchcl_tpu_torch.ops.render as port_render
import raymarchcl_tpu_torch.parallel.tiling as port_tiling
from raymarchcl_tpu_torch.ops.kernels.tonemap import tonemap_pack_plain
from rmcl_bench import run, spec

SEED = 2**31 + 99


def _run(root, cell, control=False, seed=SEED):
    return run.run(cell, seed, 0.0, False, device="cpu", control=control, root=root,
                   t_start=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("cell", ["tiny-ao.still8", "tiny-ao.tiled8-x4"])
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] and res["failed"] == 0
    assert all(v["value"] == 0.0 for v in res["checks"].values())


@pytest.mark.parametrize("seed", [SEED, 2**31 + 12345])
def test_control_is_not_correct(tiny_root, seed):
    """The reference in bfloat16 in the program's place."""
    res = _run(tiny_root, "tiny-ao.still8", control=True, seed=seed)
    assert not res["correct"]


def _unchanged(orig):
    """A step that returns its state unchanged: the passes are skipped."""
    def fake(vol, opts, tables, times, accum, accel=None, argb=None, pix_lo=0,
             pix_count=None):
        if argb is not None:
            argb.copy_(tonemap_pack_plain(accum, opts.gamma))
        return accum
    return fake


def _half(orig):
    """Half of the batch left out, the mean taken over the rest: the first
    half of the passes, blended as if they were all."""
    def fake(vol, opts, tables, times, accum, accel=None, argb=None, pix_lo=0,
             pix_count=None):
        k = max(1, tables.shape[0] // 2)
        return orig(vol, opts.replace(frameBlend=1.0 / k), tables[:k], times[:k], accum,
                    accel, argb, pix_lo, pix_count)
    return fake


def _altered(orig):
    """An answer altered where it is produced: the red channel 0.1% off."""
    def fake(vol, opts, tables, times, accum, accel=None, argb=None, pix_lo=0,
             pix_count=None):
        orig(vol, opts, tables, times, accum, accel, None, pix_lo, pix_count)
        accum[:, 0] *= 1.001
        if argb is not None:
            argb.copy_(tonemap_pack_plain(accum, opts.gamma))
        return accum
    return fake


@pytest.mark.parametrize("cell", ["tiny-ao.still8", "tiny-ao.tiled8-x4"])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_broken_render_is_not_correct(tiny_root, monkeypatch, cell, fault):
    monkeypatch.setattr(port_render, "render_passes", fault(port_render.render_passes))
    assert not _run(tiny_root, cell)["correct"]


def _not_gathered(bands):
    """The exchange between cards left out for the tiles `bands`: their rows
    keep the home card's zeroed accum and black pixels."""
    orig = port_tiling.render_image_tiled

    def fake(vol, opts, mc_tables, times=None, accum=None, mesh=None, accel=None):
        argb, acc = orig(vol, opts, mc_tables, times, accum, mesh, accel)
        blk = -(-opts.num_pixels // mesh.size)
        flat = argb.reshape(-1).copy()
        for b in bands:
            acc[b * blk:(b + 1) * blk] = 0.0
            flat[b * blk:(b + 1) * blk] = 0xFF000000
        return flat.reshape(argb.shape), acc
    return fake


@pytest.mark.parametrize("bands", [(1, 2, 3), (1,), (2,), (3,)])
def test_tiles_not_gathered_is_not_correct(tiny_root, monkeypatch, bands):
    """All the other cards' tiles, or one card's, not gathered."""
    monkeypatch.setattr(port_tiling, "render_image_tiled", _not_gathered(bands))
    assert not _run(tiny_root, "tiny-ao.tiled8-x4")["correct"]


def test_tiny_cells_take_the_committed_limits(tiny_root, stands_for):
    for tiny, real in stands_for.items():
        assert spec.find_cell(tiny, tiny_root).data["check"]["limits"] == \
            spec.find_cell(real).data["check"]["limits"]


# --- on a card, at each cell's own size and load --------------------------------

CELLS = ["gyroid256-ao.still512", "gyroid256-metal.still512",
         "gyroid256-metal.showcase1024-x4"]
FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half", "altered")] + [
    ("gyroid256-metal.showcase1024-x4", f"band{b}") for b in (1, 2, 3)]


def _run_on_cards(cell, control=False):
    import torch

    chips = spec.find_cell(cell).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    res = run.run(cell, SEED, 1.0, False, control=control, t_start=time.perf_counter(),
                  log=lambda *a: None)
    print(json.dumps({"cell": cell, "control": control, "correct": res["correct"],
                      "attempted": res["attempted"],
                      **{k: v["value"] for k, v in res["checks"].items()}}))
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(card, cell):
    """The control at the cell's own size and load."""
    assert not _run_on_cards(cell, control=True)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_render_at_the_cells_size_is_not_correct(card, monkeypatch, cell, fault):
    """Each fault the cell can have, at its own size, against its committed
    limits."""
    if fault.startswith("band"):
        monkeypatch.setattr(port_tiling, "render_image_tiled",
                            _not_gathered((int(fault[4:]),)))
    else:
        maker = {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault]
        monkeypatch.setattr(port_render, "render_passes", maker(port_render.render_passes))
    print(f"fault {fault}:", end=" ")
    assert not _run_on_cards(cell)["correct"]
