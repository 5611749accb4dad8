"""The frozen reference held to the port's plain version on the CPU, at tiny
frames: every pixel's accum and packed image bit-equal, for `ao`, `metal`
and depth of field, over a pixel range, and with all passes as lanes
against pass by pass."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.ops import render as port_render
from raymarchcl_tpu_torch.options import render_options
from rmcl_bench import inputs
from rmcl_bench.reference.options import frame_options
from rmcl_bench.reference.render import blend, pass_colors, reference_pixels

VRES, W, H, P = 32, 10, 6, 2
TARGET = [0, -0.4, 0]


@pytest.fixture(scope="module")
def scene():
    vol = inputs.gyroid_volume(VRES, "cpu")
    tables = inputs.mc_tables(P, 2**31 + 5, "cpu")
    eyes = np.stack([inputs.compute_eyepos(th, 2.25, 0.35) for th in (25.0, 160.0)])
    return vol, tables, eyes


def _port(vol, tables, eye, mat, dof, **kw):
    opts = render_options(width=W, height=H, vres=VRES, iter=P, mat=mat, eyepos=eye,
                          targetpos=TARGET, **({"dof": dof} if dof else {}), **kw)
    return opts, port_render.render_image(vol, opts, tables)


@pytest.mark.parametrize("mat,dof", [("ao", None), ("metal", None), ("ao", 0.025),
                                     ("metal", 0.025)])
def test_reference_equals_port_plain(scene, mat, dof):
    vol, tables, eyes = scene
    ropts = frame_options(W, H, VRES, P, mat, dof=dof, targetpos=TARGET)
    ids = torch.arange(W * H).expand(len(eyes), -1)
    acc, img = reference_pixels(vol, ropts, tables, inputs.pass_times(P),
                                torch.from_numpy(eyes), ids)
    for f, eye in enumerate(eyes):
        _, (argb, accum) = _port(vol, tables, eye, mat, dof)
        assert torch.equal(acc[f], accum)
        assert np.array_equal(img[f].numpy().astype(np.uint32), argb.reshape(-1))


def test_reference_budgets_equal_port_plain(scene):
    """The preview's budgets, passed as overrides on both sides."""
    vol, tables, eyes = scene
    budgets = dict(maxIter=32, maxVoxelIter=48, shadowIter=32, aoIter=2)
    ropts = frame_options(W, H, VRES, P, "ao", targetpos=TARGET, **budgets)
    ids = torch.arange(W * H)[None]
    acc, _ = reference_pixels(vol, ropts, tables, inputs.pass_times(P),
                              torch.from_numpy(eyes[:1]), ids)
    _, (_, accum) = _port(vol, tables, eyes[0], "ao", None, **budgets)
    assert torch.equal(acc[0], accum)


def test_reference_pixel_range_equals_port_range(scene):
    """A pixel keeps its global id in any range: the reference at ids
    [lo, lo + n) equals the port's render_passes over that range."""
    vol, tables, eyes = scene
    lo, n = 17, 23
    opts, _ = _port(vol, tables, eyes[1], "metal", 0.025)
    accum = torch.zeros((n, 3))
    port_render.render_passes(vol, opts, tables, inputs.pass_times(P), accum, pix_lo=lo,
                              pix_count=n)
    ropts = frame_options(W, H, VRES, P, "metal", dof=0.025, targetpos=TARGET)
    acc, _ = reference_pixels(vol, ropts, tables, inputs.pass_times(P),
                              torch.from_numpy(eyes[1:]), torch.arange(lo, lo + n)[None])
    assert torch.equal(acc[0], accum)


def test_lanes_equal_pass_by_pass(scene):
    """All (frame, pixel, pass) lanes marched together give each pass's
    colour as a march of that pass alone, and blocks of lanes change
    nothing."""
    vol, tables, eyes = scene
    ropts = frame_options(W, H, VRES, P, "metal", targetpos=TARGET)
    times = inputs.pass_times(P)
    e = torch.from_numpy(eyes)
    ids = torch.tensor([[0, 7, 33, 59], [3, 4, 41, 58]])
    together = pass_colors(vol, ropts, tables, times, e, ids)
    for p in range(P):
        alone = pass_colors(vol, ropts, tables[p:p + 1], times[p:p + 1], e, ids)
        assert torch.equal(together[:, :, p], alone[:, :, 0])
    acc, img = reference_pixels(vol, ropts, tables, times, e, ids)
    acc_b, img_b = reference_pixels(vol, ropts, tables, times, e, ids, block_lanes=1)
    assert torch.equal(acc, blend(ropts, together)) and torch.equal(acc, acc_b)
    assert torch.equal(img, img_b)


def test_bfloat16_blend_departs(scene):
    """The control's blend (bfloat16) is another answer than float32's."""
    vol, tables, eyes = scene
    ropts = frame_options(W, H, VRES, P, "ao", targetpos=TARGET)
    cols = pass_colors(vol, ropts, tables, inputs.pass_times(P),
                       torch.from_numpy(eyes[:1]), torch.arange(W * H)[None])
    diff = (blend(ropts, cols, torch.bfloat16) - blend(ropts, cols)).abs()
    assert float((diff > 1e-4).float().mean()) > 0.5
