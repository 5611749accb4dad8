"""Whole frames of the reflective presets (`metal`, `metal2`,
`orange-stripes`): the PyTorch port's render_image (K2's plain version, the
spp blend and K1's plain pack) against the JAX package's plain render
(`render_image(accel=None)`, a single band below 8192 pixels), one JAX
render per preset, read from tests/jax_answers."""

import numpy as np
import pytest
import torch

import jax_answers
from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

VRES = [32, 32, 96]
PRESETS = ("metal", "metal2", "orange-stripes")
TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51
FRAME = dict(width=10, height=8, iter=1, vres=VRES, eyepos=compute_eyepos(135, 2.25, 0.35),
             targetpos=[0, -0.4, 0], maxIter=48, maxVoxelIter=96, shadowIter=48)


@pytest.fixture(scope="module")
def vol():
    return generators.make_gyroid_volume({"vres": VRES})


@pytest.fixture(scope="module", params=PRESETS)
def jax_frame(request, vol):
    """One JAX render (its plain, single-band path) per preset, and the MC
    table both packages take."""
    kw = dict(FRAME, mat=request.param)
    tables = np.asarray(js.make_mc_tables(1, seed=3))
    return dict(kw=kw, tables=tables, **jax_answers.load(f"reflect-frame-{request.param}",
                                                         jax_answers.digest(vol, tables, kw)))


def test_render_image_matches_jax(vol, jax_frame):
    """A whole frame: the accum within the parity tolerance on every pixel,
    and the image equal wherever the accums are bit-equal."""
    kw = jax_frame["kw"]
    opts = render_options(**kw)
    assert opts.reflectIter > 0
    argb, acc = t_render.render_image(volume_from_numpy(vol), opts,
                                      tables_from_numpy(jax_frame["tables"]))
    acc, j_acc = acc.numpy(), jax_frame["acc"]
    assert argb.dtype == np.uint32 and argb.shape == (kw["height"], kw["width"])
    ok = np.isclose(acc, j_acc, **TOL).all(axis=1)
    assert ok.all(), f"{(~ok).sum()}/{ok.size} pixels diverged"
    same = (acc == j_acc).all(axis=1)
    assert same.any()
    np.testing.assert_array_equal(argb.reshape(-1)[same], jax_frame["argb"].reshape(-1)[same])
    assert len(np.unique(argb)) > 16  # a real image
