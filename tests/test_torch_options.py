"""Options of the PyTorch port against the JAX package: every field of
`raymarchcl_tpu_torch.options.render_options` equals JAX's exactly, and
`convert.opts_from_numpy` of the JAX options equals the port's own."""

import dataclasses

import numpy as np
import pytest
import torch

from raymarchcl_tpu.ops.camera import compute_eyepos as j_eyepos
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.convert import opts_from_numpy
from raymarchcl_tpu_torch.materials import PRESETS, get_preset
from raymarchcl_tpu_torch.options import DYNAMIC_FIELDS, RenderOpts, render_options

torch.set_num_threads(1)

EYE = [float(v) for v in j_eyepos(135.0, 2.25, 0.35)]
KWARGS = {
    # bench.py:109-112 (the main path)
    "bench": dict(width=512, height=512, vres=[256] * 3, iter=16, eyepos=EYE,
                  targetpos=[0, -0.4, 0]),
    # tests/test_goldens.py CASES + BUDGETS through api.test_render
    "golden": dict(width=64, height=48, iter=2, vres=[48] * 3, eyepos=EYE,
                   targetpos=[0, -0.4, 0], maxIter=32, maxVoxelIter=64, shadowIter=32),
    "dof-anim": dict(width=48, height=32, iter=2, vres=[48, 48, 96], eyepos=EYE,
                     dof=0.05, fov=115.0, t=0.3333, gamma=2.0),
    "defaults": dict(),
}
PRESET_NAMES = ["ao", "metal", "metal2", "orange-stripes", ":metal", "unknown"]


def _fields(opts):
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}


def _np_fields(j):
    return {k: (np.asarray(v) if k in DYNAMIC_FIELDS else v) for k, v in _fields(j).items()}


def _assert_same(port, jax_fields):
    assert set(_fields(port)) == set(jax_fields)
    for name, want in jax_fields.items():
        got = getattr(port, name)
        if name in DYNAMIC_FIELDS:
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32),
                                          err_msg=name)
            assert got.numpy().shape == np.asarray(want).shape, name
        else:
            assert got == want and type(got) is type(want), (name, got, want)


@pytest.mark.parametrize("mat", PRESET_NAMES)
@pytest.mark.parametrize("case", sorted(KWARGS))
def test_render_options_equal_jax(case, mat):
    kw = dict(KWARGS[case], mat=mat)
    _assert_same(render_options(**kw), _np_fields(j_render_options(**kw)))


@pytest.mark.parametrize("mat", PRESET_NAMES)
def test_opts_from_numpy_equals_port(mat):
    kw = dict(KWARGS["golden"], mat=mat)
    port = render_options(**kw)
    carried = opts_from_numpy(_np_fields(j_render_options(**kw)))
    assert isinstance(carried, RenderOpts)
    _assert_same(carried, {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in _fields(port).items()})


def test_presets_and_replace():
    assert get_preset(None) is PRESETS["ao"] and get_preset("nope") is PRESETS["ao"]
    o = render_options(width=8, height=4, vres=8)
    o2 = o.replace(time=0.666, eyePos=[1.0, 2.0, 3.0])
    assert o2.time.dtype == torch.float32 and float(o2.time) == np.float32(0.666)
    assert o2.eyePos.tolist() == [1.0, 2.0, 3.0]
    assert float(o.time) == 0.0  # the original is untouched
    assert (o2.width, o2.height, o2.num_pixels) == (8, 4, 32)
