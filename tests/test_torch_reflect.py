"""The reflective presets (`metal`, `metal2`, `orange-stripes`) of the PyTorch
port against the JAX package's plain path (accel=None): the fast voxel
normal, the sphere trace with it (smooth=False), the bounce directions and
origins, and one bounce's colour (basic_scene_color); and reflective frames
with and without the brick table. Whole frames against the JAX package are
in test_torch_reflect_frame.py. The JAX package's march and bounce colours
are read from tests/jax_answers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_answers
from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import march as jm
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu.ops.vecmath import V3 as JV3
from raymarchcl_tpu.ops.vecmath import reflect as j_reflect
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.ops import accel
from raymarchcl_tpu_torch.ops import march as tm
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.ops import shade as tsh
from raymarchcl_tpu_torch.ops.vecmath import V3, fma3, reflect_fused
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

VRES = [32, 32, 96]
PRESETS = ("metal", "metal2", "orange-stripes")
REDUCED = dict(maxIter=48, maxVoxelIter=96, shadowIter=48)
TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51


def _t(a):
    return torch.from_numpy(np.array(a))


def _tv(v):
    return V3(*(_t(c) for c in v))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


@pytest.fixture(scope="module")
def vol():
    return generators.make_gyroid_volume({"vres": VRES})


def test_voxel_normal_fast_bit_equal():
    """Every voxel of a random 6x5x7 grid and a ring of voxels around it,
    against the JAX package's fast normal, bit for bit; a voxel without a
    gradient (inside a full block, and far outside the grid) gives +y."""
    rng = np.random.default_rng(1)
    vres = [6, 5, 7]
    vol = rng.integers(0, 64, 6 * 5 * 7).astype(np.uint8)
    vol[:30] = 200  # a full block: zero gradient inside it
    o, jo = render_options(vres=vres), j_render_options(vres=vres)
    g = np.meshgrid(np.arange(-1, 7), np.arange(-1, 6), np.arange(-1, 8), indexing="ij")
    q = [np.append(c.reshape(-1), 100).astype(np.int64) for c in g]
    got = tm.voxel_normal_fast(_t(vol), o, V3(*(_t(c) for c in q)))
    want = jm.voxel_normal_fast(jnp.asarray(vol), jo, JV3(*(jnp.asarray(c, jnp.int32) for c in q)))
    got, want = _np3(got), _np3(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    flat = (got == [0.0, 1.0, 0.0]).all(axis=1)
    assert flat[-1] and flat.sum() > 1 and not flat.all()  # +y: far outside and inside


def fast_march_kw(budget):
    """The 24x16 `metal` frame's options at `budget` (reduced or default)."""
    return dict(width=24, height=16, vres=VRES, mat="metal",
                eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0],
                **(REDUCED if budget == "reduced" else {}))


def jax_isec(answer):
    """The JAX package's march from its stored answer (`isec_*` arrays), as
    the JAX package returns it: jnp arrays, V3 where (3, N)."""
    return {k[5:]: JV3(*map(jnp.asarray, v)) if v.ndim == 2 else jnp.asarray(v)
            for k, v in answer.items() if k.startswith("isec_")}


@pytest.fixture(scope="module", params=["reduced", "default"])
def fast_march(request, vol):
    """Camera rays of a 24x16 frame traced by both packages with the fast
    normal (the bounce marches' smooth=False)."""
    kw = fast_march_kw(request.param)
    table = np.array(js.generate_scatter_offsets(seed=3))
    ans = jax_answers.load(f"reflect-fast-march-{request.param}",
                           jax_answers.digest(vol, table, kw))
    to = render_options(**kw)
    d = _tv(ans["d"])  # the same rays go into the port
    isec = tm.raymarch(_t(vol), to, _tv(ans["p"]), d, to.maxDist, to.maxIter,
                       torch.ones(d.x.shape[0], dtype=torch.bool), smooth=False)
    return dict(budget=request.param, to=to, d=d, px=_t(ans["px"]), py=_t(ans["py"]), isec=isec,
                want=jax_isec(ans), table=table)


def test_raymarch_fast_normal_matches_jax(fast_march):
    """Object ids, hits and fast normals bit-equal; positions and distances
    within the primary march's measured drift (tests/test_torch_march.py)."""
    isec, want = fast_march["isec"], fast_march["want"]
    np.testing.assert_array_equal(isec["object_id"].numpy(), np.asarray(want["object_id"]))
    np.testing.assert_array_equal(_np3(isec["normal"]), _np3(want["normal"]))
    hit = np.asarray(want["distance"]) < 30
    assert 0.2 < hit.mean() < 1
    np.testing.assert_allclose(isec["distance"].numpy(), np.asarray(want["distance"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np3(isec["pos"]), _np3(want["pos"]), rtol=1e-6, atol=1e-6)


def bounce_kw(mat, to):
    """The bounce's options: the frame's at `to`'s budgets, preset `mat`."""
    return dict(width=24, height=16, vres=VRES, mat=mat, eyepos=compute_eyepos(135, 2.25, 0.35),
                targetpos=[0, -0.4, 0], maxIter=to.maxIter, maxVoxelIter=to.maxVoxelIter,
                shadowIter=to.shadowIter)


def bounce_digest(vol, fm, mat, rays):
    r_dir, origin, act = rays
    return jax_answers.digest(vol, fm["table"], bounce_kw(mat, fm["to"]), np.stack(r_dir),
                              np.stack(origin), act, fm["px"], fm["py"])


def _bounce_rays(fm):
    """The first bounce of fast_march's hits, as the JAX package forms it:
    the direction reflected about the hit normal and the origin 0.0075
    along it."""
    want = fm["want"]
    d = JV3(*(jnp.asarray(c.numpy()) for c in fm["d"]))
    r_dir = j_reflect(d, want["normal"])
    origin = want["pos"] + r_dir * 0.0075
    return r_dir, origin, jnp.asarray(np.asarray(want["distance"]) < 30)


def test_bounce_direction_and_origin_bit_equal(fast_march):
    """vecmath.reflect_fused and the fused origin fma(dir, 0.0075, pos) are
    the JAX package's bounce ray, bit for bit, as XLA:CPU contracts them in
    one program."""
    want = fast_march["want"]

    @jax.jit
    def jfn(d, n, pos):
        r = j_reflect(d, n)
        return r, pos + r * 0.0075

    jr, jo = jfn(JV3(*(jnp.asarray(c.numpy()) for c in fast_march["d"])), want["normal"],
                 want["pos"])
    r = reflect_fused(fast_march["d"], _tv(want["normal"]))
    np.testing.assert_array_equal(_np3(r), _np3(jr))
    origin = fma3(_tv(jr), 0.0075, _tv(want["pos"]))
    np.testing.assert_array_equal(_np3(origin), _np3(jo))


@pytest.mark.parametrize("mat", PRESETS)
def test_basic_scene_color_matches_jax(fast_march, vol, mat):
    """One bounce (march with the fast normal, lighting with the sky's
    reflection, atmosphere from the bounce origin) from the same rays in
    both packages: object ids exact, colours within the parity tolerance."""
    fm = fast_march
    to = render_options(**bounce_kw(mat, fm["to"]))
    rays = _bounce_rays(fm)
    r_dir, origin, act = rays
    ans = jax_answers.load(f"reflect-bounce-{fm['budget']}-{mat}",
                           bounce_digest(vol, fm, mat, rays))
    col, isec = tsh.basic_scene_color(_t(vol), to, _t(fm["table"]), fm["px"], fm["py"],
                                      _tv(origin), _tv(r_dir), _t(act))
    a = np.asarray(act)
    np.testing.assert_array_equal(isec["object_id"].numpy()[a], ans["object_id"][a])
    got, want = _np3(col)[a], ans["colour"].T[a]
    assert np.isclose(got, want, **TOL).all(), np.abs(got - want).max()
    bounce_hit = ans["object_id"][a] >= 0
    assert 0 < bounce_hit.mean() < 1  # bounces that hit and bounces that miss


FRAME = dict(width=12, height=9, iter=2, vres=VRES, eyepos=compute_eyepos(135, 2.25, 0.35),
             targetpos=[0, -0.4, 0], **REDUCED)


@pytest.mark.parametrize("mat", PRESETS)
def test_brick_table_frame_bit_equal(vol, mat):
    """A reflective frame over the brick table equals the raw march's, bit
    for bit (every march of the bounces takes the table)."""
    opts = render_options(**dict(FRAME, mat=mat))
    tables = tables_from_numpy(np.asarray(js.make_mc_tables(2, seed=5)))
    v = volume_from_numpy(vol)
    argb, acc = t_render.render_image(v, opts, tables)
    argb_b, acc_b = t_render.render_image(v, opts, tables,
                                          accel=accel.build_accel(v, opts.voxelRes, opts.isoVal))
    assert torch.equal(acc, acc_b)
    np.testing.assert_array_equal(argb, argb_b)
