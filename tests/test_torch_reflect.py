"""The reflective presets (`metal`, `metal2`, `orange-stripes`) of the PyTorch
port against the JAX package's plain path (accel=None): the fast voxel
normal, the sphere trace with it (smooth=False), the bounce directions and
origins, and one bounce's colour (basic_scene_color); and reflective frames
with and without the brick table. Whole frames against the JAX package are
in test_torch_reflect_frame.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import march as jm
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops import shade as jsh
from raymarchcl_tpu.ops.camera import camera_ray_lookat as j_camera
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


@pytest.fixture(scope="module", params=["reduced", "default"])
def fast_march(request, vol):
    """Camera rays of a 24x16 frame traced by both packages with the fast
    normal (the bounce marches' smooth=False)."""
    w, h = 24, 16
    n = w * h
    kw = dict(width=w, height=h, vres=VRES, mat="metal",
              eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0],
              **(REDUCED if request.param == "reduced" else {}))
    table = np.array(js.generate_scatter_offsets(seed=3))

    @jax.jit
    def jfn(o, v, table_t):
        st = js.init_render_state(o, table_t, jnp.arange(n, dtype=jnp.int32))
        p, d = j_camera(o, st)
        i = jm.raymarch(v, o, p, d, o.maxDist, o.maxIter, smooth=False,
                        active=jnp.ones(n, bool))
        return p, d, st["px"], st["py"], i

    to = render_options(**kw)
    jp, jd, px, py, ji = jfn(j_render_options(**kw), jnp.asarray(vol),
                             js.transpose_table(jnp.asarray(table)))
    d = _tv(jd)  # the same rays go into the port
    isec = tm.raymarch(_t(vol), to, _tv(jp), d, to.maxDist, to.maxIter,
                       torch.ones(n, dtype=torch.bool), smooth=False)
    return dict(to=to, d=d, px=_t(px), py=_t(py), isec=isec, want=ji, table=table)


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
    kw = dict(width=24, height=16, vres=VRES, mat=mat, eyepos=compute_eyepos(135, 2.25, 0.35),
              targetpos=[0, -0.4, 0], maxIter=fm["to"].maxIter,
              maxVoxelIter=fm["to"].maxVoxelIter, shadowIter=fm["to"].shadowIter)
    jo, to = j_render_options(**kw), render_options(**kw)
    r_dir, origin, act = _bounce_rays(fm)
    table = fm["table"]
    jcol, jisec = jax.jit(
        lambda o, v, t, px, py, p, d, a: jsh.basic_scene_color(v, o, t, px, py, p, d, a))(
        jo, jnp.asarray(vol), js.transpose_table(jnp.asarray(table)),
        jnp.asarray(fm["px"].numpy()), jnp.asarray(fm["py"].numpy()), origin, r_dir, act)
    col, isec = tsh.basic_scene_color(_t(vol), to, _t(table), fm["px"], fm["py"], _tv(origin),
                                      _tv(r_dir), _t(act))
    a = np.asarray(act)
    np.testing.assert_array_equal(isec["object_id"].numpy()[a], np.asarray(jisec["object_id"])[a])
    got, want = _np3(col)[a], _np3(jcol)[a]
    assert np.isclose(got, want, **TOL).all(), np.abs(got - want).max()
    bounce_hit = np.asarray(jisec["object_id"])[a] >= 0
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
