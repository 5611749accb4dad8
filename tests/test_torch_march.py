"""The marcher of the PyTorch port against the JAX package's plain path
(accel=None): primary sphere traces on camera rays, shadow rays, the slab
test on rays that start on a slab plane, and the march hazards (the two iso
tests, saturating voxel-coordinate and object-id casts, NaN-suppressing
fmin/fmax)."""

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
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.ops import march as tm
from raymarchcl_tpu_torch.ops import shade as tsh
from raymarchcl_tpu_torch.ops.vecmath import V3, dot, normalize
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

W, H = 32, 24
N = W * H
VRES = [32, 32, 96]
BUDGETS = {"reduced": dict(maxIter=48, maxVoxelIter=96, shadowIter=48), "default": {}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tv(v):
    return V3(*(_t(c) for c in v))


@pytest.fixture(scope="module")
def vol():
    return generators.make_gyroid_volume({"vres": VRES})


@pytest.fixture(scope="module", params=sorted(BUDGETS))
def primary(request, vol):
    """Camera rays of a 32x24 frame marched by both packages."""
    kw = dict(width=W, height=H, vres=VRES, mat="ao", eyepos=compute_eyepos(135, 2.25, 0.35),
              targetpos=[0, -0.4, 0], **BUDGETS[request.param])
    jo, to = j_render_options(**kw), render_options(**kw)
    table = np.array(js.generate_scatter_offsets(seed=3))

    @jax.jit
    def jfn(o, vol, table_t):
        st = js.init_render_state(o, table_t, jnp.arange(N, dtype=jnp.int32))
        p, d = j_camera(o, st)
        i = jm.raymarch(vol, o, p, d, o.maxDist, o.maxIter, smooth=True,
                        active=jnp.ones(N, bool))
        return p, d, i["object_id"], i["distance"], i["pos"], i["normal"]

    jp, jd, jid, jdist, jpos, jn = jfn(jo, jnp.asarray(vol), js.transpose_table(jnp.asarray(table)))
    p, d = _tv(jp), _tv(jd)  # the same rays go into the port
    isec = tm.raymarch(_t(vol), to, p, d, to.maxDist, to.maxIter, torch.ones(N, dtype=torch.bool))
    want = dict(object_id=np.asarray(jid), distance=np.asarray(jdist),
                pos=[np.asarray(c) for c in jpos], normal=[np.asarray(c) for c in jn])
    return dict(jo=jo, to=to, vol=vol, isec=isec, want=want, p=p, d=d)


def test_primary_object_ids_and_hits_exact(primary):
    isec, want = primary["isec"], primary["want"]
    np.testing.assert_array_equal(isec["object_id"].numpy(), want["object_id"])
    np.testing.assert_array_equal(isec["distance"].numpy() < 30, want["distance"] < 30)
    assert 0.2 < (want["distance"] < 30).mean() < 1  # both hits and misses present


def test_primary_distance_pos_normal(primary):
    """Measured on this frame: distances bit-equal on ~98.6% of rays, the
    rest within 2.4e-7; positions within 3.8e-7, normals within 1.2e-7.
    Cause: XLA:CPU's rsqrt is up to 2 ulp off the 1/sqrt both the port and
    its CUDA kernel use, which moves ray directions by an ulp."""
    isec, want = primary["isec"], primary["want"]
    same = isec["object_id"].numpy() == want["object_id"]
    np.testing.assert_allclose(isec["distance"].numpy()[same], want["distance"][same],
                               rtol=1e-6, atol=1e-6)
    assert (isec["distance"].numpy() == want["distance"]).mean() > 0.9
    for got, w in zip((*isec["pos"], *isec["normal"]), (*want["pos"], *want["normal"])):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)


def test_shadow_rays_exact(primary):
    """Shadow rays (truncate_to_max_dist) from the primary hits toward the
    light: the 0/1 shadow factor is exact."""
    jo, to, vol, isec = primary["jo"], primary["to"], primary["vol"], primary["isec"]
    hit = isec["distance"] < 30
    lp = V3(*(torch.full((N,), float(v)) for v in to.lightPos[0, :3]))
    delta = lp - isec["pos"]
    ldir = normalize(delta)
    lmax = torch.minimum(torch.sqrt(dot(delta, delta)) - to.shadowBias, to.maxDist)
    origin = V3(*(c + dc * 0.1 for c, dc in zip(isec["pos"], ldir)))
    got = tsh.shadow(_t(vol), to, origin, ldir, lmax, hit)
    j_ldir = JV3(*(jnp.asarray(c.numpy()) for c in ldir))
    j_origin = JV3(*(jnp.asarray(c.numpy()) for c in origin))
    want = jax.jit(lambda o, v, org, ld, lm, a: jsh.shadow(v, o, org, ld, lm, a))(
        jo, jnp.asarray(vol), j_origin, j_ldir, jnp.asarray(lmax.numpy()),
        jnp.asarray(hit.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got[hit].mean()) < 1  # lit and shadowed points present


def test_intersects_box_on_slab_planes():
    """Rays starting exactly on a slab plane with a zero direction component
    divide 0/0 = NaN; NaN-suppressing fmin/fmax (not torch.minimum, which
    propagates NaN) give the reference's answer."""
    b = 0.99
    px = np.array([b, -b, b, 0.0, -b, 0.5, 2.0, b], np.float32)
    py = np.array([0.0, 0.2, b, b, -b, -b, 0.0, -b], np.float32)
    pz = np.array([0.1, 0.0, -b, 0.3, 0.0, 0.2, 0.0, b], np.float32)
    dx = np.array([0.0, 0.0, 0.0, 1.0, 0.6, 0.0, -1.0, 0.0], np.float32)
    dy = np.array([1.0, 0.0, 0.0, 0.0, 0.8, 1.0, 0.0, 0.0], np.float32)
    dz = np.array([0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0], np.float32)
    lo, hi = (-b,) * 3, (b,) * 3
    got = tm.intersects_box(lo, hi, V3(_t(px), _t(py), _t(pz)), V3(_t(dx), _t(dy), _t(dz)))
    want = jm.intersects_box(lo, hi, JV3(*map(jnp.asarray, (px, py, pz))),
                             JV3(*map(jnp.asarray, (dx, dy, dz))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.isnan(got).any()
    # the hazard: a NaN-propagating min would poison the result
    nan = torch.tensor([float("nan")])
    assert torch.isnan(torch.minimum(nan, torch.tensor([1.0]))).all()
    assert torch.fmin(nan, torch.tensor([1.0])).item() == 1.0


def test_two_iso_tests():
    """Occupancy for normals is v >= isoVal (march.py:184); the march hit is
    v > isoVal (march.py:359). A voxel of exactly isoVal is occupied but
    never hit."""
    vres = [8, 8, 8]
    o, jo = render_options(vres=vres), j_render_options(vres=vres)
    vol = np.zeros(512, np.uint8)
    vol[4 * 64 + 4 * 8 + 2] = 32  # == isoVal
    vol[4 * 64 + 4 * 8 + 5] = 33  # > isoVal
    q = V3(*(torch.tensor(v) for v in ([2, 5, 3], [4, 4, 4], [4, 4, 4])))
    occ = tm.occupancy_i(_t(vol), o, q)
    np.testing.assert_array_equal(occ.numpy(), [1.0, 1.0, 0.0])
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jm.occupancy_i(jnp.asarray(vol), jo, JV3(*(jnp.asarray(c.numpy()) for c in q)))))
    # march along +x through both voxels: the 32 is passed, the 33 is hit
    p0 = V3(torch.tensor([0.01]), torch.tensor([4.5 / 8]), torch.tensor([4.5 / 8]))
    delta = V3(torch.tensor([1 / 16]), torch.tensor([0.0]), torch.tensor([0.0]))
    hit, k = tm.march_volume(_t(vol), o, p0, delta, 32, torch.tensor([True]))
    jhit, jk = jm.march_volume(jnp.asarray(vol), jo, JV3(*(jnp.asarray(c.numpy()) for c in p0)),
                               JV3(*(jnp.asarray(c.numpy()) for c in delta)), 32,
                               jnp.asarray([True]))
    assert bool(hit[0]) and int(k[0]) == 10  # x = 10/16 * 8 = 5
    assert bool(jhit[0]) == bool(hit[0]) and int(jk[0]) == int(k[0])


def test_saturating_casts():
    """voxel_coord and the object id truncate with XLA's saturating convert
    (NaN -> 0); torch's own cast gives INT_MIN for both."""
    o, jo = render_options(vres=[64, 64, 64]), j_render_options(vres=[64, 64, 64])
    x = np.array([np.nan, 1e10, -1e10, 0.5, -0.01, 3e38], np.float32)
    got = tm.voxel_coord(o, V3(_t(x), _t(x[::-1]), _t(x)))
    want = jm.voxel_coord(jo, JV3(jnp.asarray(x), jnp.asarray(x[::-1]), jnp.asarray(x)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a ray far below the ground: its "material" is its own distance
    # (renderer.cl:211), far outside the int32 range
    p = V3(torch.tensor([0.0]), torch.tensor([-3e9]), torch.tensor([0.0]))
    d = V3(torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([0.0]))
    vol = np.zeros(64**3, np.uint8)
    isec = tm.raymarch(_t(vol), o, p, d, 30.0, 4, torch.tensor([True]), want_normal=False)
    jisec = jm.raymarch(jnp.asarray(vol), jo, JV3(*(jnp.asarray(c.numpy()) for c in p)),
                        JV3(*(jnp.asarray(c.numpy()) for c in d)), 30.0, 4, smooth=False,
                        active=jnp.asarray([True]), want_normal=False)
    assert int(isec["object_id"][0]) == int(jisec["object_id"][0]) == -(2**31)
