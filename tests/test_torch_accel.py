"""The brick table of the PyTorch port (ops/accel.py) against the JAX
package's `build_accel`, and the port's march over it against its own raw
march (bit for bit) and against the JAX package's brick march."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import accel as j_accel
from raymarchcl_tpu.ops import march as jm
from raymarchcl_tpu.ops import render as j_render
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops import shade as jsh
from raymarchcl_tpu.ops.camera import camera_ray_lookat as j_camera
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu.ops.vecmath import V3 as JV3
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.convert import accel_from_numpy, tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.ops import accel as t_accel
from raymarchcl_tpu_torch.ops import march as tm
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.ops import shade as tsh
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.vecmath import V3, dot, normalize
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

VRES = [32, 32, 96]
W, H = 32, 24
N = W * H
# the reduced budgets of tests/test_accel.py's scene
BUDGETS = dict(maxIter=32, maxVoxelIter=64, shadowIter=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tv(v):
    return V3(*(_t(c) for c in v))


def _jv(v):
    return JV3(*(jnp.asarray(c.numpy()) for c in v))


def _jax_rows(vol, res, iso, edge):
    """The JAX package's rows at brick edge `edge` (its edge is a module
    setting, restored afterwards)."""
    old = j_accel.BRICK
    try:
        j_accel.set_brick(edge)
        return np.asarray(j_accel.build_accel(vol, res, iso).rows)
    finally:
        j_accel.set_brick(old)


@pytest.fixture(scope="module")
def scene():
    vol = generators.make_gyroid_volume({"vres": VRES})
    kw = dict(width=W, height=H, vres=VRES, iter=1, mat="ao",
              eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0], **BUDGETS)
    jo, to = j_render_options(**kw), render_options(**kw)
    jacc = j_accel.build_accel(vol, jo.voxelRes, jo.isoVal)
    # the port marches over the JAX package's own table
    tacc = accel_from_numpy(np.asarray(jacc.rows), jacc.edge)
    return dict(vol=vol, kw=kw, jo=jo, to=to, jacc=jacc, tacc=tacc)


def _random_volume():
    rng = np.random.default_rng(3)
    res = (12, 9, 21)  # (rx, ry, rz): no brick multiple (tests/test_accel.py:137-147)
    return (rng.random(res[2] * res[1] * res[0]) * 255).astype(np.uint8), res


@pytest.mark.parametrize("case", ["gyroid-e4", "gyroid-e8", "gyroid-e16", "random-12x9x21-e8"])
def test_build_accel_rows_equal_jax(case):
    name, edge = case.rsplit("-e", 1)
    edge = int(edge)
    if name == "gyroid":
        vol, res, iso = generators.make_gyroid_volume({"vres": VRES}), VRES, 32
    else:
        (vol, res), iso = _random_volume(), 32
    want = _jax_rows(vol, res, iso, edge)
    acc = t_accel.build_accel(vol, res, iso, edge)
    assert acc.edge == edge and acc.rows.dtype == torch.int32
    assert acc.rows.shape == (np.prod(t_accel.brick_dims(res, edge)), edge**3 // 32 + 2)
    np.testing.assert_array_equal(acc.rows.numpy().view(np.uint32), want)
    # the same from a tensor volume, and carried over from the JAX rows
    again = t_accel.build_accel(volume_from_numpy(vol), res, iso, edge)
    assert torch.equal(again.rows, acc.rows)
    assert torch.equal(accel_from_numpy(want, edge).rows, acc.rows)
    # no brick's distance exceeds its distance to the brick grid's boundary
    nbx, nby, nbz = t_accel.brick_dims(res, edge)
    z, y, x = np.meshgrid(np.arange(nbz), np.arange(nby), np.arange(nbx), indexing="ij")
    bound = np.minimum.reduce([z + 1, nbz - z, y + 1, nby - y, x + 1, nbx - x])
    assert (acc.rows[:, acc.dist_w].numpy().reshape(nbz, nby, nbx) <= bound).all()


def test_chebyshev_and_checks():
    rng = np.random.default_rng(7)
    for shape, dens in (((6, 7, 8), 0.04), ((12, 5, 9), 0.0), ((3, 4, 5), 0.5)):
        mask = rng.random(shape) < dens
        got = t_accel.chebyshev_from_mask(mask)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, j_accel.chebyshev_from_mask(mask))
    with pytest.raises(ValueError, match="edge"):
        t_accel.brick_dims(VRES, 6)
    with pytest.raises(ValueError, match="rows"):
        accel_from_numpy(np.zeros((4, 17), np.uint32), 8)
    with pytest.raises(ValueError, match="edge"):
        accel_from_numpy(np.zeros((4, 18), np.uint32), 6)


def test_march_volume_brick_equal_raw_and_jax(scene):
    """hit and hit_k of the brick march, with the static and per-ray caps
    (tests/test_accel.py:283-311): bit-equal to the port's raw march at
    edges 4, 8 and 16, and to the JAX brick march."""
    vol, to, jo = scene["vol"], scene["to"], scene["jo"]
    rng = np.random.default_rng(11)
    n = 512
    p0 = rng.uniform(-0.4, 1.4, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    delta = (d * (2.0 / to.maxVoxelIter) * 0.5).astype(np.float32)
    mkd = rng.integers(0, to.maxVoxelIter + 1, n, dtype=np.int32)
    tp0, tdelta, act = _tv(p0), _tv(delta), torch.ones(n, dtype=torch.bool)
    accs = [scene["tacc"]] + [t_accel.build_accel(vol, VRES, to.isoVal, e) for e in (4, 16)]
    steps = to.maxVoxelIter
    for kw in ({}, {"max_k": 7}, {"max_k": 0}, {"max_k_dyn": mkd}, {"max_k": 13, "max_k_dyn": mkd}):
        tkw = {k: (_t(v) if k == "max_k_dyn" else v) for k, v in kw.items()}
        raw = tm.march_volume(_t(vol), to, tp0, tdelta, steps, act, **tkw)
        for acc in accs:
            got = tm.march_volume(_t(vol), to, tp0, tdelta, steps, act, accel=acc, **tkw)
            assert torch.equal(got[0], raw[0]) and torch.equal(got[1], raw[1]), (acc.edge, kw)
        jkw = {k: (jnp.asarray(v) if k == "max_k_dyn" else v) for k, v in kw.items()}
        jh, jk = jm.march_volume(jnp.asarray(vol), jo, JV3(*map(jnp.asarray, p0)),
                                 JV3(*map(jnp.asarray, delta)), steps, jnp.ones(n, bool),
                                 accel=scene["jacc"], **jkw)
        np.testing.assert_array_equal(raw[0].numpy(), np.asarray(jh))
        np.testing.assert_array_equal(raw[1].numpy(), np.asarray(jk))
    assert 0 < int(raw[0].sum()) < n  # hits and misses present


def test_march_skips_free_space():
    """An empty volume: bricks far from the boundary skip, and a ray across
    the middle reads far fewer samples than the raw march, with the same
    result (no hit: it leaves the grid)."""
    vres = [64, 64, 64]
    o = render_options(vres=vres)
    vol = torch.zeros(64**3, dtype=torch.uint8)
    acc = t_accel.build_accel(vol, vres, o.isoVal)
    assert int(acc.rows[:, acc.dist_w].max()) == 4  # the centre bricks
    p0 = V3(torch.tensor([0.01]), torch.tensor([0.5]), torch.tensor([0.5]))
    delta = V3(torch.tensor([1 / 128]), torch.tensor([0.0]), torch.tensor([0.0]))
    act = torch.tensor([True])
    tm.SAMPLES = 0
    raw = tm.march_volume(vol, o, p0, delta, 192, act)
    n_raw, tm.SAMPLES = tm.SAMPLES, 0
    got = tm.march_volume(vol, o, p0, delta, 192, act, accel=acc)
    assert torch.equal(got[0], raw[0]) and torch.equal(got[1], raw[1])
    assert not bool(raw[0][0]) and int(raw[1][0]) == 127  # x = 127/128 leaves at 128
    assert n_raw == 128 and tm.SAMPLES < 64, (n_raw, tm.SAMPLES)
    # a ray that never moves, in a centre brick: inv_vps 1e30 skips past the
    # budget at once
    centre = V3(torch.tensor([0.5]), torch.tensor([0.5]), torch.tensor([0.5]))
    still = V3(torch.tensor([0.0]), torch.tensor([0.0]), torch.tensor([0.0]))
    tm.SAMPLES = 0
    got = tm.march_volume(vol, o, centre, still, 192, act, accel=acc)
    assert tm.SAMPLES == 1
    raw = tm.march_volume(vol, o, centre, still, 192, act)
    assert torch.equal(got[0], raw[0]) and torch.equal(got[1], raw[1])


@pytest.fixture(scope="module")
def primary(scene):
    """Camera rays of a 32x24 frame marched by both packages with the brick
    table, and by the port without it."""
    jo, to, vol = scene["jo"], scene["to"], scene["vol"]
    table = np.array(js.generate_scatter_offsets(seed=3))

    @jax.jit
    def jfn(o, vol, table_t, acc):
        st = js.init_render_state(o, table_t, jnp.arange(N, dtype=jnp.int32))
        p, d = j_camera(o, st)
        i = jm.raymarch(vol, o, p, d, o.maxDist, o.maxIter, smooth=True,
                        active=jnp.ones(N, bool), accel=acc)
        return p, d, i["object_id"], i["distance"]

    jp, jd, jid, jdist = jfn(jo, jnp.asarray(vol), js.transpose_table(jnp.asarray(table)),
                             scene["jacc"])
    p, d = _tv(jp), _tv(jd)
    act = torch.ones(N, dtype=torch.bool)
    raw = tm.raymarch(_t(vol), to, p, d, to.maxDist, to.maxIter, act)
    brick = tm.raymarch(_t(vol), to, p, d, to.maxDist, to.maxIter, act, accel=scene["tacc"])
    return dict(raw=raw, brick=brick, p=p, d=d, jid=np.asarray(jid), jdist=np.asarray(jdist))


def test_raymarch_brick_equal_raw_and_jax(primary):
    raw, brick = primary["raw"], primary["brick"]
    for k in ("distance", "object_id"):
        assert torch.equal(brick[k], raw[k]), k
    for a, b in zip((*brick["pos"], *brick["normal"]), (*raw["pos"], *raw["normal"])):
        assert torch.equal(a, b)
    # against the JAX brick march: ids and hits exact, distances to the
    # tolerance of tests/test_torch_march.py (1/sqrt vs XLA's rsqrt moves
    # ray directions by an ulp)
    np.testing.assert_array_equal(brick["object_id"].numpy(), primary["jid"])
    dist = brick["distance"].numpy()
    np.testing.assert_array_equal(dist < 30, primary["jdist"] < 30)
    np.testing.assert_allclose(dist, primary["jdist"], rtol=1e-6, atol=1e-6)
    assert 0.2 < (dist < 30).mean() < 1


def test_shadow_brick_exact(scene, primary):
    """Shadow rays toward the light over the brick table: the 0/1 factor
    equals the port's raw march and the JAX brick march."""
    jo, to, vol, isec = scene["jo"], scene["to"], scene["vol"], primary["brick"]
    hit = isec["distance"] < 30
    lp = V3(*(torch.full((N,), float(v)) for v in to.lightPos[0, :3]))
    delta = lp - isec["pos"]
    ldir = normalize(delta)
    lmax = torch.minimum(torch.sqrt(dot(delta, delta)) - to.shadowBias, to.maxDist)
    origin = V3(*(c + dc * 0.1 for c, dc in zip(isec["pos"], ldir)))
    got = tsh.shadow(_t(vol), to, origin, ldir, lmax, hit, accel=scene["tacc"])
    assert torch.equal(got, tsh.shadow(_t(vol), to, origin, ldir, lmax, hit))
    want = jax.jit(lambda o, v, org, ld, lm, a, acc: jsh.shadow(v, o, org, ld, lm, a, accel=acc))(
        jo, jnp.asarray(vol), _jv(origin), _jv(ldir), jnp.asarray(lmax.numpy()),
        jnp.asarray(hit.numpy()), scene["jacc"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got[hit].mean()) < 1


def test_render_pass_and_image_with_accel(scene):
    """One pass of K2's plain version with the brick table is bit-equal to
    the pass without it; the frame through render_image agrees with the JAX
    package's render_image(accel=...) within the parity tolerance
    (tests/test_parity.py:51)."""
    to, vol = scene["to"], volume_from_numpy(scene["vol"])
    tables = np.asarray(js.make_mc_tables(1, seed=3))
    table = tables_from_numpy(tables)
    zero = torch.zeros((to.num_pixels, 3))
    raw = k2.render_pass_plain(vol, to, table[0], zero)
    brick = k2.render_pass_plain(vol, to, table[0], zero, scene["tacc"])
    assert torch.equal(brick, raw)
    argb, acc = t_render.render_image(vol, to, table, accel=scene["tacc"])
    assert torch.equal(acc, raw)  # 1 spp from zero: the pass itself
    _, j_acc = j_render.render_image(jnp.asarray(scene["vol"]), scene["jo"],
                                     jnp.asarray(tables), accel=scene["jacc"])
    ok = np.isclose(acc.numpy(), np.asarray(j_acc), rtol=5e-3, atol=5e-3).all(axis=1)
    assert ok.mean() >= 0.995, f"{(~ok).sum()}/{ok.size} pixels diverged"
    assert len(np.unique(argb)) > 16
