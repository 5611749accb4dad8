"""MC tables, seeds, jitter state and camera rays of the PyTorch port
against the JAX package. Includes the cast and uint32 hazards: XLA's
float->int32 convert saturates and maps NaN to 0 where torch's own cast
gives INT_MIN, and torch has no uint32 add/shift on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import camera_ray_lookat as j_camera
from raymarchcl_tpu.ops.camera import compute_eyepos as j_eyepos
from raymarchcl_tpu.ops.vecmath import V3 as JV3
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.ops import sampling as ts
from raymarchcl_tpu_torch.ops.camera import camera_ray_lookat, compute_eyepos
from raymarchcl_tpu_torch.ops.vecmath import V3, f2i_sat
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

HAZARDS = [-1.5, 0.0, 2.5e9, -2.5e9, np.nan, 3e38, -3e38, np.inf, -np.inf, 0.999, -0.999]


@pytest.mark.parametrize("seed", [0, 7])
def test_mc_tables_bit_equal(seed):
    got = ts.make_mc_tables(2, seed=seed).numpy()
    want = np.asarray(js.make_mc_tables(2, seed=seed))
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 0x4000, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_pieces_equal_jax():
    key = jax.random.PRNGKey(123)
    np.testing.assert_array_equal(ts.prng_key(123), np.asarray(key))
    np.testing.assert_array_equal(ts.split(ts.prng_key(123), 5),
                                  np.asarray(jax.random.split(key, 5)))
    np.testing.assert_array_equal(
        ts.uniform(ts.prng_key(123), (7, 3)),
        np.asarray(jax.random.uniform(key, (7, 3), jnp.float32, -1.0, 1.0)))
    with pytest.raises(ValueError):
        ts.prng_key(2**31)


def test_f2u32_matches_jax_on_hazards():
    x = np.asarray(HAZARDS, np.float32)
    got = ts.f2u32(torch.from_numpy(x)).numpy()
    want = np.asarray(js.f2u32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    # the values the hazard is about: saturation and NaN -> 0
    np.testing.assert_array_equal(f2i_sat(torch.tensor([2.5e9, np.nan, -2.5e9])).numpy(),
                                  [2**31 - 1, 0, -(2**31)])


def test_uint32_seed_arithmetic_wraps():
    """Seed adds run in int64 masked to 32 bits; they must wrap like uint32."""
    base = np.array([0, 1, 2**32 - 1, 2**32 - 37, 2**31], np.uint32)
    for add in (37, 37 * 6, 2**31 + 5):
        want = base + np.uint32(add)
        got = (torch.from_numpy(base.astype(np.int64)) + add) & ts.U32_MASK
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(ts.table_index(torch.tensor(2**32 - 1))) == 0x3FFF


def _state_and_rays(t, dof, w=16, h=12):
    eye = [float(v) for v in j_eyepos(135.0, 2.25, 0.35)]
    kw = dict(width=w, height=h, vres=[32, 32, 96], t=t, dof=dof, mat="ao",
              eyepos=eye, targetpos=[0, -0.4, 0])
    table = np.array(js.generate_scatter_offsets(seed=3))
    jo = j_render_options(**kw)

    @jax.jit
    def jfn(opts, table_t, ids):
        st = js.init_render_state(opts, table_t, ids)
        pos, d = j_camera(opts, st)
        return st["px"], st["py"], st["mc_normal"], pos, d

    jout = jfn(jo, js.transpose_table(jnp.asarray(table)), jnp.arange(w * h, dtype=jnp.int32))
    to = render_options(**kw)
    st = ts.init_render_state(to, torch.from_numpy(table), torch.arange(w * h))
    pos, d = camera_ray_lookat(to, st)
    return jout, (st["px"], st["py"], st["mc_normal"], pos, d), jo, to, table


@pytest.mark.parametrize("t,dof", [(0.0, 0.001), (0.666, 0.05), (-0.7, 0.001)])
def test_jitter_and_camera_rays(t, dof):
    (jpx, jpy, jmc, jpos, jd), (px, py, mc, pos, d), _, _, _ = _state_and_rays(t, dof)
    # px/py are pixel + table[seed] bits: exact iff the seeds are exact
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    for a, b in zip((*mc, *pos, *d), (*jmc, *jpos, *jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_light_and_ao_seeds_exact():
    """The seed sites (renderer.cl:267, :334) truncate float sums, so they
    follow XLA:CPU's FMA contraction of the jitted program exactly."""
    rng = np.random.default_rng(1)
    px = rng.uniform(0, 512, 4096).astype(np.float32)
    py = rng.uniform(0, 512, 4096).astype(np.float32)
    p3 = rng.uniform(-2, 2, (3, 4096)).astype(np.float32)
    for t in (0.0, 0.333, 4.995):
        jo = j_render_options(width=8, height=8, vres=8, t=t)
        to = render_options(width=8, height=8, vres=8, t=t)
        want_l = jax.jit(js.light_seed)(jo, jnp.asarray(px), jnp.asarray(py))
        got_l = ts.light_seed(to, torch.from_numpy(px), torch.from_numpy(py))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l).astype(np.int64))
        want_a = jax.jit(lambda o, x, y, z: js.ao_seed(o, JV3(x, y, z)))(jo, *p3)
        got_a = ts.ao_seed(to, V3(*(torch.from_numpy(c) for c in p3)))
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a).astype(np.int64))


def test_rand_lookup_and_eyepos():
    table = ts.make_mc_tables(1, seed=0)[0]
    x, y, z, w = ts.rand_float4(table, torch.tensor([5, 0x4000 + 5]))
    assert torch.equal(x, table[[5, 5], 0]) and torch.equal(w, table[[5, 5], 3])
    np.testing.assert_array_equal(compute_eyepos(135, 2.25, 0.35), j_eyepos(135, 2.25, 0.35))
