"""The port's multi-device paths (raymarchcl_tpu_torch/parallel/tiling.py) on
the CPU: meshes that name the CPU several times, so each shard runs the
plain version of K2 over its pixel range in turn.

A tiled render must equal the port's single-device render bit for bit
(pixel ids drive every seed), the spp-sharded and 2-D renders must agree
with it to float32 reassociation (tests/test_parallel.py's tolerance), and
the port's tiled and spp-sharded renders, and its plain pixel-range pass,
must agree with the JAX package's on the 8-device CPU mesh at the port's
parity tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.models import generators as j_generators
from raymarchcl_tpu.ops import render as j_render
from raymarchcl_tpu.ops import sampling as j_sampling
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu.parallel import tiling as j_tiling
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel, render, sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.parallel import tiling

torch.set_num_threads(1)

VRES = [32, 32, 96]
BUDGETS = dict(maxIter=32, maxVoxelIter=64, shadowIter=32)
CAM = dict(eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
PARITY = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51
MIN_OK = 0.995


def _opts(width=40, height=24, iter=2, vres=VRES, **kw):
    return render_options(width=width, height=height, vres=vres, iter=iter, mat="ao",
                          **BUDGETS, **CAM, **kw)


def _cpus(n):
    return tiling.make_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def scene():
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": VRES}))
    return vol, _opts(), sampling.make_mc_tables(2, seed=9)


def test_meshes():
    m = tiling.make_mesh(["cpu"] * 8, n=4)
    assert m.size == 4 and m.shape == {"tiles": 4} and m.home == torch.device("cpu")
    m2 = tiling.make_mesh2d(2, 4, ["cpu"] * 8)
    assert m2.shape == {"passes": 2, "tiles": 4} and m2.local_entries() == list(range(8))
    with pytest.raises(ValueError):
        tiling.make_mesh2d(4, 4, ["cpu"] * 8)


def test_default_mesh_needs_a_card(monkeypatch):
    """The default devices are the CUDA cards; without one the paths raise
    instead of rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiling.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiling.make_mesh2d(2, 2)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_tiled_equals_single_device(scene, n_dev):
    vol, opts, tables = scene
    argb_1, accum_1 = render.render_image(vol, opts, tables)
    argb_t, accum_t = tiling.render_image_tiled(vol, opts, tables, mesh=_cpus(n_dev))
    assert argb_t.dtype == np.uint32 and argb_t.shape == (24, 40)
    np.testing.assert_array_equal(argb_t, argb_1)  # bit for bit
    assert torch.equal(accum_t, accum_1)  # 960 px: no padding at 2 or 8 tiles


def test_tiled_padding_odd_pixel_count(scene):
    vol, _, tables = scene
    opts = _opts(width=41, height=23, iter=1)  # 943 px, not divisible by 8
    argb_1, accum_1 = render.render_image(vol, opts, tables[:1])
    argb_t, accum_t = tiling.render_image_tiled(vol, opts, tables[:1], mesh=_cpus(8))
    np.testing.assert_array_equal(argb_t, argb_1)
    assert accum_t.shape == (944, 3)
    assert torch.equal(accum_t[:943], accum_1)
    assert torch.equal(accum_t[943], accum_1[942])  # the pad row renders pixel N-1


def test_tiled_with_accel_bit_equal(scene):
    vol, opts, tables = scene
    bricks = accel.build_accel(vol, opts.voxelRes, opts.isoVal)
    argb_1, _ = render.render_image(vol, opts, tables)
    argb_t, _ = tiling.render_image_tiled(vol, opts, tables, mesh=_cpus(8), accel=bricks)
    np.testing.assert_array_equal(argb_t, argb_1)


def test_tiled_progressive_accum(scene):
    """Feeding the tiled accum back refines like the single-device path."""
    vol, opts, tables = scene
    mesh = _cpus(8)
    _, accum = tiling.render_image_tiled(vol, opts, tables[:1], mesh=mesh)
    argb_b, accum_b = tiling.render_image_tiled(vol, opts, tables[1:], times=[0.333],
                                                accum=accum, mesh=mesh)
    assert accum_b.data_ptr() == accum.data_ptr()  # refined in place on the home device
    _, accum_1 = render.render_image(vol, opts, tables[:1])
    argb_1, accum_1 = render.render_image(vol, opts, tables[1:], times=[0.333],
                                          accum=accum_1)
    np.testing.assert_array_equal(argb_b, argb_1)
    assert torch.equal(accum_b, accum_1)
    with pytest.raises(ValueError, match="accum"):
        tiling.render_image_tiled(vol, opts, tables, accum=accum[:-8], mesh=mesh)


def test_tiled_stages_every_band_before_any_launch(scene, monkeypatch):
    """Every band's replicas and accum and image tiles are taken before the
    first band launches (on cards, a copy made after a launch queues
    behind that band's kernel on the home card's stream), and the frame
    stays the single-device render's."""
    vol, _, tables = scene
    opts, tables = _opts(width=8, height=4, iter=1), tables[:1]
    argb_1, accum_1 = render.render_image(vol, opts, tables)
    mesh = _cpus(4)
    blk = opts.num_pixels // mesh.size
    events = []
    real_on, real_to = tiling._Replicas.on, torch.Tensor.to
    real_passes = tiling.render_mod.render_passes

    def on(self, dev):
        events.append("replicas")
        return real_on(self, dev)

    def to(self, *args, **kwargs):
        if self.dim() and self.shape[0] == blk and args and isinstance(args[0], torch.device):
            events.append("tile")
        return real_to(self, *args, **kwargs)

    def render_passes(*args, **kwargs):
        events.append("launch")
        return real_passes(*args, **kwargs)

    monkeypatch.setattr(tiling._Replicas, "on", on)
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(tiling.render_mod, "render_passes", render_passes)
    argb_t, accum_t = tiling.render_image_tiled(vol, opts, tables, mesh=mesh)
    staged = events[:events.index("launch")]
    assert staged.count("replicas") == mesh.size and staged.count("tile") == 2 * mesh.size
    assert events.count("launch") == mesh.size
    np.testing.assert_array_equal(argb_t, argb_1)
    assert torch.equal(accum_t, accum_1)  # 32 px: no padding at 4 tiles


def _strip_cost(profile, strips):
    """A strip cost that grows down the frame, as the ground near the camera
    does: a ramp, a step, or a ramp with a bump in the middle."""
    x = (np.arange(strips) + 0.5) / strips
    return {"ramp": 1 + 3 * x, "step": np.where(x > 0.6, 5.0, 1.0),
            "bump": 0.4 + 1.2 * x ** 2 + 0.6 * np.exp(-((x - 0.5) / 0.15) ** 2)}[profile]


@pytest.mark.parametrize("profile", ["ramp", "step", "bump"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_bands_take_equal_time(n, profile):
    """Fed the device ms its bands took (each strip's cost plus a launch's
    fixed 10 ms), the split of a 1024x1022 frame (256 strips, the last one
    clipped) comes within 5% of equal times in 12 frames, and stays there.
    Every split starts at 0, ends at n_pad = n * ceil(N / n), cuts on strip
    edges after the first frame, and never leaves a band empty."""
    w, h = 1024, 1022
    bands = tiling._Bands(n, w, h)
    cost = np.concatenate([[0.0], np.cumsum(_strip_cost(profile, bands.strips))])
    n_pad = -(-w * h // n) * n
    assert bands.offsets() == [t * (n_pad // n) for t in range(n + 1)]
    imbalance = []
    for _ in range(16):
        off = bands.offsets()
        assert off[0] == 0 and off[-1] == n_pad and all(np.diff(off) > 0)
        spent = np.interp(np.minimum(off, w * h) / (4 * w), np.arange(bands.strips + 1), cost)
        ms = np.diff(spent) + 10.0
        bands.record(off, ms)
        imbalance.append(ms.max() / ms.mean())
    assert all(o % (4 * w) == 0 for o in bands.offsets()[:-1])
    assert imbalance[0] > 1.1 and max(imbalance[12:]) < 1.05


def test_bands_that_took_equal_times_stay():
    """The first frame's times are dropped (one-time costs, however
    skewed); after it unequal times move the cuts and equal times leave
    them."""
    bands = tiling._Bands(4, 64, 64)
    equal = [0, 1024, 2048, 3072, 4096]
    bands.record(equal, [900.0, 3.0, 2.0, 2.0])
    assert bands.offsets() == equal and bands.cost is None
    bands.record(equal, [1.0, 3.0, 2.0, 2.0])
    off = bands.offsets()
    assert off != equal and off[-1] == 4096
    bands.record(off, [5.0] * 4)
    assert bands.offsets() == off


@pytest.mark.parametrize("size", [(40, 24), (41, 23)], ids=["40x24", "41x23"])
@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_tiled_unequal_bands_bit_equal(scene, monkeypatch, n_dev, size):
    """Bands cut from a strip cost (as on cards, from the times of the frames
    before): one launch each over its own pixel range, together every row
    of the (n_pad, 3) accum once, and the frame, and a second frame fed the
    accum back over other bands, bit-equal to the single-device render (pad
    rows holding pixel N-1)."""
    vol, _, tables = scene
    w, h = size
    opts = _opts(width=w, height=h, iter=1)
    _, acc_1 = render.render_image(vol, opts, tables[:1])
    argb_1, acc_1 = render.render_image(vol, opts, tables[1:], times=[0.333], accum=acc_1)
    bands = tiling._Bands(n_dev, w, h)
    monkeypatch.setattr(tiling, "_bands", lambda mesh, w, h: bands)
    launches, real_passes = [], tiling.render_mod.render_passes

    def render_passes(*args, pix_lo, pix_count):
        launches.append((pix_lo, pix_lo + pix_count))
        return real_passes(*args, pix_lo=pix_lo, pix_count=pix_count)

    monkeypatch.setattr(tiling.render_mod, "render_passes", render_passes)
    mesh = _cpus(n_dev)
    bands.cost = _strip_cost("step", bands.strips)
    off_a = bands.offsets()
    _, acc_t = tiling.render_image_tiled(vol, opts, tables[:1], mesh=mesh)
    bands.cost = _strip_cost("ramp", bands.strips)[::-1].copy()
    off_b = bands.offsets()
    argb_t, acc_t = tiling.render_image_tiled(vol, opts, tables[1:], times=[0.333],
                                              accum=acc_t, mesh=mesh)
    assert off_a != off_b
    assert launches == list(zip(off_a, off_a[1:])) + list(zip(off_b, off_b[1:]))
    np.testing.assert_array_equal(argb_t, argb_1)
    n, n_pad = opts.num_pixels, off_a[-1]
    assert acc_t.shape == (n_pad, 3) and n_pad == -(-n // n_dev) * n_dev
    assert torch.equal(acc_t[:n], acc_1)
    assert torch.equal(acc_t[n:], acc_1[n - 1:].expand(n_pad - n, 3))


def test_cpu_meshes_keep_equal_bands(scene):
    """Without device times (CPU entries) no frame is recorded: the bands
    stay equal, call after call."""
    vol, opts, tables = scene
    mesh = _cpus(4)
    for _ in range(2):
        tiling.render_image_tiled(vol, opts, tables[:1], mesh=mesh)
    assert tiling._bands(mesh, 40, 24).cost is None
    assert tiling._bands(mesh, 40, 24).offsets() == [0, 240, 480, 720, 960]


@pytest.fixture(scope="module")
def scene8(scene):
    vol, _, _ = scene
    opts = _opts(iter=8)
    tables = sampling.make_mc_tables(8, seed=9)
    argb_1, accum_1 = render.render_image(vol, opts, tables)
    return vol, opts, tables, argb_1, accum_1


@pytest.mark.parametrize("carry", [False, True])
def test_spp_sharded_matches_sequential(scene8, carry):
    """8 shards render disjoint pass ranges from zero and sum the
    re-weighted blends: the sequential blend up to float32 reassociation;
    with an accum carried in, its (1-fb)^n term too."""
    vol, opts, tables, argb_1, accum_1 = scene8
    accum0 = None
    if carry:
        accum0 = accum_1.clone()
        argb_1, accum_1 = render.render_image(vol, opts, tables, accum=accum_1.clone())
    argb_s, accum_s = tiling.render_image_spp_sharded(vol, opts, tables, accum=accum0,
                                                      mesh=_cpus(8))
    np.testing.assert_allclose(accum_s.numpy(), accum_1.numpy(), rtol=2e-5, atol=1e-6)
    assert (argb_s != argb_1).mean() < 0.01  # packed bytes flip only at quantization edges


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_2d_mesh_matches_sequential(scene8, shape):
    vol, opts, tables, argb_1, accum_1 = scene8
    argb_2, accum_2 = tiling.render_image_2d(vol, opts, tables,
                                             mesh=tiling.make_mesh2d(*shape, ["cpu"] * 8))
    np.testing.assert_allclose(accum_2[: opts.num_pixels].numpy(), accum_1.numpy(),
                               rtol=2e-5, atol=1e-6)
    assert (argb_2 != argb_1).mean() < 0.01


def test_pass_sharding_rejects_indivisible(scene):
    vol, opts, _ = scene
    tables3 = sampling.make_mc_tables(3, seed=1)
    with pytest.raises(ValueError, match="divisible"):
        tiling.render_image_spp_sharded(vol, opts, tables3, mesh=_cpus(8))
    with pytest.raises(ValueError, match="divisible"):
        tiling.render_image_2d(vol, opts, tables3, mesh=tiling.make_mesh2d(2, 2, ["cpu"] * 4))


def test_pixel_range_checks(scene):
    vol, opts, tables = scene
    with pytest.raises(ValueError, match="accum"):
        k2.render_passes(vol, opts, tables, [0.0, 0.333], torch.zeros((opts.num_pixels, 3)),
                         pix_lo=10, pix_count=20)
    with pytest.raises(ValueError, match="argb"):
        k2.render_passes(vol, opts, tables, [0.0, 0.333], torch.zeros((20, 3)),
                         argb=torch.zeros(21, dtype=torch.int32), pix_lo=10, pix_count=20)
    with pytest.raises(ValueError, match="out of bounds"):
        k2.render_passes(vol, opts, tables, [0.0, 0.333], torch.zeros((20, 3)), pix_lo=-1,
                         pix_count=20)
    assert k2.pixel_range(opts, 900) == (900, 60)  # default: to the frame's end


# --- against the JAX package ---------------------------------------------

SMALL = dict(width=24, height=16, vres=[16, 16, 16], maxIter=12, maxVoxelIter=24, shadowIter=12,
             mat="ao", **CAM)


def _small(n_passes):
    kw = dict(SMALL, iter=n_passes)
    vol = j_generators.make_gyroid_volume({"vres": kw["vres"]})
    tables = np.asarray(j_sampling.make_mc_tables(n_passes, seed=5))
    return vol, tables, j_render_options(**kw), render_options(**kw)


def _parity(got, want):
    ok = np.isclose(got, want, **PARITY).all(axis=1)
    assert ok.mean() >= MIN_OK, f"{(~ok).sum()}/{ok.size} pixels diverged"


def test_tiled_matches_jax_8_device_mesh():
    assert len(jax.devices()) == 8
    vol, tables, jo, opts = _small(2)
    j_argb, j_acc = j_tiling.render_image_tiled(jnp.asarray(vol), jo, jnp.asarray(tables),
                                                mesh=j_tiling.make_mesh())
    argb, acc = tiling.render_image_tiled(volume_from_numpy(vol), opts,
                                          tables_from_numpy(tables), mesh=_cpus(8))
    assert argb.shape == np.asarray(j_argb).shape and acc.shape == np.asarray(j_acc).shape
    _parity(acc.numpy(), np.asarray(j_acc))
    assert len(np.unique(argb)) > 16  # a real image


def test_spp_sharded_matches_jax_8_device_mesh():
    vol, tables, jo, opts = _small(8)
    _, j_acc = j_tiling.render_image_spp_sharded(jnp.asarray(vol), jo, jnp.asarray(tables),
                                                 mesh=j_tiling.make_mesh())
    _, acc = tiling.render_image_spp_sharded(volume_from_numpy(vol), opts,
                                             tables_from_numpy(tables), mesh=_cpus(8))
    _parity(acc.numpy(), np.asarray(j_acc))


def test_pixel_range_plain_matches_jax_ids():
    """The plain version over a ragged range (from mid-row, past the last
    pixel) against the JAX package's render_accum over the same global
    ids, min(lo + i, N - 1)."""
    vol, tables, jo, opts = _small(2)
    n, lo, count = opts.num_pixels, 350, 50  # 34 frame pixels from x=14, 16 pad rows
    ids = np.minimum(np.arange(lo, lo + count), n - 1).astype(np.int32)
    times = np.arange(2, dtype=np.float32) * np.float32(0.333)
    want = np.asarray(j_render.render_accum(jnp.asarray(vol).reshape(-1), jo,
                                            jnp.asarray(tables), jnp.asarray(times),
                                            jnp.zeros((count, 3), jnp.float32),
                                            jnp.asarray(ids)))
    got = k2.render_passes(volume_from_numpy(vol), opts, tables_from_numpy(tables),
                           torch.from_numpy(times), torch.zeros((count, 3)), pix_lo=lo,
                           pix_count=count)
    _parity(got.numpy(), want)
    assert torch.equal(got[34:], got[33:34].expand(16, 3))  # pad rows: pixel N-1 again
