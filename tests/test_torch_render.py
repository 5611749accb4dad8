"""The whole render path of the PyTorch port (K2's plain version, the spp
blend and K1's plain pack) against the JAX package's plain render
(`render_image(accel=None)`, a single band below 8192 pixels, for `ao`;
the reflective presets in test_torch_reflect_frame.py), against the scalar
oracle's cached pixels of every tests/test_parity.py case, and the port's
entry points against the committed goldens of the gyroid and terrain
volumes."""

import os

import numpy as np
import pytest
import torch

import jax_answers
import oracle_cache
import scalar_ref
from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch import api
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.io import imageio
from raymarchcl_tpu_torch.models import generators as t_generators
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.ops import sampling as t_sampling
from raymarchcl_tpu_torch.ops.camera import camera_ray_lookat
from raymarchcl_tpu_torch.ops.kernels.tonemap import tonemap_pack_plain
from raymarchcl_tpu_torch.ops.shade import scene_color
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

VRES = [32, 32, 96]
CASES = {
    # BASELINE config-1 shape at test size (tests/test_parity.py:56-61 budgets)
    "ao-16x12-2spp": dict(width=16, height=12, iter=2,
                          maxIter=48, maxVoxelIter=96, shadowIter=48),
    # the reference's unreduced budgets (core.clj:54-61)
    "ao-16x12-1spp-full": dict(width=16, height=12, iter=1),
}


@pytest.fixture(scope="module")
def vol():
    return generators.make_gyroid_volume({"vres": VRES})


def _rgb_diff(a, b):
    d = np.abs(imageio.argb_to_rgba(a)[..., :3].astype(int)
               - imageio.argb_to_rgba(b)[..., :3].astype(int))
    return d.mean(), (d > 8).mean()


def case_kw(case):
    return dict(vres=VRES, mat="ao", eyepos=compute_eyepos(135, 2.25, 0.35),
                targetpos=[0, -0.4, 0], **CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_image_matches_jax(vol, case):
    kw = case_kw(case)
    tables = np.asarray(js.make_mc_tables(kw["iter"], seed=3))  # one table for both
    ans = jax_answers.load(f"render-frame-{case}", jax_answers.digest(vol, tables, kw))
    j_argb, j_acc = ans["argb"], ans["acc"]
    argb, acc = t_render.render_image(volume_from_numpy(vol), render_options(**kw),
                                      tables_from_numpy(tables))
    assert argb.dtype == np.uint32 and argb.shape == (kw["height"], kw["width"])
    ok = np.isclose(acc.numpy(), j_acc, rtol=5e-3, atol=5e-3).all(axis=1)
    assert ok.mean() >= 0.995, f"{(~ok).sum()}/{ok.size} pixels diverged"
    mad, off8 = _rgb_diff(argb, j_argb)
    assert mad < 0.15 and off8 < 0.005, (mad, off8)
    assert len(np.unique(argb)) > 16  # a real image


REDUCED = dict(maxIter=48, maxVoxelIter=96, shadowIter=48)
# tests/test_parity.py's cases: (w, h, t, option kwargs; `volume` names a
# volume of 32^3 other than the gyroid)
ORACLE_CASES = {
    "ao_preset": (12, 8, 0.0, REDUCED),
    "full_default_budgets": (16, 12, 0.0, {}),
    "anim_camera": (32, 24, 0.3333, dict(fov=115.0, eyepos=compute_eyepos(70.0, 2.25, 0.443),
                                         targetpos=[0, -0.15, 0])),
    "metal_reflections": (8, 6, 0.333, dict(REDUCED, mat="metal")),
    "dof": (10, 8, 0.999, dict(REDUCED, mat="metal", dof=0.025)),
    "metal2_terrain": (10, 8, 0.333, dict(REDUCED, mat="metal2", volume="terrain")),
    "orange_stripes_voxelized_mesh": (10, 8, 0.666, dict(REDUCED, mat="orange-stripes",
                                                         volume="mesh")),
}


def _volume32(kind, monkeypatch):
    """test_parity.py's terrain and voxelized-mesh volumes (the numpy
    voxelizer: the native one is byte-equal, tests/test_native.py)."""
    if kind == "terrain":
        return generators.make_terrain({"vres": [32, 32, 32]})
    from raymarchcl_tpu.models import mesh

    monkeypatch.setattr(mesh, "_native", None)
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, 0], [1, 0, 0], [0, 0, 1]],
                     [[0, 0, 0], [0, 1, 0], [0, 0, 1]], [[1, 0, 0], [0, 1, 0], [0, 0, 1]]],
                    np.float32)
    return mesh.voxelize_ks(tris.reshape(-1, 3), 32, 2)


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_scene_color_matches_scalar_oracle(vol, case, monkeypatch):
    """Whole pixels against the literal transcription of renderer.cl, read
    from the committed oracle cache (never recomputed: every pixel must be
    a cache hit, so the cache file is not rewritten)."""
    w, h, t, extra = ORACLE_CASES[case]
    kw = dict(width=w, height=h, vres=VRES, iter=1, t=t, mat="ao",
              eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    kw.update(extra)
    kind = kw.pop("volume", None)
    if kind is not None:
        vol = _volume32(kind, monkeypatch)
        kw["vres"] = [32, 32, 32]
    table = np.array(js.generate_scatter_offsets(seed=3))
    jo, opts = j_render_options(**kw), render_options(**kw)
    state = t_sampling.init_render_state(opts, torch.from_numpy(table), torch.arange(w * h))
    pos, d = camera_ray_lookat(opts, state)
    got = scene_color(torch.from_numpy(vol), opts, torch.from_numpy(table), state, pos,
                      d).to_array().numpy()
    scene = oracle_cache.CachedScene(scalar_ref.Scene, scalar_ref.opts_to_dict(jo), vol, table)
    bad = 0
    for pid in range(w * h):
        assert f"{scene._base}/{pid}" in oracle_cache._cache, "oracle pixel not cached"
        want = scene.render_pixel(pid) / np.float32(jo.exposure)
        bad += not np.allclose(got[pid], want, rtol=5e-3, atol=5e-3)
    assert bad <= 0.005 * w * h, f"{bad}/{w * h} pixels diverged"


GOLDEN_CASES = {  # tests/test_goldens.py CASES with its BUDGETS, seed 7
    "gyroid-ao": dict(width=64, height=48, iter=2, vres=48),
    "terrain-ao": dict(width=48, height=32, iter=1, vres=40, volume="terrain"),
}
REFLECTIVE_GOLDEN_CASES = {
    "gyroid-metal": dict(width=48, height=32, iter=1, vres=48, mat="metal"),
    "gyroid-orange": dict(width=48, height=32, iter=1, vres=48, mat="orange-stripes",
                          theta=60),
    "gyroid-dof": dict(width=48, height=32, iter=2, vres=48, mat="metal2", dof=0.05),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_ao(name):
    """The `ao` goldens through the port's entry points on the CPU
    (api.test_render; render_frame for a non-gyroid volume)."""
    _check_golden(name, dict(GOLDEN_CASES[name], mat="ao"))


@pytest.mark.parametrize("name", sorted(REFLECTIVE_GOLDEN_CASES))
def test_golden_reflective(name):
    """The goldens of the reflective presets that need no mesh volume,
    through api.test_render on the CPU (`gyroid-dof` is metal2 with depth of
    field)."""
    _check_golden(name, dict(REFLECTIVE_GOLDEN_CASES[name]))


def _check_golden(name, cfg):
    """Render `cfg` at tests/test_goldens.py's budgets and seed and hold it
    to the golden at its thresholds (mad < 0.15, frac_off8 < 0.5%)."""
    cfg.update(maxIter=32, maxVoxelIter=64, shadowIter=32)
    theta = cfg.pop("theta", 135)
    if cfg.pop("volume", None) == "terrain":
        vres = cfg.pop("vres")
        argb, _ = api.render_frame(
            generators.make_terrain({"vres": [vres] * 3}), (vres,) * 3, seed=7, device="cpu",
            eyepos=compute_eyepos(theta, 2.25, 0.35), targetpos=[0, -0.4, 0], **cfg)
    else:
        argb = api.test_render(theta=theta, dist=2.25, out_path=None, seed=7, verbose=False,
                               device="cpu", **cfg)
    from PIL import Image

    path = os.path.join(os.path.dirname(__file__), "goldens", f"{name}.png")
    want = np.asarray(Image.open(path).convert("RGBA")).astype(np.int32)
    got = imageio.argb_to_rgba(argb).astype(np.int32)
    assert got.shape == want.shape
    d = np.abs(got[..., :3] - want[..., :3])
    assert d.mean() < 0.15 and (d > 8).mean() < 0.005, (d.mean(), (d > 8).mean())


def test_entry_points_default_to_cuda(vol, monkeypatch):
    """render_frame and test_render render on the card unless given
    device='cpu': with no card they raise, and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.render_frame(vol, VRES, width=8, height=6, mat="ao")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.test_render(width=8, height=6, vres=8, mat="ao", out_path=None, verbose=False)
    argb, acc = api.render_frame(vol, VRES, width=8, height=6, mat="ao", device="cpu",
                                 maxIter=16, maxVoxelIter=32, shadowIter=16)
    raw, acc_raw = api.render_frame(vol, VRES, width=8, height=6, mat="ao", device="cpu",
                                    accel=False, maxIter=16, maxVoxelIter=32, shadowIter=16)
    assert acc.device.type == "cpu" and torch.equal(acc, acc_raw)
    np.testing.assert_array_equal(argb, raw)


def test_render_image_argb_is_pack_of_accum(vol):
    """render_image's image is K1's plain pack of the frame's final accum,
    also when an accum is passed back in to refine it (core.clj:194-208)."""
    opts = render_options(width=8, height=6, vres=VRES, iter=2, mat="ao",
                          maxIter=32, maxVoxelIter=64, shadowIter=32)
    tables = t_sampling.make_mc_tables(2, seed=5)
    v = volume_from_numpy(vol)
    argb, acc = t_render.render_image(v, opts, tables)
    want = tonemap_pack_plain(acc, opts.gamma).numpy().view(np.uint32).reshape(6, 8)
    np.testing.assert_array_equal(argb, want)
    argb2, acc2 = t_render.render_image(v, opts, tables, accum=acc.clone())
    assert not torch.equal(acc2, acc)
    np.testing.assert_array_equal(
        argb2, tonemap_pack_plain(acc2, opts.gamma).numpy().view(np.uint32).reshape(6, 8))


def test_accumulation_is_sequential_blend(vol):
    """render_accum is the reference's exponentially-weighted blend of
    sequential passes (renderer.cl:492, core.clj:83-90)."""
    opts = render_options(width=8, height=6, vres=VRES, iter=3, mat="ao",
                          maxIter=32, maxVoxelIter=64, shadowIter=32)
    tables = tables_from_numpy(np.asarray(js.make_mc_tables(3, seed=5)))
    times = torch.arange(3, dtype=torch.float32) * t_render.TIME_STEP_INIT
    v = volume_from_numpy(vol)
    got = t_render.render_accum(v, opts, tables, times, torch.zeros((48, 3)))
    acc = torch.zeros((48, 3))
    for i in range(3):
        acc = t_render.render_pass(v, opts.replace(time=times[i]), tables[i], acc)
    assert torch.equal(got, acc)
    assert float(got.abs().sum()) > 0


# Pixel 3531 (x 31, y 35) of the 100x37 `ao` frame, pass 0, over the 256^3
# gyroid: the one pixel whose AO seed one ulp of ray direction flipped. The
# float that sampling.ao_seed truncates lies within 1e-3 of 1356 there.
PIXEL_IDS = [3531, 3530, 3532]


PIXEL_KW = dict(width=100, height=37, iter=1, vres=[256] * 3, mat="ao",
                eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
# the JAX package's compiled answers at PIXEL_IDS (tests/jax_answers.py)
PIXEL_KEYS = ("px", "py", "mc_normal", "dir", "distance", "object_id", "ao_seed", "colour")


def _pixel_case():
    """The 256^3 gyroid (the port's generator: the JAX package's numpy path,
    which its native path leaves at one voxel), pass 0's MC table, and the
    port's options at time 0."""
    vol_np = t_generators.make_gyroid_volume({"vres": PIXEL_KW["vres"]})
    table = np.array(js.make_mc_tables(16, seed=0)[0])
    return vol_np, table, render_options(**PIXEL_KW).replace(time=torch.tensor(0.0))


def _ao_seed_float(pos, t):
    """The float sampling.ao_seed truncates (the port's contraction)."""
    from raymarchcl_tpu_torch.ops.vecmath import fma

    return (fma(pos.z, 2945.87, fma(pos.x, 3183.75, pos.y * 1831.42)) + t * 2671.918).numpy()


def test_pixel_3531_view_coordinates_decide_its_ao_seed():
    """The port's view coordinates follow XLA:CPU's compiled order
    (camera.view_coords), bit-equal to the JAX package's on the whole frame.
    At pixel 3531 the expression as written, px / w * fov - fov / 2, moves
    the ray one ulp and the AO-seed float across 1356; in XLA's order the
    port lands on JAX's side, and its colour is JAX's. The ray directions
    still differ by up to 2 ulp where XLA:CPU's rsqrt estimate differs from
    1/sqrt, which the port does not copy."""
    from raymarchcl_tpu_torch.ops import march as t_march
    from raymarchcl_tpu_torch.ops.camera import view_coords
    from raymarchcl_tpu_torch.ops.vecmath import V3, cross, normalize

    vol_np, table, to = _pixel_case()
    ans = jax_answers.load("render-pixel-3531",
                           jax_answers.digest(vol_np, table, PIXEL_KW, PIXEL_IDS))
    n = to.num_pixels
    st_all = t_sampling.init_render_state(to, torch.from_numpy(table), torch.arange(n))
    got = [x.numpy() for x in view_coords(to, st_all)]
    want = [ans["view_x"], ans["view_y"]]  # the view coordinates of every pixel
    assert all(np.array_equal(a, b) for a, b in zip(got, want))  # every pixel, both axes
    w, h = to.resolution
    written = (st_all["px"] / w * to.fov - to.fov * 0.5).numpy()
    assert (written != want[0]).mean() > 0.1  # the expression as written is not XLA's

    j_px, j_py, j_mcn, j_dir, j_dist, j_id, j_s, j_col = (ans[k] for k in PIXEL_KEYS)
    vol = torch.from_numpy(vol_np)
    tab = torch.from_numpy(table)
    st = t_sampling.init_render_state(to, tab, torch.tensor(PIXEL_IDS))
    eye, d = camera_ray_lookat(to, st)
    assert np.array_equal(st["px"].numpy(), j_px) and np.array_equal(st["py"].numpy(), j_py)
    assert np.array_equal(st["mc_normal"].to_array().numpy(), j_mcn)
    ulps = np.abs(d.to_array().numpy().view(np.int32).astype(np.int64)
                  - j_dir.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps

    def march(ray_dir):
        act = torch.ones(3, dtype=torch.bool)
        isec = t_march.raymarch(vol, to, eye, ray_dir, to.maxDist, to.maxIter, act)
        col = scene_color(vol, to, tab, st, eye, ray_dir).to_array().numpy()
        return isec, _ao_seed_float(isec["pos"], to.time), col

    isec, s, col = march(d)
    assert np.array_equal(isec["object_id"].numpy(), j_id)
    np.testing.assert_allclose(isec["distance"].numpy(), j_dist, rtol=0, atol=1e-6)
    assert 1355.99 < j_s[0] < 1356 and 1355.99 < s[0] < 1356  # both truncate to 1355
    np.testing.assert_allclose(col, j_col, rtol=0, atol=1e-6)
    # the written order: one ulp of the view coordinate, the other side of 1356
    t, u = to.targetPos, to.up
    fwd = normalize(V3(t[0] - eye.x, t[1] - eye.y, t[2] - eye.z))
    right = normalize(cross(fwd, V3(u[0], u[1], u[2])))
    w, h = to.resolution
    vcx = st["px"] / w * to.fov - to.fov * 0.5
    vcy = (st["py"] / h * to.fov - to.fov * 0.5) * (-to.invAspect)
    _, s_written, col_written = march(normalize(right * vcx + cross(right, fwd) * vcy + fwd))
    assert 1356 < s_written[0] < 1356.01
    assert np.abs(col_written[0] - j_col[0]).max() > 0.03  # the seed moved every AO probe
    # JAX's own ray directions fed to the port give JAX's colour
    _, s_j, col_j = march(V3(*(torch.from_numpy(j_dir[:, c].copy()) for c in range(3))))
    assert s_j[0] < 1356
    np.testing.assert_allclose(col_j, j_col, rtol=0, atol=1e-6)
