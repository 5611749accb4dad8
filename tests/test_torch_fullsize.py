"""The port held to the JAX package at the sizes users render.

At 8192 pixels and more the JAX package renders in bands, with deferred,
Morton-sorted shading (`raymarchcl_tpu/ops/render.py:48-113`), and its
users call it compiled: `render_image` and `api.render_frame` run one
jitted program. The port follows that program. Called op by op (not under
`jax.jit`), the JAX package rounds each product of `sampling.light_seed`
on its own where the compiled program contracts `px*1957 + py*2173` into
one fma, and the light jitter of about 2% of pixels takes another MC
sample (pixel 136059 below); its banded path compiles its shade bands in a
`lax.scan` only for bounce-free presets, so op by op its `metal` frame
left the port and its single-band `ao` frame left its banded one. Every
JAX render here is compiled.

- Band tests: one pass (pass 15, its MC table and time) of the main path's
  frame (gyroid 256^3, 512^2, full budgets, orbit camera theta=135, the
  brick table) over rows 256-271, 8192 pixels: the JAX package's
  `render_pass(ids=...)` at its default tiles under `jax.jit`, against the
  port's `render_passes(pix_lo=..., pix_count=8192)` (K2's and K2c's plain
  version), for `ao` and `metal` (3 bounces). The JAX pass is read from
  tests/jax_answers (`python tests/jax_answers.py regen fullsize-band-ao`
  computes it again).
- The full-size references under raymarchcl_tpu_torch/refs/: whole frames
  of the JAX package's `render_image` on the CPU (its banded, deferred and
  stacked path) over `api.build_accel_for`'s brick table, which
  chip_smoke.py holds the card's frames to. This file checks their sha256
  against the manifest, their shapes, and the port's config-1 band against
  its reference. Rebuild them with

      python tests/test_torch_fullsize.py regen [name ...]

  (about 25 min on 8 CPU cores in all; `check` instead of `regen` renders
  them again into local/refs-check/ and compares the sha256). `bands`
  prints each band's shares against the JAX package compiled and called op
  by op; `rays`, `metal-512`'s kept pixels from the port's and from JAX's
  ray directions.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax_answers
from jax_answers import save_npz, sha256

torch.set_num_threads(1)

REFS_DIR = os.path.join(os.path.dirname(__file__), "..", "raymarchcl_tpu_torch", "refs")
MANIFEST = os.path.join(REFS_DIR, "manifest.json")
TREFOIL = os.path.join(os.path.dirname(__file__), "..", "assets", "trefoil.stl")
MAIN_CAM = dict(theta=135.0, dist=2.25, y=0.35, target=[0, -0.4, 0])
CAM3 = dict(theta=120.0, dist=2.0, y=0.5, target=[0, 0, 0])  # config 3's
# Each reference: its volume (`gyroid` 256^3, or the trefoil mesh's
# `voxelize_ks(64, 1)` / `voxelize_scatter(128, seed=3)`), render_options'
# keywords, the camera, the spp (MC tables `make_mc_tables(spp, seed=0)`,
# times `arange(spp) * TIME_STEP_INIT`) and the accum rows kept beside the
# image. Configs 1-4 are scripts/run_configs.py's; `metal-512` and
# `config-4` take 2 spp, because a 16-pass JAX `metal` frame of 512^2 takes
# hours on the CPU.
REFS = {
    "ao-512": dict(volume="gyroid", vres=256, spp=16, cam=MAIN_CAM, rows=[256, 16],
                   opts=dict(width=512, height=512, mat="ao")),
    "metal-512": dict(volume="gyroid", vres=256, spp=2, cam=MAIN_CAM, rows=[256, 16],
                      opts=dict(width=512, height=512, mat="metal")),
    "config-1": dict(volume="gyroid", vres=256, spp=1, cam=MAIN_CAM, rows=[100, 37],
                     opts=dict(width=224, height=224, mat="ao")),
    "config-2": dict(volume="gyroid", vres=256, spp=25, cam=MAIN_CAM, rows=[256, 16],
                     opts=dict(width=512, height=512, mat="ao", fogPow=0.1)),
    "config-3": dict(volume="voxelize_ks(64, 1)", vres=64, spp=16, cam=CAM3, rows=[256, 16],
                     opts=dict(width=512, height=512, mat="ao")),
    "config-4": dict(volume="voxelize_scatter(128, seed=3)", vres=128, spp=2, cam=MAIN_CAM,
                     rows=[256, 16], opts=dict(width=512, height=512, mat="metal")),
}
SAMPLE_STRIDE = 64  # every 64th pixel of the frame is kept too
MAX_BYTES = 1_500_000  # all references together

TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51
MIN_PIXELS_OK = 0.995  # the port's criterion (tests/test_torch_render.py)
# The share of pixels off by more than 5e-3, and the share off by rel >
# 1e-3, that a band may have. Measured on this band: `ao` 1 of 8192 pixels
# off by more than 5e-3 (0.021, rel < 1e-3), none by rel > 1e-3; `metal` none
# off by more than 5e-3, 1 by rel > 1e-3 (5.1e-4 abs). 0.05% is 4 pixels.
MAX_OFF = 0.0005
PASS, ROW0, ROWS, WIDTH = 15, 256, 16, 512
PIXEL = 136059  # x 379, y 265 of the 512^2 frame, in the band


def kept_ids(ref):
    """The pixel ids whose accum a reference keeps: its band of rows, then
    every SAMPLE_STRIDE-th pixel of the frame."""
    w, h = ref["opts"]["width"], ref["opts"]["height"]
    r0, nr = ref["rows"]
    return (np.arange(r0 * w, (r0 + nr) * w, dtype=np.int32),
            np.arange(0, w * h, SAMPLE_STRIDE, dtype=np.int32))


def write_reference(name, argb, acc, out_dir):
    """A reference's files from its frame: `<name>.webp`, the packed image's
    RGB (the alpha byte is always 0xFF) as a lossless WebP, which takes 29-43%
    fewer bytes than the PNG of these noisy frames (PNGs of the six came to
    1.43 MB), and `<name>.npz`, the float32 accum of kept_ids with the ids.
    Returns {file: sha256}."""
    from PIL import Image

    argb = np.asarray(argb, np.uint32)
    rgb = np.stack([(argb >> s) & 0xFF for s in (16, 8, 0)], axis=-1).astype(np.uint8)
    assert ((argb >> 24) == 0xFF).all()
    band, sample = kept_ids(REFS[name])
    img, npz = os.path.join(out_dir, f"{name}.webp"), os.path.join(out_dir, f"{name}.npz")
    Image.fromarray(rgb).save(img, lossless=True, quality=100, method=6)
    save_npz(npz, band_ids=band, band=acc[band], sample_ids=sample, sample=acc[sample])
    return {os.path.basename(p): sha256(p) for p in (img, npz)}


def load_reference(name):
    """(rgb (H, W, 3) uint8, {band_ids, band, sample_ids, sample})."""
    from PIL import Image

    rgb = np.asarray(Image.open(os.path.join(REFS_DIR, f"{name}.webp")).convert("RGB"))
    with np.load(os.path.join(REFS_DIR, f"{name}.npz")) as z:
        return rgb, {k: z[k] for k in z.files}


def shares(got, want):
    """(share within TOL, share off by more than 5e-3, share off by rel >
    1e-3, worst pixel's index, its abs error) of (n, 3) accums."""
    err = np.abs(got - want).max(axis=1)
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max(axis=1)
    ok = np.isclose(got, want, **TOL).all(axis=1)
    return ok.mean(), (err > 5e-3).mean(), (rel > 1e-3).mean(), int(err.argmax()), err.max()


# -- the JAX package's side --------------------------------------------------

def jax_volume(name, vres):
    """A reference's volume from the JAX package, flat uint8. The gyroid
    comes from its numpy path, which the port's generator equals byte for
    byte: its native C++ path, where built, sets one voxel of the 256^3
    gyroid otherwise (z 168, y 215, x 191: 255, not 0)."""
    from unittest import mock

    from raymarchcl_tpu.models import generators, mesh

    if name == "gyroid":
        with mock.patch.object(generators, "_native", None):
            return np.asarray(generators.make_gyroid_volume({"vres": [vres] * 3}), np.uint8)
    verts = mesh.read_stl(TREFOIL)
    if name == "voxelize_ks(64, 1)":
        return mesh.voxelize_ks(verts, 64, 1).reshape(-1)
    assert name == "voxelize_scatter(128, seed=3)", name
    return mesh.voxelize_scatter(verts, 128, seed=3).reshape(-1)


def jax_options(ref, **kw):
    from raymarchcl_tpu.ops.camera import compute_eyepos
    from raymarchcl_tpu.options import render_options

    cam = ref["cam"]
    return render_options(vres=[ref["vres"]] * 3, iter=ref["spp"],
                          eyepos=compute_eyepos(cam["theta"], cam["dist"], cam["y"]),
                          targetpos=cam["target"], **{**ref["opts"], **kw})


def render_reference(name):
    """(argb (H, W) uint32, accum (N, 3) float32, seconds): the JAX
    package's render_image of the reference on the CPU."""
    import jax.numpy as jnp
    from raymarchcl_tpu import api
    from raymarchcl_tpu.ops import render
    from raymarchcl_tpu.ops.sampling import make_mc_tables

    ref = REFS[name]
    vol = jax_volume(ref["volume"], ref["vres"])
    opts = jax_options(ref)
    t0 = time.perf_counter()
    argb, acc = render.render_image(jnp.asarray(vol), opts, make_mc_tables(ref["spp"], seed=0),
                                    accel=api.build_accel_for(vol, opts))
    acc = np.asarray(acc, np.float32)
    return np.asarray(argb), acc, time.perf_counter() - t0


def regen(names, write=True):
    """Render each named reference with the JAX package and write its files
    and its manifest entry (or, with write=False, write them to
    local/refs-check/ and compare their sha256 with the manifest's)."""
    manifest = json.load(open(MANIFEST)) if os.path.exists(MANIFEST) else {}
    out_dir = REFS_DIR if write else os.path.join(REFS_DIR, "..", "..", "local", "refs-check")
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        argb, acc, secs = render_reference(name)
        files = write_reference(name, argb, acc, out_dir)
        if not write:
            same = files == manifest[name]["files"]
            print(f"{name}: {secs:.1f} s, sha256 {'equal' if same else 'DIFFER'}: {files}",
                  flush=True)
            continue
        spp = REFS[name]["spp"]
        manifest[name] = dict(
            REFS[name], files=files, seconds=round(secs, 1),
            call=("raymarchcl_tpu.ops.render.render_image(vol, opts, make_mc_tables("
                  f"{spp}, seed=0), accel=api.build_accel_for(vol, opts)) on the CPU"))
        with open(MANIFEST, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"{name}: {secs:.1f} s -> {files}", flush=True)


# -- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def gyroid():
    return jax_volume("gyroid", 256)


def make_port_scene(gyroid):
    """The gyroid on the port's side and its brick table."""
    from raymarchcl_tpu_torch.convert import volume_from_numpy
    from raymarchcl_tpu_torch.ops.accel import build_accel

    vol = volume_from_numpy(gyroid)
    opts = _port_options(REFS["ao-512"])
    return vol, build_accel(vol, opts.voxelRes, opts.isoVal)


@pytest.fixture(scope="module")
def port_scene(gyroid):
    return make_port_scene(gyroid)


def _port_options(ref, **kw):
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos
    from raymarchcl_tpu_torch.options import render_options

    cam = ref["cam"]
    return render_options(vres=[ref["vres"]] * 3, iter=ref["spp"],
                          eyepos=compute_eyepos(cam["theta"], cam["dist"], cam["y"]),
                          targetpos=cam["target"], **{**ref["opts"], **kw})


def jax_band(gyroid, compiled=True, tiles=None, **kw):
    """The JAX package's pass 15 of the main path's frame over rows 256-271
    (render_options keywords `kw` on top), under `jax.jit` unless
    `compiled` is False, at `tiles` bands (its default: auto_tiles)."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu import api
    from raymarchcl_tpu.ops import render as j_render
    from raymarchcl_tpu.ops import sampling as js

    ref = dict(REFS["ao-512"], opts=dict(REFS["ao-512"]["opts"], **kw))
    lo, n = ROW0 * WIDTH, ROWS * WIDTH
    jo = jax_options(ref).replace(time=jnp.float32(PASS * 0.333))

    def j_pass(v, o, tb, a, ids, ac):
        return j_render.render_pass(v, o, tb, a, ids=ids, accel=ac, tiles=tiles)

    return np.asarray((jax.jit(j_pass) if compiled else j_pass)(
        jnp.asarray(gyroid), jo, js.make_mc_tables(16, seed=0)[PASS],
        jnp.zeros((n, 3), jnp.float32), jnp.arange(lo, lo + n, dtype=jnp.int32),
        api.build_accel_for(gyroid, jo)))


def band_digest(gyroid, **kw):
    """The inputs digest of jax_band: the volume, pass 15's MC table, the
    options and the pass's time, the band's pixel ids."""
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables

    ref = dict(REFS["ao-512"], opts=dict(REFS["ao-512"]["opts"], **kw))
    lo = ROW0 * WIDTH
    return jax_answers.digest(gyroid, make_mc_tables(16, seed=0)[PASS],
                              dict(ref, time=PASS * 0.333),
                              np.arange(lo, lo + ROWS * WIDTH, dtype=np.int32))


def port_band(port_scene, **kw):
    """The port's plain version's accum of jax_band's pixels."""
    from raymarchcl_tpu_torch.ops import render as t_render
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables

    ref = dict(REFS["ao-512"], opts=dict(REFS["ao-512"]["opts"], **kw))
    vol, bricks = port_scene
    acc = torch.zeros((ROWS * WIDTH, 3))
    # render.TIME_STEP_INIT, as render_image's times
    t_render.render_passes(vol, _port_options(ref), make_mc_tables(16, seed=0)[PASS:PASS + 1],
                           [np.float32(PASS * 0.333)], acc, bricks, pix_lo=ROW0 * WIDTH,
                           pix_count=ROWS * WIDTH)
    return acc.numpy()


def band_pass(gyroid, port_scene, **kw):
    """(jax_band's compiled accum, port_band). The JAX pass runs in a thread
    beside the port's (both release the GIL), which halves the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        j_acc = pool.submit(jax_band, gyroid, **kw)
        acc = port_band(port_scene, **kw)
        return j_acc.result(), acc


@pytest.fixture(scope="module", params=["ao", "metal"])
def band(request, gyroid, port_scene):
    """The port's plain version and the JAX package's compiled pass on the
    band (its answer from tests/jax_answers)."""
    mat = request.param
    want = jax_answers.load(f"fullsize-band-{mat}", band_digest(gyroid, mat=mat))
    return dict(mat=mat, jax=want["acc"], port=port_band(port_scene, mat=mat))


def test_band_matches_jax(band):
    """The port's plain version against the JAX package's compiled banded
    pass on 8192 pixels: the port's criterion, and at most MAX_OFF of the
    pixels off by more than 5e-3 or by rel > 1e-3."""
    got, want = band["port"], band["jax"]
    assert np.isfinite(got).all() and (got > 0).any()
    ok, off, off_rel, worst, err = shares(got, want)
    msg = (f"{band['mat']}: {ok:.6f} within tolerance, {off:.4%} off by > 5e-3, {off_rel:.4%} "
           f"by rel > 1e-3, worst pixel {ROW0 * WIDTH + worst} off by {err:.4g}")
    assert ok >= MIN_PIXELS_OK, msg
    assert off <= MAX_OFF and off_rel <= MAX_OFF, msg


def test_pixel_136059_on_the_compiled_side(band):
    """Pixel 136059, where the JAX package called op by op moved by 1.33
    (`metal`) in one pass's accum: the port's colour is the compiled
    program's."""
    i = PIXEL - ROW0 * WIDTH
    np.testing.assert_allclose(band["port"][i], band["jax"][i], rtol=1e-5, atol=1e-5)


def test_pixel_136059_light_seed():
    """The stage at which the JAX package called op by op leaves the
    port at pixel 136059 (pass 15): the light jitter's seed,
    sampling.light_seed = (uint)(px*1957 + py*2173 + time*4763.742). The
    compiled program contracts px*1957 + py*2173 into fma(px, 1957,
    py*2173), as the port computes it, and the float 1341028.0 truncates to
    1341028; op by op each product is rounded, the float is 1341027.875,
    and the seed 1341027 takes another MC sample for the jitter of every
    light. The float's ulp there is 0.125, so about 2% of pixels flip."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import sampling as js
    from raymarchcl_tpu_torch.ops import sampling as ts

    ref = dict(REFS["ao-512"], opts=dict(width=WIDTH, height=WIDTH, mat="metal"))
    t = np.float32(PASS * 0.333)
    jo = jax_options(ref).replace(time=jnp.float32(t))
    table = np.asarray(js.make_mc_tables(16, seed=0)[PASS])
    st = jax.jit(js.init_render_state)(jo, js.transpose_table(jnp.asarray(table)),
                                       jnp.array([PIXEL], jnp.int32))
    px, py = np.asarray(st["px"]), np.asarray(st["py"])
    def seed_float(o, px, py):  # the float sampling.light_seed truncates
        return px * 1957.0 + py * 2173.0 + o.time * 4763.742

    assert float(jax.jit(seed_float)(jo, px, py)[0]) == 1341028.0
    assert float(seed_float(jo, jnp.asarray(px), jnp.asarray(py))[0]) == 1341027.875
    compiled = int(np.asarray(jax.jit(js.light_seed)(jo, px, py))[0])
    op_by_op = int(np.asarray(js.light_seed(jo, jnp.asarray(px), jnp.asarray(py)))[0])
    port = int(ts.light_seed(_port_options(ref).replace(time=torch.tensor(t)),
                             torch.from_numpy(px.copy()), torch.from_numpy(py.copy()))[0])
    assert (port, compiled, op_by_op) == (1341028, 1341028, 1341027)
    assert (port & 0x3FFF) != (op_by_op & 0x3FFF)  # another MC table entry


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(REFS))
def test_reference_files(manifest, name):
    """A reference's manifest entry states its configuration, its JAX call
    and each file's sha256; the image and the kept accum have the frame's
    shape."""
    entry = manifest[name]
    assert {k: entry[k] for k in REFS[name]} == json.loads(json.dumps(REFS[name]))
    assert "render_image" in entry["call"] and entry["seconds"] > 0
    for fname, digest in entry["files"].items():
        assert sha256(os.path.join(REFS_DIR, fname)) == digest, fname
    rgb, kept = load_reference(name)
    w, h = REFS[name]["opts"]["width"], REFS[name]["opts"]["height"]
    assert rgb.shape == (h, w, 3) and rgb.dtype == np.uint8
    assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 256  # a real image
    band, sample = kept_ids(REFS[name])
    np.testing.assert_array_equal(kept["band_ids"], band)
    np.testing.assert_array_equal(kept["sample_ids"], sample)
    for k, ids in (("band", band), ("sample", sample)):
        assert kept[k].shape == (len(ids), 3) and kept[k].dtype == np.float32
        assert np.isfinite(kept[k]).all() and (kept[k] > 0).any()


def test_references_fit():
    """Every reference's files, and no other, in under MAX_BYTES."""
    files = sorted(os.listdir(REFS_DIR))
    assert files == sorted(["manifest.json"] + [f"{n}.{e}" for n in REFS for e in ("webp", "npz")])
    assert sum(os.path.getsize(os.path.join(REFS_DIR, f)) for f in files) < MAX_BYTES


def test_config1_band_matches_reference(port_scene):
    """BASELINE config 1 (224^2, 1 spp): the port's plain version over its
    37 kept rows against the JAX package's render_image (its reference),
    the port's criterion and at most MAX_OFF off."""
    from raymarchcl_tpu_torch.ops import render as t_render
    from raymarchcl_tpu_torch.ops.sampling import make_mc_tables

    ref = REFS["config-1"]
    _, kept = load_reference("config-1")
    ids = kept["band_ids"]
    acc = torch.zeros((len(ids), 3))
    vol, bricks = port_scene
    t_render.render_passes(vol, _port_options(ref), make_mc_tables(1, seed=0), [0.0], acc,
                           bricks, pix_lo=int(ids[0]), pix_count=len(ids))
    ok, off, off_rel, worst, err = shares(acc.numpy(), kept["band"])
    msg = f"{ok:.6f} within, {off:.4%} > 5e-3, {off_rel:.4%} rel, px {ids[worst]} {err:.4g}"
    assert ok >= MIN_PIXELS_OK and off <= MAX_OFF and off_rel <= MAX_OFF, msg


def kept_colours(port_scene, name, ids, jax_rays=False):
    """The port's accum of a gyroid reference's pixels `ids` over its
    passes, from its own primary rays or (jax_rays) from the JAX package's
    compiled ones: (accum (n, 3), direction components that differ from
    JAX's, all components)."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import camera as j_camera
    from raymarchcl_tpu.ops import sampling as js
    from raymarchcl_tpu_torch.ops import sampling as ts
    from raymarchcl_tpu_torch.ops.camera import camera_ray_lookat
    from raymarchcl_tpu_torch.ops.shade import scene_color
    from raymarchcl_tpu_torch.ops.vecmath import V3, fma

    ref = REFS[name]
    j_rays = jax.jit(lambda o, tb, i: j_camera.camera_ray_lookat(o, js.init_render_state(o, tb, i)))
    tables = np.asarray(js.make_mc_tables(ref["spp"], seed=0))
    vol, bricks = port_scene
    acc, n_diff = torch.zeros((len(ids), 3)), 0
    for p in range(ref["spp"]):
        t = np.float32(p * 0.333)
        to = _port_options(ref).replace(time=torch.tensor(t))
        table = torch.from_numpy(tables[p].copy())
        st = ts.init_render_state(to, table, torch.as_tensor(np.asarray(ids, np.int64)))
        pos, d = camera_ray_lookat(to, st)
        j_pos, j_dir = j_rays(jax_options(ref).replace(time=jnp.float32(t)),
                              js.transpose_table(jnp.asarray(tables[p])),
                              jnp.asarray(ids, jnp.int32))
        n_diff += sum(int((np.asarray(a) != b.numpy()).sum()) for a, b in zip(j_dir, d))
        if jax_rays:
            pos, d = (V3(*(torch.from_numpy(np.array(c)) for c in v)) for v in (j_pos, j_dir))
        col = (scene_color(vol, to, table, st, pos, d, bricks) * to.exposure).to_array()
        acc = fma(col - acc, to.frameBlend, acc)
    return acc.numpy(), n_diff, 3 * len(ids) * ref["spp"]


# The kept pixels of `metal-512` off by rel > 1e-3 (x 128, 256, 192, 128)
RAY_DIR_PIXELS = [174208, 177408, 199360, 217728]


def test_metal512_departures_are_the_ray_directions(port_scene):
    """The port's 2-pass `metal-512` frame leaves its reference by rel >
    1e-3 on 4 of its 12288 kept pixels (0.021 rel, 0.067 abs at 174208;
    `python tests/test_torch_fullsize.py rays`). Each is the last bits of
    the primary ray direction, amplified by the bounces: XLA:CPU's rsqrt
    estimate and its contraction of the camera's sums, which the port does
    not copy, leave about half of the direction components an ulp or two
    off. With the JAX package's compiled ray directions the port's colour
    is its reference's within rel 1e-5 at these pixels."""
    _, kept = load_reference("metal-512")
    ids = np.concatenate([kept["band_ids"], kept["sample_ids"]])
    want = np.concatenate([kept["band"], kept["sample"]])[np.searchsorted(ids, RAY_DIR_PIXELS)]
    rel = {k: (np.abs(kept_colours(port_scene, "metal-512", RAY_DIR_PIXELS, k)[0] - want)
               / np.abs(want)).max(axis=1) for k in (False, True)}
    assert (rel[False] > 1e-3).all(), rel
    assert (rel[True] < 1e-5).all(), rel


def report():
    """What the tests bound, printed: each band's shares against the JAX
    package compiled and called op by op, at its default tiles and at one
    band, and the native gyroid's voxels where built (`bands`, ~15 min);
    `metal-512`'s kept pixels with the port's and with JAX's ray directions
    (`rays`, ~7 min)."""
    gyroid = jax_volume("gyroid", 256)
    port_scene = make_port_scene(gyroid)
    if sys.argv[1] == "bands":
        from raymarchcl_tpu.models import generators

        if generators._native is not None and generators._native.available():
            native = np.asarray(generators.make_gyroid_volume({"vres": [256] * 3}))
            at = np.nonzero(native != gyroid)[0]
            print(f"gyroid 256^3, the JAX package's native path against its numpy path (the "
                  f"port's): {len(at)} voxels differ, at (z, y, x) "
                  f"{[(int(i) >> 16, int(i) >> 8 & 255, int(i) & 255) for i in at]}")
        i = PIXEL - ROW0 * WIDTH
        for kw in (dict(mat="ao"), dict(mat="metal"), dict(mat="metal", reflectIter=1)):
            j_acc, acc = band_pass(gyroid, port_scene, **kw)
            for compiled in (True, False):
                j_one = jax_band(gyroid, compiled, 1, **kw)
                j_def = j_acc if compiled else jax_band(gyroid, False, **kw)
                for what, want in (("default tiles", j_def), ("tiles=1", j_one)):
                    ok, off, off_rel, worst, err = shares(acc, want)
                    print(f"{kw} JAX {'compiled' if compiled else 'op by op'}, {what}: {ok:.6f} "
                          f"within tolerance, {off:.4%} off by > 5e-3, {off_rel:.4%} "
                          f"({round(off_rel * ROWS * WIDTH)} px) by rel > 1e-3, worst pixel "
                          f"{ROW0 * WIDTH + worst} off by {err:.4g}; pixel {PIXEL} off by "
                          f"{np.abs(acc[i] - want[i]).max():.4g}", flush=True)
                print(f"{kw} JAX {'compiled' if compiled else 'op by op'}: default tiles vs "
                      f"tiles=1 max abs {np.abs(j_def - j_one).max():.4g}", flush=True)
        return
    _, kept = load_reference("metal-512")
    ids = np.concatenate([kept["band_ids"], kept["sample_ids"]])
    want = np.concatenate([kept["band"], kept["sample"]])
    for jax_rays in (False, True):
        acc, n_diff, n = kept_colours(port_scene, "metal-512", ids, jax_rays)
        ok, off, off_rel, worst, err = shares(acc, want)
        rel = (np.abs(acc - want) / np.abs(want)).max(axis=1)
        print(f"metal-512 kept pixels, {'JAX' if jax_rays else 'the port'}'s ray directions "
              f"({n_diff} of {n} direction components differ from JAX's): {ok:.6f} within "
              f"tolerance, {off_rel:.4%} ({int((rel > 1e-3).sum())} px) off by rel > 1e-3, "
              f"max rel {rel.max():.3g}, worst pixel {ids[worst]} off by {err:.4g}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("regen", "check", "bands", "rays"):
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
        import jax

        jax.config.update("jax_platforms", "cpu")
        if sys.argv[1] in ("bands", "rays"):
            report()
        else:
            regen(sys.argv[2:] or list(REFS), write=sys.argv[1] == "regen")
