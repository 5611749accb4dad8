"""The JAX package's answers that the port's tests hold it to, computed once
and committed.

The JAX package is frozen, so its answer for a fixed input is a constant.
Each entry of ANSWERS names one test case's JAX side and the recipe that
computes it: the JAX calls the test made, compiled where the test compiled
them. `tests/jax_answers/<name>.npz` holds the arrays, and `manifest.json`
each file's sha256, the digest of the inputs it was computed from and the
jax/jaxlib versions that computed it. A test passes the digest of its own
inputs to `load`, which refuses an answer computed from other inputs: a
changed input fails loudly and is never compared with a stale answer.

    python tests/jax_answers.py regen [name ...]
    python tests/jax_answers.py check [name ...]

`regen` writes the files and the manifest. `check` computes every answer
again into local/jax-answers-check/ and prints, for each, whether its
sha256 equals the manifest's and its largest absolute difference; it fails
only where an array moved by more than the tightest tolerance a test
applies to it (ANSWERS' `tol`, 0 where unnamed): XLA:CPU's contraction
follows the host's machine features (tests/conftest.py), so another host
may move the last bits of a compiled answer. This module imports no JAX;
the recipes do, after `_jax_env` has set up tests/conftest.py's CPU
platform and 8 host devices.
"""

import hashlib
import io
import json
import os
import sys
import time
import zipfile
from functools import partial

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIR = os.path.join(HERE, "jax_answers")
MANIFEST = os.path.join(DIR, "manifest.json")
CHECK_DIR = os.path.join(HERE, "..", "local", "jax-answers-check")


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save_npz(path, **arrays):
    """An .npz that np.load reads, its members LZMA-compressed (a fifth
    smaller than np.savez_compressed's deflate on these accums) with fixed
    zip timestamps, so equal arrays give equal bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_LZMA) as z:
        for name, a in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_LZMA
            with z.open(info, "w") as f:
                np.lib.format.write_array(f, np.asarray(a, order="C"), allow_pickle=False)


def digest(vol, tables, kw, *more):
    """The inputs digest: sha256 over the volume's bytes, the MC tables'
    bytes (either may be None), the options keywords as sorted JSON, then
    any further inputs (pixel ids, times, rays) as arrays."""
    h = hashlib.sha256()
    for a in (vol, tables):
        h.update(b"" if a is None else np.ascontiguousarray(np.asarray(a)).tobytes())
    h.update(json.dumps(kw, sort_keys=True, default=lambda v: np.asarray(v).tolist()).encode())
    for a in more:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _manifest():
    if not os.path.exists(MANIFEST):
        return {}
    with open(MANIFEST) as f:
        return json.load(f)


def load(name, inputs_digest):
    """The stored arrays of answer `name`, if they were computed from inputs
    with this digest."""
    path, entry = os.path.join(DIR, f"{name}.npz"), _manifest().get(name)
    regen = f"python tests/jax_answers.py regen {name}"
    if entry is None or not os.path.exists(path):
        raise LookupError(f"no stored JAX answer {name!r}: run {regen}")
    if entry["inputs"] != inputs_digest:
        raise ValueError(f"the JAX answer {name!r} was computed from other inputs "
                         f"({entry['inputs'][:12]}, the test's {inputs_digest[:12]}): run {regen}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- the recipes: each returns (inputs digest, {array name: array}) ----------

def _jax_env():
    """tests/conftest.py's JAX: the CPU platform with 8 host devices, set
    before the first import of JAX."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for p in (HERE, os.path.dirname(HERE)):  # the test modules and both packages
        if p not in sys.path:
            sys.path.insert(0, p)


def _test(module):
    """A port test module, for the constants and inputs its cases share with
    their recipes."""
    import importlib

    return importlib.import_module(module)


def _gyroid(vres):
    from raymarchcl_tpu.models import generators

    return generators.make_gyroid_volume({"vres": list(vres)})


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _frame(vol, kw, tables, accel=None):
    """The JAX package's render_image on the CPU: (argb, accum)."""
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import render
    from raymarchcl_tpu.options import render_options

    argb, acc = render.render_image(jnp.asarray(vol), render_options(**kw), jnp.asarray(tables),
                                    accel=accel)
    return dict(argb=np.asarray(argb), acc=np.asarray(acc))


def _fullsize_band(mat):
    t = _test("test_torch_fullsize")
    gyroid = t.jax_volume("gyroid", 256)
    return t.band_digest(gyroid, mat=mat), dict(acc=t.jax_band(gyroid, mat=mat))


def _reflect_frame(mat):
    from raymarchcl_tpu.ops import sampling as js

    t = _test("test_torch_reflect_frame")
    vol, kw = _gyroid(t.VRES), dict(t.FRAME, mat=mat)
    tables = np.asarray(js.make_mc_tables(1, seed=3))
    return digest(vol, tables, kw), _frame(vol, kw, tables)


def _codec_blobs(frame):
    from raymarchcl_tpu import compat

    t = _test("test_torch_codec")
    vol = _gyroid(t.VRES)
    blobs, tables, kw = t.blob_inputs(frame)
    argb, acc = compat.render_from_blobs(blobs, vol, tables, accel=frame == "ao")
    return t.blob_digest(vol, blobs, tables, kw), dict(argb=np.asarray(argb), acc=np.asarray(acc))


def _cli(what):
    """`anim`: the RGB of test_anim's three PNG frames; `preview`: the argb
    of test_render(preview=True). Both from the 16^3 gyroid's .vox file."""
    import tempfile

    from PIL import Image
    from raymarchcl_tpu import api
    from raymarchcl_tpu.io import voxio

    t = _test("test_torch_cli")
    with tempfile.TemporaryDirectory() as tmp:
        vname = os.path.join(tmp, "g16.vox")
        voxio.save_volume(vname, 16, _gyroid([16] * 3))
        vox = np.fromfile(vname, np.uint8)
        if what == "preview":
            return digest(vox, None, t.PREVIEW), dict(argb=np.asarray(api.test_render(
                vname=vname, **t.PREVIEW)))
        paths = api.test_anim(vname=vname, out_dir=os.path.join(tmp, "j"), verbose=False,
                              **t.ANIM)
        rgb = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    return digest(vox, None, t.ANIM), dict(rgb=rgb)


def _checkpoint_resume():
    """The JAX package's render_checkpointed stopped after 2 of 5 passes
    (its checkpoint file's bytes, written with the clock held at
    1980-01-01, the zip's only other varying bytes) and its straight
    frame's accum."""
    import tempfile
    from unittest import mock

    import jax.numpy as jnp
    from raymarchcl_tpu.io import checkpoint
    from raymarchcl_tpu.ops import render, sampling as js
    from raymarchcl_tpu.options import render_options

    t = _test("test_torch_checkpoint")
    vol, opts, tables = _gyroid(t.VRES), render_options(**t.KW), js.make_mc_tables(5, seed=2)

    def stop(done, total):
        raise KeyboardInterrupt

    epoch = time.struct_time((1980, 1, 1, 0, 0, 0, 1, 1, 0))
    with tempfile.TemporaryDirectory() as tmp, mock.patch("time.localtime", lambda *a: epoch):
        try:
            checkpoint.render_checkpointed(jnp.asarray(vol), opts, tables,
                                           os.path.join(tmp, "ck"), chunk=2, progress=stop)
        except KeyboardInterrupt:
            pass
        ckpt = np.fromfile(os.path.join(tmp, "ck.npz"), np.uint8)
    _, acc = render.render_image(jnp.asarray(vol), opts, tables)
    return digest(vol, tables, t.KW), dict(ckpt=ckpt, acc=np.asarray(acc))


def _pass_digests(step):
    import jax.numpy as jnp
    from raymarchcl_tpu.io import checkpoint
    from raymarchcl_tpu.ops import render, sampling as js

    tables = js.make_mc_tables(3, seed=4)
    times = jnp.arange(3, dtype=jnp.float32) * getattr(render, f"TIME_STEP_{step.upper()}")
    return digest(None, tables, {}, times), {
        f"seed-{s}": np.array(checkpoint.pass_digest(tables, times, s)) for s in (None, 0, 7)}


def _primary(vol, kw, table, acc=None, keys=("object_id", "distance", "pos", "normal")):
    """The JAX package's camera rays of a frame and their smooth march,
    compiled: p and d (3, N) and the march's `keys`."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import camera, march, sampling as js
    from raymarchcl_tpu.options import render_options

    o = render_options(**kw)
    n = o.num_pixels

    @jax.jit
    def jfn(o, vol, table_t, acc):
        st = js.init_render_state(o, table_t, jnp.arange(n, dtype=jnp.int32))
        p, d = camera.camera_ray_lookat(o, st)
        i = march.raymarch(vol, o, p, d, o.maxDist, o.maxIter, smooth=True,
                           active=jnp.ones(n, bool), accel=acc)
        return p, d, {k: i[k] for k in keys}

    p, d, i = jfn(o, jnp.asarray(vol), js.transpose_table(jnp.asarray(table)), acc)
    return dict(p=_np3(p), d=_np3(d), **{k: np.asarray(v) if k in ("object_id", "distance")
                                         else _np3(v) for k, v in i.items()})


def _shadow(vol, kw, rays, acc=None):
    """The port's march of `rays` (over the brick table `acc`, carried over),
    its shadow rays toward the light (tests/test_torch_march.py), and the
    JAX package's compiled shadow factor of them: (the shadow rays, answer)."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import shade
    from raymarchcl_tpu.ops.vecmath import V3
    from raymarchcl_tpu.options import render_options
    from raymarchcl_tpu_torch.convert import accel_from_numpy

    t = _test("test_torch_march")
    to = t.render_options(**kw)
    tacc = None if acc is None else accel_from_numpy(np.asarray(acc.rows), acc.edge)
    hit, origin, ldir, lmax = t.shadow_rays(to, t.port_march(vol, to, rays, tacc))
    rays = (np.asarray(hit), _np3(origin), _np3(ldir), np.asarray(lmax))
    want = jax.jit(lambda o, v, org, ld, lm, a, acc: shade.shadow(v, o, org, ld, lm, a, accel=acc))(
        render_options(**kw), jnp.asarray(vol), V3(*map(jnp.asarray, rays[1])),
        V3(*map(jnp.asarray, rays[2])), jnp.asarray(rays[3]), jnp.asarray(rays[0]), acc)
    return rays, dict(shadow=np.asarray(want))


def _accel(what):
    """tests/test_torch_accel.py's scene (the 32x32x96 gyroid and the JAX
    package's brick table) and one of its JAX sides."""
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import accel, march, sampling as js
    from raymarchcl_tpu.ops.vecmath import V3
    from raymarchcl_tpu.options import render_options

    t = _test("test_torch_accel")
    vol, jo = _gyroid(t.VRES), render_options(**t.KW)
    jacc = accel.build_accel(vol, jo.voxelRes, jo.isoVal)

    def key(*more):
        return digest(vol, None, t.KW, np.asarray(jacc.rows), *more)

    if what == "frame":
        tables = np.asarray(js.make_mc_tables(1, seed=3))
        return key(tables), dict(acc=_frame(vol, t.KW, tables, jacc)["acc"])
    if what == "march-volume":
        p0, delta, mkd, cases = t.march_volume_inputs(jo.maxVoxelIter)
        out = {}
        for i, kw in enumerate(cases):
            jkw = {k: (jnp.asarray(v) if k == "max_k_dyn" else v) for k, v in kw.items()}
            out[f"hit{i}"], out[f"k{i}"] = map(np.asarray, march.march_volume(
                jnp.asarray(vol), jo, V3(*map(jnp.asarray, p0)), V3(*map(jnp.asarray, delta)),
                jo.maxVoxelIter, jnp.ones(len(mkd), bool), accel=jacc, **jkw))
        return key(p0, delta, mkd), out
    table = np.array(js.generate_scatter_offsets(seed=3))
    rays = _primary(vol, t.KW, table, jacc, keys=("object_id", "distance"))
    if what == "primary":
        return key(table), rays
    shadow_rays, want = _shadow(vol, t.KW, rays, jacc)
    return key(*shadow_rays), want


def _march(what):
    """tests/test_torch_march.py: the primary march and shadow rays of its
    frame at a budget (`primary-reduced`, `shadow-default`, ...), its two
    iso tests, or its saturating casts."""
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import march, sampling as js
    from raymarchcl_tpu.ops.vecmath import V3
    from raymarchcl_tpu.options import render_options

    t = _test("test_torch_march")

    def j3(v):
        return V3(*map(jnp.asarray, _np3(v)))

    if what == "iso-tests":
        vol, q, p0, delta = t.iso_inputs()
        o = render_options(vres=t.ISO_VRES)
        hit, k = march.march_volume(jnp.asarray(vol), o, j3(p0), j3(delta), 32,
                                    jnp.asarray([True]))
        return digest(vol, None, dict(vres=t.ISO_VRES), _np3(q), _np3(p0), _np3(delta)), dict(
            occ=np.asarray(march.occupancy_i(jnp.asarray(vol), o, j3(q))), hit=np.asarray(hit),
            k=np.asarray(k))
    if what == "saturating-casts":
        x, p, d = t.cast_inputs()
        vol, o = np.zeros(64**3, np.uint8), render_options(vres=t.CAST_VRES)
        coord = march.voxel_coord(o, V3(jnp.asarray(x), jnp.asarray(x[::-1]), jnp.asarray(x)))
        isec = march.raymarch(jnp.asarray(vol), o, j3(p), j3(d), 30.0, 4, smooth=False,
                              active=jnp.asarray([True]), want_normal=False)
        return digest(vol, None, dict(vres=t.CAST_VRES), x, _np3(p), _np3(d)), dict(
            coord=_np3(coord), object_id=np.asarray(isec["object_id"]))
    kind, budget = what.split("-")
    vol, kw = _gyroid(t.VRES), t.frame_kw(budget)
    table = np.array(js.generate_scatter_offsets(seed=3))
    rays = _primary(vol, kw, table)
    if kind == "primary":
        return digest(vol, table, kw), rays
    shadow_rays, want = _shadow(vol, kw, rays)
    return digest(vol, None, kw, *shadow_rays), want


def _render(case):
    """tests/test_torch_render.py: a frame of its CASES, or the view
    coordinates of the 100x37 frame and pixels 3531, 3530, 3532 through the
    JAX package's compiled camera, march and scene colour."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import camera, march, sampling as js, shade
    from raymarchcl_tpu.options import render_options

    t = _test("test_torch_render")
    if case != "pixel-3531":
        kw = t.case_kw(case)
        vol, tables = _gyroid(t.VRES), np.asarray(js.make_mc_tables(kw["iter"], seed=3))
        return digest(vol, tables, kw), _frame(vol, kw, tables)
    vol, table, _ = t._pixel_case()
    jo = render_options(**t.PIXEL_KW).replace(time=jnp.float32(0.0))

    @jax.jit
    def j_view(opts, table_t, ids):  # raymarchcl_tpu/ops/camera.py:26-27
        st = js.init_render_state(opts, table_t, ids)
        w, h = opts.resolution
        return (st["px"] / w * opts.fov - opts.fov * 0.5,
                (st["py"] / h * opts.fov - opts.fov * 0.5) * (-opts.invAspect))

    @jax.jit
    def j_pixel(vol, opts, table_t, ids):
        st = js.init_render_state(opts, table_t, ids)
        pos, d = camera.camera_ray_lookat(opts, st)
        isec = march.raymarch(vol, opts, pos, d, opts.maxDist, opts.maxIter, smooth=True,
                              active=jnp.ones(ids.shape, bool))
        p = isec["pos"]
        s = p.x * 3183.75 + p.y * 1831.42 + p.z * 2945.87 + opts.time * 2671.918
        col = shade.scene_color(vol, opts, table_t, st, pos, d)
        return (st["px"], st["py"], st["mc_normal"].to_array(), d.to_array(),
                isec["distance"], isec["object_id"], s, col.to_array())

    table_t = js.transpose_table(jnp.asarray(table))
    view = j_view(jo, table_t, jnp.arange(jo.num_pixels, dtype=jnp.int32))
    pixel = j_pixel(jnp.asarray(vol), jo, table_t, jnp.asarray(t.PIXEL_IDS, jnp.int32))
    return digest(vol, table, t.PIXEL_KW, t.PIXEL_IDS), dict(
        view_x=np.asarray(view[0]), view_y=np.asarray(view[1]),
        **{k: np.asarray(v) for k, v in zip(t.PIXEL_KEYS, pixel)})


def _parallel(what):
    """tests/test_torch_parallel.py's small frame (24x16, 16^3 gyroid) on the
    JAX package's 8-device CPU mesh, tiled (2 passes) or pass-sharded (8),
    or its render_accum over a ragged pixel range."""
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import render
    from raymarchcl_tpu.parallel import tiling

    t = _test("test_torch_parallel")
    vol, tables, jo, _ = t._small(8 if what == "spp-sharded" else 2)
    kw = dict(t.SMALL, iter=len(tables))
    args = jnp.asarray(vol), jo, jnp.asarray(tables)
    if what == "tiled":
        argb, acc = tiling.render_image_tiled(*args, mesh=tiling.make_mesh())
        return digest(vol, tables, kw), dict(argb=np.asarray(argb), acc=np.asarray(acc))
    if what == "spp-sharded":
        _, acc = tiling.render_image_spp_sharded(*args, mesh=tiling.make_mesh())
        return digest(vol, tables, kw), dict(acc=np.asarray(acc))
    ids, times = t.ragged_ids(jo.num_pixels)
    acc = render.render_accum(jnp.asarray(vol).reshape(-1), jo, jnp.asarray(tables),
                              jnp.asarray(times), jnp.zeros((len(ids), 3), jnp.float32),
                              jnp.asarray(ids))
    return digest(vol, tables, kw, ids, times), dict(acc=np.asarray(acc))


def _passes():
    """tests/test_torch_passes.py's SMALL frame (2 passes) through the JAX
    package's plain render_image."""
    t = _test("test_torch_passes")
    vol, tables = t.scene_inputs()
    return digest(vol, tables, t.SMALL), dict(acc=_frame(vol, t.SMALL, tables)["acc"])


def _fast_march(budget):
    """tests/test_torch_reflect.py's 24x16 `metal` frame: the JAX package's
    camera rays and its compiled march of them with the fast normal."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import camera, march, sampling as js
    from raymarchcl_tpu.options import render_options

    t = _test("test_torch_reflect")
    vol, kw = _gyroid(t.VRES), t.fast_march_kw(budget)
    table = np.array(js.generate_scatter_offsets(seed=3))
    n = kw["width"] * kw["height"]

    @jax.jit
    def jfn(o, v, table_t):
        st = js.init_render_state(o, table_t, jnp.arange(n, dtype=jnp.int32))
        p, d = camera.camera_ray_lookat(o, st)
        i = march.raymarch(v, o, p, d, o.maxDist, o.maxIter, smooth=False,
                           active=jnp.ones(n, bool))
        return p, d, st["px"], st["py"], i

    p, d, px, py, i = jfn(render_options(**kw), jnp.asarray(vol),
                          js.transpose_table(jnp.asarray(table)))
    return t, vol, table, kw, dict(
        p=_np3(p), d=_np3(d), px=np.asarray(px), py=np.asarray(py),
        **{f"isec_{k}": _np3(i[k]) if k in ("pos", "normal") else np.asarray(i[k])
           for k in ("object_id", "distance", "pos", "normal")})


def _reflect_fast_march(budget):
    _, vol, table, kw, answer = _fast_march(budget)
    return digest(vol, table, kw), answer


def _reflect_bounce(budget, mat):
    """One bounce's colour (basic_scene_color, compiled) from the first
    bounce of _fast_march's hits, formed as tests/test_torch_reflect.py
    forms it."""
    import jax
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import sampling as js, shade
    from raymarchcl_tpu.options import render_options

    t, vol, table, kw, ans = _fast_march(budget)
    to = t.render_options(**kw)
    fm = dict(table=table, to=to, d=t._tv(ans["d"]), px=t._t(ans["px"]), py=t._t(ans["py"]),
              want=t.jax_isec(ans))
    rays = t._bounce_rays(fm)
    r_dir, origin, act = rays
    col, isec = jax.jit(
        lambda o, v, tb, px, py, p, d, a: shade.basic_scene_color(v, o, tb, px, py, p, d, a))(
        render_options(**t.bounce_kw(mat, to)), jnp.asarray(vol),
        js.transpose_table(jnp.asarray(table)), jnp.asarray(fm["px"].numpy()),
        jnp.asarray(fm["py"].numpy()), origin, r_dir, act)
    return t.bounce_digest(vol, fm, mat, rays), dict(colour=_np3(col),
                                                     object_id=np.asarray(isec["object_id"]))


def _utils(what):
    """tests/test_torch_utils.py: the measured hit fraction of a camera
    (`hit-fraction-main-table`, ...) or the eager occupancy of the JAX
    camera's rays (`occupancy`), over the 32x32x96 gyroid."""
    import jax.numpy as jnp
    from raymarchcl_tpu.ops import accel, camera, sampling as js
    from raymarchcl_tpu.ops.vecmath import V3
    from raymarchcl_tpu.options import render_options
    from raymarchcl_tpu.utils import metrics, stats

    t = _test("test_torch_utils")
    vol = _gyroid(t.VRES)
    if what == "occupancy":
        jo, table = render_options(**t.OCCUPANCY), js.make_mc_tables(1, seed=0)[0]
        ids = jnp.arange(jo.num_pixels, dtype=jnp.int32)
        state = js.init_render_state(jo, js.transpose_table(table), ids)
        pos, rdir = (np.asarray(jnp.stack(v)) for v in camera.camera_ray_lookat(jo, state))
        occ = stats.raymarch_occupancy(jnp.asarray(vol), jo, V3(*jnp.asarray(pos)),
                                       V3(*jnp.asarray(rdir)), jo.maxDist, jo.maxIter,
                                       jnp.ones(jo.num_pixels, bool))
        return digest(vol, table, t.OCCUPANCY), dict(pos=pos, rdir=rdir, **{
            k: np.asarray(v) for k, v in occ.items()})
    _, cam, with_table = what.rsplit("-", 2)
    kw, table = t.hit_fraction_kw(cam), t.table0()
    jo = render_options(**kw)
    acc = accel.build_accel(vol, jo.voxelRes, jo.isoVal) if with_table == "table" else None
    more = [] if acc is None else [np.asarray(acc.rows)]
    return digest(vol, table, kw, *more), dict(hit_fraction=np.float64(
        metrics.measured_hit_fraction(jnp.asarray(vol), jo, jnp.asarray(table), acc)))


# -- the table ----------------------------------------------------------------

EXACT = 0.0
PARITY = 5e-3  # tests/test_parity.py:51, the accums' tolerance
MARCH = 1e-6  # distances, positions and colours of single rays
PIXEL_LEVEL = 1  # an 8-bit channel of an image the tests hold to mad < 0.15
REFLECTIVE = ("metal", "metal2", "orange-stripes")

# name: (recipe, {array: the tightest tolerance a test applies to it}); an
# array not named is held exactly. A packed uint32 image is compared by its
# 8-bit channels, a checkpoint file by its members.
ANSWERS = {
    **{f"fullsize-band-{m}": (partial(_fullsize_band, m), {"acc": 1e-5}) for m in ("ao", "metal")},
    **{f"reflect-frame-{m}": (partial(_reflect_frame, m), {"acc": PARITY}) for m in REFLECTIVE},
    **{f"codec-blobs-{f}": (partial(_codec_blobs, f), {"acc": PARITY}) for f in ("ao", "metal")},
    "cli-anim": (partial(_cli, "anim"), {"rgb": PIXEL_LEVEL}),
    "cli-preview": (partial(_cli, "preview"), {"argb": PIXEL_LEVEL}),
    "checkpoint-resume": (_checkpoint_resume, {"acc": PARITY}),
    **{f"checkpoint-pass-digest-{s}": (partial(_pass_digests, s), {}) for s in ("init", "anim")},
    "accel-frame": (partial(_accel, "frame"), {"acc": PARITY}),
    "accel-march-volume": (partial(_accel, "march-volume"), {}),
    "accel-primary": (partial(_accel, "primary"), {"distance": MARCH}),
    "accel-shadow": (partial(_accel, "shadow"), {}),
    **{f"march-{k}-{b}": (partial(_march, f"{k}-{b}"), {"distance": MARCH, "pos": MARCH,
                                                          "normal": MARCH})
       for k in ("primary", "shadow") for b in ("default", "reduced")},
    "march-iso-tests": (partial(_march, "iso-tests"), {}),
    "march-saturating-casts": (partial(_march, "saturating-casts"), {}),
    **{f"render-frame-{c}": (partial(_render, c), {"acc": PARITY, "argb": PIXEL_LEVEL})
       for c in ("ao-16x12-1spp-full", "ao-16x12-2spp")},
    "render-pixel-3531": (partial(_render, "pixel-3531"), {"distance": MARCH, "colour": MARCH}),
    "parallel-tiled": (partial(_parallel, "tiled"), {"acc": PARITY, "argb": np.inf}),
    "parallel-spp-sharded": (partial(_parallel, "spp-sharded"), {"acc": PARITY}),
    "parallel-pixel-range": (partial(_parallel, "pixel-range"), {"acc": PARITY}),
    "passes-frame": (_passes, {"acc": PARITY}),
    **{f"reflect-fast-march-{b}": (partial(_reflect_fast_march, b),
                                   {"isec_distance": MARCH, "isec_pos": MARCH})
       for b in ("default", "reduced")},
    **{f"reflect-bounce-{b}-{m}": (partial(_reflect_bounce, b, m), {"colour": PARITY})
       for b in ("default", "reduced") for m in REFLECTIVE},
    **{f"utils-hit-fraction-{c}-{t}": (partial(_utils, f"hit-fraction-{c}-{t}"), {})
       for c in ("main", "up") for t in ("raw", "table")},
    "utils-occupancy": (partial(_utils, "occupancy"), {}),
}


def _members(arrays):
    """The arrays `check` compares: a uint32 image as its bytes, an .npz
    file's bytes as its members."""
    out = {}
    for k, a in arrays.items():
        if k == "ckpt":
            with np.load(io.BytesIO(a.tobytes())) as z:
                out.update({f"{k}/{m}": z[m] for m in z.files})
        else:
            out[k] = a.view(np.uint8) if a.dtype == np.uint32 else a
    return out


def differences(name, got, want):
    """{array: (largest absolute difference, its tolerance)} of two answers
    of `name`; inf where shapes, dtypes or strings differ."""
    tol = ANSWERS[name][1]
    got, want = _members(got), _members(want)
    out = {}
    for k in sorted(set(got) | set(want)):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
            d = np.inf
        elif np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            d = 0.0
        elif a.dtype.kind in "US":
            d = np.inf
        else:
            d = float(np.nan_to_num(np.abs(a.astype(np.float64) - b.astype(np.float64)),
                                    nan=np.inf).max())
        out[k] = (d, tol.get(k.split("/")[0], EXACT))
    return out


def _versions():
    import jax
    import jaxlib

    return {"jax": jax.__version__, "jaxlib": jaxlib.__version__}


def run(names, write):
    """Compute each named answer; write it and its manifest entry, or (not
    `write`) write it to CHECK_DIR and compare it with the stored one.
    Returns the number of answers past their tolerance."""
    _jax_env()
    manifest, failed = _manifest(), 0
    out_dir = DIR if write else CHECK_DIR
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        t0 = time.perf_counter()
        key, arrays = ANSWERS[name][0]()
        secs = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{name}.npz")
        save_npz(path, **arrays)
        if write:
            manifest[name] = dict(sha256=sha256(path), inputs=key, seconds=round(secs, 1),
                                  **_versions())
            with open(MANIFEST, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"{name}: {secs:.1f} s -> {manifest[name]['sha256'][:16]}", flush=True)
            continue
        diffs = differences(name, arrays, load(name, key))
        past = {k: v for k, v in diffs.items() if v[0] > v[1]}
        failed += bool(past)
        same = sha256(path) == manifest[name]["sha256"]
        worst = max((d for d, _ in diffs.values()), default=0.0)
        print(f"{name}: {secs:.1f} s, sha256 {'equal' if same else 'differs'}, largest abs "
              f"difference {worst:.3g}{f', PAST TOLERANCE {past}' if past else ''}", flush=True)
    return failed


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ("regen", "check"):
        raise SystemExit(__doc__)
    unknown = set(sys.argv[2:]) - set(ANSWERS)
    if unknown:
        raise SystemExit(f"unknown answers: {sorted(unknown)}")
    sys.exit(1 if run(sys.argv[2:] or list(ANSWERS), sys.argv[1] == "regen") else 0)
