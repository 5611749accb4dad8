"""The port's kernel modules: K1 (tonemap + pack) and K2 (render pass).

On the CPU each wrapper runs its plain version; these tests hold K1's plain
version bit-equal to the JAX package's jnp pack and to its Pallas kernel in
interpret mode, check the wrappers' argument checks, the C parameter block's
layout and the nvcc build's error path, all without nvcc. The comparisons of
each kernel with its plain version on a GPU are in test_torch_cuda.py, which
imports no JAX."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.ops import render as j_render
from raymarchcl_tpu.ops.kernels.tonemap_pallas import tonemap_pack_pallas
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch import materials
from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel, render, sampling
from raymarchcl_tpu_torch.ops import shade
from raymarchcl_tpu_torch.ops.camera import compute_eyepos, view_scales
from raymarchcl_tpu_torch.ops.kernels import build
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)


def _pack_input():
    """tests/test_pallas.py's input plus the edge values."""
    rng = np.random.default_rng(0)
    acc = rng.uniform(-0.5, 30, (1000, 3)).astype(np.float32)
    extra = np.array([[0.0, 1e30, np.inf], [-1.5, np.nan, -np.inf], [1e-30, 255.0, -0.2]],
                     np.float32)
    return np.concatenate([acc, extra])


def test_k1_plain_bit_equal_to_jax_and_pallas():
    acc = _pack_input()
    opts = j_render_options(width=10, height=100, vres=8, iter=1, gamma=1.5)
    want_jnp = np.asarray(j_render.pack_argb(opts, jnp.asarray(acc)))  # jnp path on the CPU
    want_pallas = np.asarray(tonemap_pack_pallas(jnp.asarray(acc), 1.5, interpret=True))
    got = k1.tonemap_pack_plain(torch.from_numpy(acc), render_options(gamma=1.5).gamma)
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(got, want_pallas)
    assert [hex(v) for v in got[-3:-1]] == ["0xff00ff00", "0xffff0000"]


def test_k1_wrapper_cpu_and_checks():
    acc = torch.from_numpy(_pack_input())
    before = k1.LAUNCHES
    assert torch.equal(k1.tonemap_pack(acc, 1.5), k1.tonemap_pack_plain(acc, 1.5))
    assert k1.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError):
        k1.tonemap_pack(acc.double(), 1.5)
    with pytest.raises(ValueError):
        k1.tonemap_pack(acc[:, :2], 1.5)
    with pytest.raises(ValueError):
        k1.tonemap_pack(acc.t().contiguous().t(), 1.5)


@pytest.fixture(scope="module")
def small_scene():
    vres = [32, 32, 96]
    opts = render_options(width=8, height=6, vres=vres, iter=1, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0],
                          maxIter=32, maxVoxelIter=64, shadowIter=32)
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres}))
    table = sampling.make_mc_tables(1, seed=0)[0]
    return opts, vol, table


def test_k2_wrapper_cpu_in_place(small_scene):
    opts, vol, table = small_scene
    acc = torch.zeros((opts.num_pixels, 3))
    want = k2.render_pass_plain(vol, opts, table, acc.clone())
    before = k2.LAUNCHES
    out = k2.render_pass(vol, opts, table, acc)
    assert out is acc and torch.equal(acc, want) and k2.LAUNCHES == before
    assert float(acc.abs().sum()) > 0


def test_k2_wrapper_checks(small_scene):
    opts, vol, table = small_scene
    acc = torch.zeros((opts.num_pixels, 3))
    with pytest.raises(ValueError, match="vol"):
        k2.render_pass(vol[:-1], opts, table, acc)
    with pytest.raises(ValueError, match="table"):
        k2.render_pass(vol, opts, table[:100], acc)
    with pytest.raises(ValueError, match="accum"):
        k2.render_pass(vol, opts, table, acc[:-1])
    with pytest.raises(ValueError, match="accum"):
        k2.render_pass(vol, opts, table, acc.double())
    # a frame with reflections passes the wrapper's checks without raising;
    # on a CPU tensor the wrapper runs the plain version (no launch counted),
    # and the bounces change its accum. K2c itself is held against the plain
    # version in test_torch_cuda.py and chip_smoke.py.
    refl = opts.replace(reflectIter=1, mat_r0=torch.full((4,), 0.5))
    want = k2.render_pass_plain(vol, refl, table, acc.clone())
    before = (k2.LAUNCHES, k2.REFLECTIVE_LAUNCHES)
    assert torch.equal(k2.render_pass(vol, refl, table, acc.clone()), want)
    assert (k2.LAUNCHES, k2.REFLECTIVE_LAUNCHES) == before
    assert not torch.equal(want, k2.render_pass_plain(vol, refl.replace(reflectIter=0), table,
                                                      acc.clone()))
    bricks = accel.build_accel(vol, opts.voxelRes, opts.isoVal)
    with pytest.raises(ValueError, match="accel rows"):
        k2.render_pass(vol, opts, table, acc, accel.Accel(bricks.rows[:-1], 8))
    with pytest.raises(ValueError, match="accel rows"):
        k2.render_pass(vol, opts, table, acc, accel.Accel(bricks.rows.t().contiguous().t(), 8))
    with pytest.raises(ValueError, match="brick rows"):
        accel.Accel(bricks.rows.long(), 8)
    with pytest.raises(ValueError, match="brick rows"):
        accel.Accel(bricks.rows, 4)


def _c_struct_fields():
    src = open(os.path.join(build.CSRC_DIR, "rmcl_common.cuh")).read()
    body = re.search(r"struct RmclParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for name in names.split(","):
            m = re.fullmatch(r"(\w+)((?:\[\d+\])*)", name.strip())
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", m.group(2))]
            fields.append((m.group(1), ctype, int(np.prod(dims)) if dims else 1))
    return fields


def test_params_struct_mirrors_c_header():
    """The ctypes block the wrapper passes must match the C struct field
    for field (the CUDA side cannot be compiled here)."""
    import ctypes

    c_fields = _c_struct_fields()
    py_fields = []
    for name, ct in k2.RmclParams._fields_:
        n, base = 1, ct
        while hasattr(base, "_length_"):
            n *= base._length_
            base = base._type_
        py_fields.append((name, {ctypes.c_int: "int", ctypes.c_float: "float"}[base], n))
    assert py_fields == c_fields
    assert ctypes.sizeof(k2.RmclParams) == 4 * sum(n for _, _, n in c_fields)
    names = [name for name, _, _ in c_fields]
    assert ("gamma", "float", 1) in c_fields  # the fused pack's
    assert "aoTrunc" not in names and "aoD" not in names  # the probe table goes beside


def test_params_values(small_scene):
    opts, _, _ = small_scene
    p = k2.make_params(opts.replace(time=0.333))
    assert (p.width, p.height, p.rx, p.rz, p.rxy) == (8, 6, 32, 96, 1024)
    assert float(k2.pass_times([0.333])[0]) == float(np.float32(0.333))  # beside the block
    assert p.tableLen == opts.mcTableLength == 0x4000
    assert p.aoSteps == 32 and p.numLights == 1 and p.isoVal == 32
    assert p.marchScale == float(np.float32(1 / 32)) and p.invNumLights == 1.0
    assert p.gamma == float(np.float32(1.5)) == float(opts.gamma)
    assert list(p.lightColor[0]) == [50.0, 50.0, 50.0, 0.0]
    fov = np.float32(opts.fov)  # camera.view_coords' factors, float32 as the plain version's
    assert list(p.viewScale) == [float(fov * (np.float32(1) / np.float32(8))),
                                 float(fov * (np.float32(1) / np.float32(6)))]
    assert p.viewHalf == float(fov * np.float32(0.5))
    assert (p.edge, p.brickShift, p.nbx, p.nby, p.rowWords) == (0, 0, 0, 0, 0)
    bricks = accel.build_accel(np.zeros(32 * 32 * 96, np.uint8), opts.voxelRes, 32, edge=16)
    p = k2.make_params(opts, bricks)
    assert (p.edge, p.brickShift, p.nbx, p.nby, p.rowWords) == (16, 4, 2, 2, 130)
    k2.make_params(opts.replace(aoIter=16))  # any aoIter: the probe table goes beside
    with pytest.raises(ValueError, match="numLights"):
        k2.make_params(opts.replace(numLights=5))
    with pytest.raises(ValueError, match="aoIter"):
        k2.make_params(opts.replace(aoIter=-1))
    with pytest.raises(ValueError, match="mat_r0"):  # the block's floats are copied raw
        k2.make_params(opts.replace(mat_r0=torch.zeros(3)))
    with pytest.raises(ValueError, match="lightPos"):
        k2.make_params(opts.replace(lightPos=opts.lightPos.t()))


def _params_field_by_field(opts, bricks=None, pix_lo=0, pix_count=None):
    """The parameter block built field by field from the options, as each
    launch built it before its static part was kept across frames: the
    oracle of make_params' bytes."""
    f32 = np.float32
    p = k2.RmclParams()
    p.width, p.height = opts.resolution
    p.rx, p.ry, p.rz, p.rxy = opts.voxelRes
    for k in ("maxIter", "maxVoxelIter", "shadowIter", "aoIter", "numLights", "isoVal",
              "reflectIter"):
        setattr(p, k, getattr(opts, k))
    p.tableLen = opts.mcTableLength
    if bricks is not None:
        p.edge, p.brickShift = bricks.edge, bricks.edge.bit_length() - 1
        p.nbx, p.nby, _ = accel.brick_dims(opts.voxelRes, bricks.edge)
        p.rowWords = accel.row_words(bricks.edge)
    p.aoSteps = opts.maxVoxelIter // 2
    p.pixLo, p.pixCount = k2.pixel_range(opts, pix_lo, pix_count)
    p.marchScale = float(f32(1.0 / (opts.maxVoxelIter * 0.5)))
    p.aoScale = float(f32(1.0 / (p.aoSteps * 0.5)))
    f_min = min(a * b for a, b in zip(opts.invVoxelScale, opts.voxelBounds2))
    p.shadowBaseStep = float(f32((2.0 / opts.maxVoxelIter) * f_min))
    p.invNumLights = float(f32(1.0) / f32(opts.numLights))
    p.voxelSize = float(f32(opts.voxelSize))
    for dst, src in (("bmin", opts.voxelBoundsMin), ("bmax", opts.voxelBoundsMax),
                     ("vb", opts.voxelBounds), ("vb2", opts.voxelBounds2),
                     ("invS", opts.invVoxelScale), ("eyePos", opts.eyePos),
                     ("targetPos", opts.targetPos), ("up", opts.up),
                     ("sky1", opts.skyColor1), ("sky2", opts.skyColor2)):
        getattr(p, dst)[:] = [float(v) for v in np.asarray(src, np.float32)]
    for k in ("invAspect", "fov", "maxDist", "startDist", "eps", "aoAmp",
              "groundY", "shadowBias", "lightScatter", "minLightAtt", "exposure",
              "dof", "frameBlend", "fogPow", "flareAmp", "gamma"):
        setattr(p, k, float(getattr(opts, k)))
    for dst, src in (("lightPos", opts.lightPos), ("lightColor", opts.lightColor),
                     ("matAlbedo", opts.mat_albedo)):
        rows = src.numpy()
        for r in range(4):
            getattr(p, dst)[r][:] = [float(v) for v in rows[r]]
    sx, sy, p.viewHalf = view_scales(opts)
    p.viewScale[:] = [sx, sy]
    p.matR0[:] = [float(v) for v in opts.mat_r0.numpy()]
    p.matSmooth[:] = [float(v) for v in opts.mat_smoothness.numpy()]
    return bytes(p)


def _scene_opts(mat="ao", eye=compute_eyepos(135, 2.25, 0.35), **kw):
    """small_scene's options with another preset or eye, built afresh as a
    frame builds them."""
    return render_options(width=8, height=6, vres=[32, 32, 96], iter=2, mat=mat, eyepos=eye,
                          targetpos=[0, -0.4, 0], maxIter=32, maxVoxelIter=64, shadowIter=32,
                          **kw)


def _bricks(edge):
    return accel.build_accel(np.zeros(32 * 32 * 96, np.uint8), (32, 32, 96, 1024), 32,
                             edge=edge)


@pytest.mark.parametrize("edge", [None, 8, 16])
@pytest.mark.parametrize("mat", [m for m in materials.PRESETS if not m.startswith(":")])
def test_params_bytes_equal_field_by_field(mat, edge):
    """make_params' block is byte-equal to the one built field by field,
    for every preset, without and with a brick table, over the whole frame
    and over a band's pixel range (ending in pad rows), at aoIter 0/5/16/20
    and 1 or 2 lights."""
    bricks = None if edge is None else _bricks(edge)
    base = _scene_opts(mat)
    n = base.num_pixels
    for ao_iter in (0, 5, 16, 20):
        for lights in (1, 2):
            opts = base.replace(aoIter=ao_iter, numLights=lights)
            for lo, count in ((0, None), (n // 3, n - n // 3 + 2)):
                assert (bytes(k2.make_params(opts, bricks, lo, count))
                        == _params_field_by_field(opts, bricks, lo, count))


FIELD_CHANGES = {
    "eyePos": {"eyePos": [0.25, 1.5, -2.0]},
    "time": {"time": 7.0},  # goes beside the block: the bytes stay
    "fov": {"fov": 1.1},
    "exposure": {"exposure": 2.25},
    "lightColor": {"lightColor": np.eye(4, dtype=np.float32) * 9},
    "isoVal": {"isoVal": 40},
    "resolution": {"resolution": (12, 5)},
}


@pytest.mark.parametrize("field", list(FIELD_CHANGES))
def test_params_follow_a_changed_field(field):
    """After a frame has built and kept its static part, a frame with one
    field changed gets the bytes built field by field for it: no kept part
    goes stale, whether the field is per-frame or static."""
    bricks = _bricks(8)
    base = _scene_opts("metal")
    want_base = _params_field_by_field(base, bricks, 5, 30)
    assert bytes(k2.make_params(base, bricks, 5, 30)) == want_base
    changed = base.replace(**FIELD_CHANGES[field])
    want = _params_field_by_field(changed, bricks, 5, 30)
    assert bytes(k2.make_params(changed, bricks, 5, 30)) == want
    assert (want == want_base) == (field == "time")
    assert bytes(k2.make_params(base, bricks, 5, 30)) == want_base


def test_plan_counters_engage(monkeypatch):
    """Over a ring of 12 poses built afresh, the static part is built once
    and reused 11 times, and the block beside it holds the same bytes at
    every pose; another preset builds a second one."""
    monkeypatch.setattr(k2, "_PLANS", {})
    builds, hits = k2.PLAN_BUILDS, k2.PLAN_HITS
    times = k2.pass_times(render.default_times(16))
    assert times is render.default_times(16)  # no copy per frame
    blocks = set()
    for i in range(12):
        opts = _scene_opts(eye=compute_eyepos(30 * i, 2.25, 0.35))
        assert bytes(k2.make_params(opts)) == _params_field_by_field(opts)
        blocks.add(k2.launch_block(opts, times).numpy().tobytes())
    assert (k2.PLAN_BUILDS - builds, k2.PLAN_HITS - hits) == (1, 11)
    assert len(blocks) == 1
    k2.make_params(_scene_opts("metal"))
    assert (k2.PLAN_BUILDS - builds, k2.PLAN_HITS - hits) == (2, 11)


@pytest.mark.parametrize("ao_iter", [0, 5, 16, 20])
def test_launch_block_ao_probes(small_scene, ao_iter):
    """The block that goes beside the parameter block: the pass times as
    float32, then per AO probe i <= aoIter shade.ao_step_dist and
    shade.ao_trunc_steps, at aoIter below, at and above the old cap of 16
    probes."""
    opts, _, _ = small_scene
    opts = opts.replace(aoIter=ao_iter)
    times = k2.pass_times([0.0, 0.333, 0.666])
    block = k2.launch_block(opts, times)
    n = ao_iter + 1
    assert block.dtype == torch.int32 and block.shape == (3 + 2 * n,)
    assert torch.equal(block[:3].view(torch.float32), times)
    dist, cap = block[3:3 + n].view(torch.float32), block[3 + n:]
    for i in range(n):
        assert dist[i].item() == float(shade.ao_step_dist(opts, i))
        assert cap[i].item() == shade.ao_trunc_steps(opts, opts.maxVoxelIter // 2, i)
    assert cap.max() <= opts.maxVoxelIter // 2 and k2.make_params(opts).aoIter == ao_iter


def test_build_reports_nvcc_failure(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: error: no GPU toolchain' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no GPU toolchain"):
        build.build()
    assert len(build.source_hash()) == 16
    assert {os.path.basename(s) for s in build._sources()} >= {
        "tonemap.cu", "render_pass.cu", "prims.cu", "rmcl_common.cuh"}


def test_build_keeps_its_log_for_cached_runs(tmp_path, monkeypatch):
    """A build writes nvcc's log beside the library; a later build of the
    same sources reads it back, so the ptxas report is the same either way."""
    fake = tmp_path / "nvcc"
    # writes the file after -o and prints a ptxas-like line
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 80 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(build, "build_info", {})
    path = build.build()
    first = dict(build.build_info)
    assert first["cached"] is False and first["path"] == path
    assert "Used 80 registers" in first["log"]
    assert open(os.path.join(os.path.dirname(path), build.LOG_NAME)).read() == first["log"]
    build.build_info.clear()
    assert build.build() == path
    assert build.build_info["cached"] is True and build.build_info["log"] == first["log"]
    # a library without its log is built again
    os.remove(os.path.join(os.path.dirname(path), build.LOG_NAME))
    build.build()
    assert build.build_info["cached"] is False and build.build_info["log"] == first["log"]
