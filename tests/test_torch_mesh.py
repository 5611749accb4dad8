"""The port's mesh module (models/mesh.py) against the JAX package's, byte
for byte: STL reading, the fit-to-grid transform, the three voxelizers and
the heatmap volumes. The JAX functions take their native C++ path when
its library loads and numpy otherwise; the port's numpy must equal
whichever they take."""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from raymarchcl_tpu.io import voxio as j_voxio
from raymarchcl_tpu.models import mesh as jm
from raymarchcl_tpu_torch.io import imageio as t_imageio
from raymarchcl_tpu_torch.io import voxio as t_voxio
from raymarchcl_tpu_torch.models import mesh as tm

TREFOIL = os.path.join(os.path.dirname(__file__), "..", "assets", "trefoil.stl")


def write_binary_stl(path, tris):
    tris = np.asarray(tris, np.float32)
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(np.zeros(3, np.float32).tobytes())  # normal
            f.write(t.astype("<f4").tobytes())
            f.write(struct.pack("<H", 0))


@pytest.fixture(scope="module")
def trefoil():
    return jm.read_stl(TREFOIL)


def test_read_stl_binary(tmp_path):
    rng = np.random.default_rng(0)
    tris = rng.uniform(-2, 3, (40, 3, 3)).astype(np.float32)
    tris[5] = tris[3]  # repeated vertices collapse to unique ones
    p = tmp_path / "r.stl"
    write_binary_stl(p, tris)
    got, want = tm.read_stl(p), jm.read_stl(p)
    assert got.dtype == np.float32 and got.shape == want.shape == (117, 3)
    np.testing.assert_array_equal(got, want)
    with open(p, "r+b") as f:  # a triangle count past the body: truncated
        f.seek(80)
        f.write(struct.pack("<I", 41))
    with pytest.raises(ValueError, match="truncated"):
        tm.read_stl(p)


def test_read_stl_ascii(tmp_path):
    p = tmp_path / "t.stl"
    p.write_text(
        "solid t\n facet normal 0 0 1\n  outer loop\n"
        "   vertex 0 0 0\n   vertex 1.5 0 0\n   vertex 0 2 0\n"
        "  endloop\n endfacet\n facet normal 0 1 0\n  outer loop\n"
        "   vertex 0 0 0\n   vertex -1.25 0.5 3e-1\n   vertex 0 2 0\n"
        "  endloop\n endfacet\nendsolid t\n")
    got = tm.read_stl(p)
    assert got.shape == (4, 3)
    np.testing.assert_array_equal(got, jm.read_stl(p))
    e = tmp_path / "e.stl"
    e.write_text("solid e\n facet normal 0 0 1\n endfacet\nendsolid e\n")
    with pytest.raises(ValueError, match="no vertices"):
        tm.read_stl(e)


def test_read_stl_trefoil(trefoil):
    got = tm.read_stl(TREFOIL)
    assert got.shape == (18000, 3)
    np.testing.assert_array_equal(got, trefoil)
    assert tm.load_mesh is tm.read_stl


@pytest.mark.parametrize("res", [32, 64])
def test_mesh_scale(trefoil, res):
    pts = np.concatenate([trefoil[:100], [[0.0, 0.0, 0.0], [1.0, -2.0, 3.0]]])
    np.testing.assert_array_equal(tm.mesh_scale(trefoil, res)(pts),
                                  jm.mesh_scale(trefoil, res)(pts))


@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("mode", ["point", "ks1", "ks2", "scatter0", "scatter3"])
def test_voxelizers_byte_equal(trefoil, mode, res):
    if mode == "point":
        got, want = tm.voxelize(trefoil, res), jm.voxelize(trefoil, res)
    elif mode.startswith("ks"):
        ks = int(mode[2:])
        got, want = tm.voxelize_ks(trefoil, res, ks), jm.voxelize_ks(trefoil, res, ks)
    else:
        seed = int(mode[7:])
        got = tm.voxelize_scatter(trefoil, res, seed=seed)
        want = jm.voxelize_scatter(trefoil, res, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (res**3,)
    assert (got > 0).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_voxelize_scatter_seeds_differ(trefoil):
    a = tm.voxelize_scatter(trefoil, 32, seed=0)
    assert not np.array_equal(a, tm.voxelize_scatter(trefoil, 32, seed=3))
    assert set(np.unique(a)) == {0, 64}


def test_scatter_draws_equal():
    for seed, nv in ((0, 5), (3, 17), (2**63 + 11, 3)):
        np.testing.assert_array_equal(tm._scatter_draws(seed, nv), jm._scatter_draws(seed, nv))


def _gray(res):
    yy, xx = np.mgrid[0:res, 0:res]
    g = ((np.sin(xx * 0.4) * np.cos(yy * 0.3) * 0.5 + 0.5) * 250).astype(np.uint8)
    g[0, :4] = [0, 225, 224, 255]  # the h = 0 / h = 2 branches
    return g


def test_make_heatmap_from_array():
    for res, amp in ((32, 0.15), (24, 0.011)):
        g = _gray(res)
        got = tm.make_heatmap(g, amp, res=res)
        np.testing.assert_array_equal(got, jm.make_heatmap(g, amp, res=res))
    np.testing.assert_array_equal(tm.make_heatmap(_gray(16), 0.2),
                                  jm.make_heatmap(_gray(16), 0.2))


def test_make_heatmap_from_png(tmp_path):
    rgb = np.zeros((20, 20, 3), np.uint8)
    rgb[..., 2] = _gray(20)
    rgb[..., 0] = 77  # only the low byte (blue) counts
    p = str(tmp_path / "h.png")
    Image.fromarray(rgb).save(p)
    np.testing.assert_array_equal(t_imageio.load_gray(p), rgb[..., 2])
    np.testing.assert_array_equal(tm.make_heatmap(p, 0.1), jm.make_heatmap(p, 0.1))


def test_make_heatmap_anim(tmp_path):
    rgb = np.zeros((16, 16, 3), np.uint8)
    rgb[..., 2] = _gray(16)
    p = str(tmp_path / "h.png")
    Image.fromarray(rgb).save(p)
    got = tm.make_heatmap_anim(p, str(tmp_path / "t-%02d.vox"), 2, res=16)
    want = jm.make_heatmap_anim(p, str(tmp_path / "j-%02d.vox"), 2, res=16)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        va, ra = t_voxio.load_volume(a)
        vb, rb = j_voxio.load_volume(b)
        assert ra == rb == (16, 16, 16)
        np.testing.assert_array_equal(va, vb)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


GOLDEN_BUDGETS = dict(maxIter=32, maxVoxelIter=64, shadowIter=32)  # tests/test_goldens.py


def _golden_volume(kind, vres):
    if kind == "heatmap":  # tests/test_goldens.py's synthetic gray image
        yy, xx = np.mgrid[0:vres, 0:vres]
        gray = ((np.sin(xx * 0.4) * np.cos(yy * 0.3) * 0.5 + 0.5) * 200).astype(np.uint8)
        return tm.make_heatmap(gray, amp=0.15, res=vres)
    return tm.voxelize_scatter(tm.read_stl(TREFOIL), vres, seed=3)


@pytest.mark.parametrize("name,kind,mat,theta", [
    ("heatmap-orange", "heatmap", "orange-stripes", 45), ("scatter-metal", "scatter", "metal", 135)])
def test_mesh_volume_goldens(name, kind, mat, theta):
    """The goldens on the port's mesh volumes, rendered through
    api.render_frame on the CPU at tests/test_goldens.py's budgets, seed
    and thresholds (mad < 0.15, frac_off8 < 0.5%)."""
    from raymarchcl_tpu_torch import api
    from raymarchcl_tpu_torch.ops.camera import compute_eyepos

    argb, _ = api.render_frame(
        _golden_volume(kind, 32), (32,) * 3, seed=7, device="cpu", width=48, height=32,
        iter=1, mat=mat, eyepos=compute_eyepos(theta, 2.25, 0.35), targetpos=[0, -0.4, 0],
        **GOLDEN_BUDGETS)
    path = os.path.join(os.path.dirname(__file__), "goldens", f"{name}.png")
    want = np.asarray(Image.open(path).convert("RGBA")).astype(np.int32)
    got = t_imageio.argb_to_rgba(argb).astype(np.int32)
    d = np.abs(got[..., :3] - want[..., :3])
    assert d.mean() < 0.15 and (d > 8).mean() < 0.005, (d.mean(), (d > 8).mean())
