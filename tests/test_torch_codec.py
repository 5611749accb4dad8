"""The port's TRenderOpts codec (options_codec.py) and blob replay
(compat.py) against the JAX package's: the same layout, the same bytes
from the same `render_options(...)` call, and frames rendered from the same
blobs, volume and MC tables within the port's parity tolerance."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax_answers
from raymarchcl_tpu import compat as j_compat
from raymarchcl_tpu import options_codec as j_codec
from raymarchcl_tpu.io import imageio as j_imageio
from raymarchcl_tpu.models import generators
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.ops.camera import compute_eyepos
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch import compat as t_compat
from raymarchcl_tpu_torch import options_codec as t_codec
from raymarchcl_tpu_torch.convert import volume_from_numpy
from raymarchcl_tpu_torch.ops import render as t_render
from raymarchcl_tpu_torch.ops import sampling as t_sampling
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51
CAM = dict(eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
OPTION_CASES = {
    **{f"preset-{m}": dict(mat=m) for m in ("ao", "metal", "metal2", "orange-stripes")},
    "dof-fog-time": dict(mat="metal2", dof=0.025, fogPow=0.1, t=0.999, iter=7, width=80,
                         height=45, vres=[24, 32, 48], **CAM),
    "two-lights-budgets": dict(mat="ao", numLights=2, lightPos=[[1, 2, 3, 0], [-2, 0.5, 1, 0]],
                               lightColor=[[5, 6, 7, 0], [1, 1, 1, 0]], maxIter=24,
                               aoIter=3, gamma=2.2, groundY=0.9, fov=115),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_encode_bytes_equal(case):
    kw = OPTION_CASES[case]
    blob = t_codec.encode(render_options(**kw))
    assert len(blob) == t_codec.struct_size()
    assert blob == j_codec.encode(j_render_options(**kw))


def test_layout_equal():
    assert t_codec.layout() == j_codec.layout()
    assert t_codec.struct_size() == j_codec.struct_size() == t_codec.layout()[1]


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_decode_roundtrip(case):
    o = render_options(**OPTION_CASES[case])
    blob = t_codec.encode(o)
    d = t_codec.decode(blob)
    assert d == j_codec.decode(blob)
    assert d["resolution"] == list(o.resolution) and d["voxelRes"] == list(o.voxelRes)
    assert d["time"] == float(o.time) and d["fov"] == float(o.fov)
    assert d["lightPos"] == o.lightPos.tolist()
    assert [m["r0"] for m in d["materials"]] == o.mat_r0.tolist()
    with pytest.raises(ValueError, match="bytes"):
        t_codec.decode(blob[:-1])


def test_uchar_fields_do_not_corrupt_neighbors():
    o = render_options(iter=1, mat="ao", isoVal=255)
    blob = t_codec.encode(o)
    assert blob == j_codec.encode(j_render_options(iter=1, mat="ao", isoVal=255))
    d = t_codec.decode(blob)
    assert d["isoVal"] == 255 and d["numLights"] == 1 and d["mcTableLength"] == 0x4000
    assert t_codec.decode(t_codec.encode(render_options(iter=1, isoVal=256 + 7)))["isoVal"] == 7


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_opts_from_blob_fields(case):
    """Every field of the port's opts_from_blob equals the JAX one's and
    encodes back to the same bytes."""
    blob = t_codec.encode(render_options(**OPTION_CASES[case]))
    got, want = t_compat.opts_from_blob(blob), j_compat.opts_from_blob(blob)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.float32 and a.device.type == "cpu", f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name
    assert t_codec.encode(got) == blob


def test_opts_from_blob_defaults_table_length():
    blob = bytearray(t_codec.encode(render_options(width=80, height=45, vres=32, iter=4,
                                                   mat="orange-stripes")))
    off = {n: o for n, _, _, o in t_codec.layout()[0]}["mcTableLength"]
    blob[off:off + 4] = bytes(4)  # a reference blob that leaves the length 0
    o = t_compat.opts_from_blob(bytes(blob))
    assert o.mcTableLength == 0x4000 and o.reflectIter == 1 and o.numLights == 2
    assert o.resolution == (80, 45) and math.isclose(float(o.frameBlend), 0.25)


VRES = [24, 24, 48]
# ao at 24x16, 2 passes; metal at 10x8, 1 pass, with one bounce: the JAX
# package unrolls its bounce loop, so each bounce adds to its compile time
# (its three are held at 10x8 in test_torch_reflect_frame.py)
FRAMES = {
    "ao": dict(width=24, height=16, iter=2, mat="ao", maxIter=24, maxVoxelIter=48,
               shadowIter=24),
    "metal": dict(width=10, height=8, iter=1, mat="metal", reflectIter=1, maxIter=24,
                  maxVoxelIter=48, shadowIter=24),
}


@pytest.fixture(scope="module")
def vol():
    return generators.make_gyroid_volume({"vres": VRES})


def blob_inputs(frame):
    """The blobs of a frame (one per pass, differing in time), its MC tables
    and its options keywords."""
    kw = dict(FRAMES[frame], vres=VRES, **CAM)
    blobs = [j_codec.encode(j_render_options(t=i * 0.333, **kw)) for i in range(kw["iter"])]
    return blobs, np.asarray(js.make_mc_tables(kw["iter"], seed=3)), kw


def blob_digest(vol, blobs, tables, kw):
    return jax_answers.digest(vol, tables, kw, np.frombuffer(b"".join(blobs), np.uint8))


@pytest.fixture(scope="module", params=sorted(FRAMES))
def jax_blob_frame(request, vol):
    """A frame's blobs and MC tables, and the JAX render_from_blobs over them
    (its brick table gives the same image as none), from tests/jax_answers."""
    blobs, tables, kw = blob_inputs(request.param)
    return dict(blobs=blobs, tables=tables, kw=kw, **jax_answers.load(
        f"codec-blobs-{request.param}", blob_digest(vol, blobs, tables, kw)))


@pytest.mark.parametrize("accel", [True, False])
def test_render_from_blobs_matches_jax(vol, jax_blob_frame, accel):
    f = jax_blob_frame
    assert t_compat.opts_from_blob(f["blobs"][0]).reflectIter == f["kw"].get("reflectIter", 0)
    argb, acc = t_compat.render_from_blobs(f["blobs"], vol, f["tables"], accel=accel,
                                           device="cpu")
    acc = acc.numpy()
    assert argb.shape == f["argb"].shape and argb.dtype == np.uint32
    ok = np.isclose(acc, f["acc"], **TOL).all(axis=1)
    assert ok.mean() >= 0.995, f"{(~ok).sum()}/{ok.size} pixels diverged"
    d = np.abs(j_imageio.argb_to_rgba(argb)[..., :3].astype(int)
               - j_imageio.argb_to_rgba(f["argb"])[..., :3].astype(int))
    assert d.mean() < 0.15 and (d > 8).mean() < 0.005, (d.mean(), (d > 8).mean())
    same = (acc == f["acc"]).all(axis=1)
    np.testing.assert_array_equal(argb.reshape(-1)[same], f["argb"].reshape(-1)[same])


def test_render_from_blobs_continues_accum_and_needs_card(vol, monkeypatch):
    """An accum passed in (numpy) is blended on, as render_image blends
    the blobs' options and times on it; without a card the default device
    raises instead of rendering on the CPU."""
    kw = dict(FRAMES["ao"], vres=VRES, **CAM)
    opts = [render_options(t=i * 0.333, **kw) for i in range(2)]
    blobs = [t_codec.encode(o) for o in opts]
    tables = t_sampling.make_mc_tables(2, seed=3)
    _, acc1 = t_compat.render_from_blobs(blobs, vol, tables.numpy(), device="cpu")
    argb2, acc2 = t_compat.render_from_blobs(blobs, vol, tables, accum=acc1.numpy(),
                                             device="cpu")
    want_argb, want = t_render.render_image(volume_from_numpy(vol), opts[0], tables,
                                            times=torch.stack([o.time for o in opts]),
                                            accum=acc1.clone())
    assert not torch.equal(acc2, acc1)
    assert torch.equal(acc2, want)
    np.testing.assert_array_equal(argb2, want_argb)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_compat.render_from_blobs(blobs, vol, np.asarray(tables))
