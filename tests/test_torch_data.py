"""Volumes and I/O of the PyTorch port against the JAX package: generated
volumes byte-equal, `.vox` files byte-identical, ARGB unpacking equal."""

import numpy as np
import pytest
import torch

from raymarchcl_tpu.io import imageio as j_imageio
from raymarchcl_tpu.io import voxio as j_voxio
from raymarchcl_tpu.models import generators as j_gen
from raymarchcl_tpu_torch import api
from raymarchcl_tpu_torch.convert import tables_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.io import imageio, voxio
from raymarchcl_tpu_torch.models import generators

torch.set_num_threads(1)


@pytest.mark.parametrize("vres", [[32, 32, 32], [48, 48, 48], [32, 32, 96]])
def test_gyroid_byte_equal(vres):
    got = generators.make_gyroid_volume({"vres": vres})
    want = np.asarray(j_gen.make_gyroid_volume({"vres": vres}))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if vres[2] > 32:  # z-slicing leaves z < 32 empty (generators.clj:35)
        assert 0 < (got > 32).mean() < 1


def test_gyroid_slabbing_is_invisible():
    np.testing.assert_array_equal(
        generators.make_gyroid_volume([32, 32, 96], slab=5),
        generators.make_gyroid_volume([32, 32, 96]))


def test_terrain_byte_equal():
    got = generators.make_terrain({"vres": [40, 40, 40]})
    np.testing.assert_array_equal(got, np.asarray(j_gen.make_terrain({"vres": [40, 40, 40]})))


def test_vox_bytes_identical(tmp_path):
    vol = generators.make_gyroid_volume([32, 32, 96])
    p_port, p_jax = tmp_path / "port.vox", tmp_path / "jax.vox"
    voxio.save_volume(str(p_port), (32, 32, 96), vol)
    j_voxio.save_volume(str(p_jax), (32, 32, 96), vol)
    assert p_port.read_bytes() == p_jax.read_bytes()
    back, res = voxio.load_volume(str(p_jax))
    assert res == (32, 32, 96)
    np.testing.assert_array_equal(back, vol)
    (tmp_path / "bad.vox").write_bytes(b"NOPE!" + bytes(20))
    with pytest.raises(ValueError, match="bad magic"):
        voxio.load_volume(str(tmp_path / "bad.vox"))


def test_default_volume_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(api, "VOLUME_CACHE_DIR", str(tmp_path))
    vol, res = api.default_volume(16)
    assert res == (16, 16, 16) and (tmp_path / "gyroid-16x16x16.vox").is_file()
    cached, res2 = api.default_volume(16)
    assert res2 == (16, 16, 16)
    np.testing.assert_array_equal(cached, vol)


def test_argb_to_rgba_equal(tmp_path):
    rng = np.random.default_rng(0)
    argb = rng.integers(0, 2**32, size=(12, 16), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(imageio.argb_to_rgba(argb), j_imageio.argb_to_rgba(argb))
    imageio.save_png(argb, str(tmp_path / "x.png"))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")),
                                  imageio.argb_to_rgba(argb))


def test_convert_helpers():
    vol = volume_from_numpy(np.arange(24, dtype=np.uint8).reshape(2, 3, 4))
    assert vol.dtype == torch.uint8 and vol.shape == (24,)
    tab = tables_from_numpy(np.zeros((2, 8, 4), np.float64))
    assert tab.dtype == torch.float32 and tab.shape == (2, 8, 4)
    with pytest.raises(ValueError):
        tables_from_numpy(np.zeros((8, 3)))
