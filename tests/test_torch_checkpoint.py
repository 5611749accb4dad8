"""The port's checkpoint/resume (io/checkpoint.py), mirroring
tests/test_checkpoint.py on the CPU: chunked and resumed renders are
bit-equal to uninterrupted ones, and the file format and pass digest are
the JAX package's, so a checkpoint the JAX package wrote resumes here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchcl_tpu.io import checkpoint as j_ckpt
from raymarchcl_tpu.ops import render as j_render
from raymarchcl_tpu.ops import sampling as js
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu_torch.convert import volume_from_numpy
from raymarchcl_tpu_torch.io import checkpoint
from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import render as render_mod
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
from raymarchcl_tpu_torch.options import render_options

torch.set_num_threads(1)

TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_parity.py:51
VRES = [16, 16, 48]
KW = dict(width=24, height=16, vres=VRES, iter=5, mat="ao", maxIter=16, maxVoxelIter=32,
          shadowIter=16, eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])


@pytest.fixture(scope="module")
def scene():
    vol_np = generators.make_gyroid_volume({"vres": VRES})
    return vol_np, render_options(**KW), make_mc_tables(5, seed=2)


@pytest.fixture(scope="module")
def straight(scene):
    vol_np, opts, tables = scene
    return render_mod.render_image(volume_from_numpy(vol_np), opts, tables)


def test_save_load_roundtrip(tmp_path, scene):
    _, opts, _ = scene
    accum = np.random.default_rng(0).random((opts.num_pixels, 3)).astype(np.float32)
    p = checkpoint.save_accum(tmp_path / "ck", torch.from_numpy(accum), opts, passes_done=3,
                              seed=2)
    assert p.endswith(".npz")
    loaded, meta = checkpoint.load_accum(tmp_path / "ck", opts)
    np.testing.assert_array_equal(loaded, accum)
    assert meta["passes_done"] == 3 and meta["seed"] == 2
    assert meta["format"] == "raymarchcl_tpu/accum/v1"
    # the JAX package reads it, and the port reads the JAX package's
    j_loaded, j_meta = j_ckpt.load_accum(p)
    np.testing.assert_array_equal(j_loaded, accum)
    assert j_meta == meta
    q = j_ckpt.save_accum(tmp_path / "j", accum, j_render_options(**KW), 4, seed=None,
                          digest="ab")
    loaded, meta = checkpoint.load_accum(q, opts)
    np.testing.assert_array_equal(loaded, accum)
    assert (meta["passes_done"], meta["seed"], meta["digest"]) == (4, None, "ab")


def test_load_refuses_other_resolution_and_format(tmp_path, scene):
    _, opts, _ = scene
    p = checkpoint.save_accum(tmp_path / "ck", np.zeros((opts.num_pixels, 3), np.float32),
                              opts, 1)
    with pytest.raises(ValueError, match="checkpoint is"):
        checkpoint.load_accum(p, render_options(width=8, height=8, vres=16, iter=1))
    np.savez_compressed(tmp_path / "other.npz", accum=np.zeros(3, np.float32), meta="{}")
    with pytest.raises(ValueError, match="not an accumulation checkpoint"):
        checkpoint.load_accum(tmp_path / "other")


def test_chunked_equals_straight(tmp_path, scene, straight):
    vol_np, opts, tables = scene
    argb_1, accum_1 = straight
    seen = []
    argb_c, accum_c = checkpoint.render_checkpointed(
        vol_np, opts, tables, tmp_path / "ck", chunk=2, device="cpu",
        progress=lambda done, total: seen.append((done, total)))
    assert seen == [(2, 5), (4, 5), (5, 5)]
    np.testing.assert_array_equal(argb_c, argb_1)
    assert torch.equal(accum_c, accum_1)
    _, meta = checkpoint.load_accum(tmp_path / "ck", opts)
    assert meta["passes_done"] == 5
    assert meta["digest"] == checkpoint.pass_digest(
        tables, torch.arange(5, dtype=torch.float32) * render_mod.TIME_STEP_INIT)


def test_resume_after_interrupt(tmp_path, scene, straight):
    vol_np, opts, tables = scene
    seen = []

    def stop_after_two_chunks(done, total):
        seen.append(done)
        if done >= 4:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        checkpoint.render_checkpointed(vol_np, opts, tables, tmp_path / "ck", chunk=2,
                                       device="cpu", progress=stop_after_two_chunks)
    assert seen == [2, 4]
    seen.clear()
    argb_r, accum_r = checkpoint.render_checkpointed(
        vol_np, opts, tables, tmp_path / "ck", chunk=2, device="cpu",
        progress=lambda done, total: seen.append(done))
    assert seen == [5]  # one chunk left
    np.testing.assert_array_equal(argb_r, straight[0])
    assert torch.equal(accum_r, straight[1])


def test_fully_resumed_packs_loaded_state(tmp_path, scene, straight, monkeypatch):
    """A checkpoint holding every pass renders nothing more: the loaded
    accum is packed once through render.pack_argb (K1 alone on a card)."""
    vol_np, opts, tables = scene
    checkpoint.save_accum(tmp_path / "ck", straight[1], opts, len(tables))
    packs = []
    pack = render_mod.pack_argb
    monkeypatch.setattr(render_mod, "pack_argb", lambda o, a: packs.append(1) or pack(o, a))

    def no_render(*args, **kwargs):
        raise AssertionError("a fully resumed render rendered a pass")

    monkeypatch.setattr(render_mod, "render_image", no_render)
    argb_r, accum_r = checkpoint.render_checkpointed(vol_np, opts, tables, tmp_path / "ck",
                                                     chunk=2, device="cpu")
    assert packs == [1]
    np.testing.assert_array_equal(argb_r, straight[0])
    assert torch.equal(accum_r, straight[1])


def test_mismatched_digest_rejected(tmp_path, scene):
    vol_np, opts, tables = scene
    checkpoint.render_checkpointed(vol_np, opts, tables[:2], tmp_path / "ck", chunk=1,
                                   device="cpu")
    with pytest.raises(ValueError, match="digest"):
        checkpoint.render_checkpointed(vol_np, opts, make_mc_tables(2, seed=99),
                                       tmp_path / "ck", chunk=1, device="cpu")
    with pytest.raises(ValueError, match="digest"):  # same tables, other times
        checkpoint.render_checkpointed(vol_np, opts, tables[:2], tmp_path / "ck", chunk=1,
                                       device="cpu", times=[0.0, 0.5])


def test_default_device_needs_card(tmp_path, scene, monkeypatch):
    vol_np, opts, tables = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.render_checkpointed(vol_np, opts, tables, tmp_path / "ck")
    assert not (tmp_path / "ck.npz").exists()


@pytest.mark.parametrize("seed", [None, 0, 7])
@pytest.mark.parametrize("step", ["init", "anim"])
def test_pass_digest_equals_jax(seed, step):
    t_tables, j_tables = make_mc_tables(3, seed=4), js.make_mc_tables(3, seed=4)
    t_times = torch.arange(3, dtype=torch.float32) * getattr(render_mod, f"TIME_STEP_{step.upper()}")
    j_times = jnp.arange(3, dtype=jnp.float32) * getattr(j_render, f"TIME_STEP_{step.upper()}")
    got = checkpoint.pass_digest(t_tables, t_times, seed)
    assert got == j_ckpt.pass_digest(j_tables, j_times, seed)
    assert got == checkpoint.pass_digest(t_tables.numpy(), t_times.numpy(), seed)
    assert got != checkpoint.pass_digest(t_tables[:2], t_times[:2], seed)


def test_jax_checkpoint_resumes_in_port(tmp_path, scene, straight):
    """The JAX render_checkpointed stops after 2 of 5 passes; the port
    resumes its file and ends at the port's straight frame within the
    parity tolerance (bit-equal wherever the two packages' first passes
    agreed), and within the tolerance of the JAX straight frame."""
    vol_np, opts, tables = scene
    j_vol, j_opts, j_tables = jnp.asarray(vol_np), j_render_options(**KW), js.make_mc_tables(5, seed=2)
    np.testing.assert_array_equal(np.asarray(j_tables), tables.numpy())

    def stop(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        j_ckpt.render_checkpointed(j_vol, j_opts, j_tables, tmp_path / "ck", chunk=2,
                                   progress=stop)
    j_accum2, meta = checkpoint.load_accum(tmp_path / "ck", opts)
    assert meta["passes_done"] == 2
    argb, accum = checkpoint.render_checkpointed(vol_np, opts, tables, tmp_path / "ck",
                                                 chunk=2, device="cpu")
    # the port's own frame from the JAX package's 2-pass state
    want = render_mod.render_image(volume_from_numpy(vol_np), opts, tables[2:],
                                   times=(torch.arange(5, dtype=torch.float32)
                                          * render_mod.TIME_STEP_INIT)[2:],
                                   accum=torch.from_numpy(j_accum2.copy()))
    np.testing.assert_array_equal(argb, want[0])
    assert torch.equal(accum, want[1])
    ok = torch.isclose(accum, straight[1], **TOL).all(dim=1)
    assert float(ok.float().mean()) >= 0.995
    same = (accum == straight[1]).all(dim=1).numpy()
    assert same.mean() > 0.5
    np.testing.assert_array_equal(argb.reshape(-1)[same], straight[0].reshape(-1)[same])
    j_argb, j_accum = j_render.render_image(j_vol, j_opts, j_tables)
    ok = np.isclose(accum.numpy(), np.asarray(j_accum), **TOL).all(axis=1)
    assert ok.mean() >= 0.995
