"""Each CUDA kernel of the PyTorch port against its plain version, on a GPU.

Marked `cuda`; without a CUDA device they skip. The file imports no JAX, so
on a machine with a GPU and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel, sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import prims
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.scripts import bench_prims


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_cuda_bit_equal(cuda_device):
    rng = np.random.default_rng(0)
    acc = rng.uniform(-0.5, 30, (4096, 3)).astype(np.float32)
    acc[:2] = [[0.0, 1e30, np.inf], [-1.5, np.nan, -np.inf]]
    acc = torch.from_numpy(acc).to(cuda_device)
    before = k1.LAUNCHES
    got = k1.tonemap_pack(acc, 1.5)
    assert k1.LAUNCHES == before + 1
    assert torch.equal(got, k1.tonemap_pack_plain(acc, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.0, 0.333])
def test_k2_cuda_matches_plain(cuda_device, t):
    vres = [32, 32, 96]
    opts = render_options(width=32, height=24, vres=vres, iter=1, t=t, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to(cuda_device)
    table = sampling.make_mc_tables(1, seed=0, device=cuda_device)[0]
    acc = torch.zeros((opts.num_pixels, 3), device=cuda_device)
    want = k2.render_pass_plain(vol, opts, table, acc.clone())
    before = k2.LAUNCHES
    k2.render_pass(vol, opts, table, acc)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ok = torch.isclose(acc, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
def test_k2_cuda_brick_table_bit_equal(cuda_device):
    """K2 over the brick table: bit-equal to K2 without it, and within the
    tolerance of its plain version over the table."""
    vres = [48, 48, 48]
    opts = render_options(width=64, height=48, vres=vres, iter=1, mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = torch.from_numpy(generators.make_gyroid_volume({"vres": vres})).to(cuda_device)
    bricks = accel.build_accel(vol, vres, opts.isoVal)
    assert bricks.rows.device == vol.device
    table = sampling.make_mc_tables(1, seed=0, device=cuda_device)[0]
    raw = k2.render_pass(vol, opts, table, torch.zeros((opts.num_pixels, 3), device=cuda_device))
    before = k2.LAUNCHES
    got = k2.render_pass(vol, opts, table, torch.zeros_like(raw), bricks)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    assert torch.equal(got, raw)
    want = k2.render_pass_plain(vol, opts, table, torch.zeros_like(raw), bricks)
    ok = torch.isclose(got, want, rtol=5e-3, atol=5e-3).all(dim=1)
    assert float(ok.float().mean()) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["E1", "E2", "E3", "E4", "E5"])
def test_prims_cuda_equal_plain(cuda_device, key):
    """Each primitive probe at the script's sizes (every E2 depth) is
    exactly equal to its plain version."""
    x = bench_prims.inputs(cuda_device)
    cases = {
        "E1": [("e1_row_fetch", (x["e1_table"], x["e1_sidx"]))],
        "E2": [("e2_gather", (x[f"e2_table_{d}"], x[f"e2_idx_{d}"])) for d in prims.E2_DEPTHS],
        "E3": [("e3_probe", (x["e3_rows"], x["e3_w"], x["e3_b"]))],
        "E4": [("e4_transpose", (x["e4_x"],))],
        "E5": [("e5_while", (x["e5_x"],)), ("e5_while", (x["e5_x_timed"],))],
    }[key]
    for fn, args in cases:
        before = prims.LAUNCHES[key]
        got = getattr(prims, fn)(*args)
        want = getattr(prims, fn + "_plain")(*args)
        torch.cuda.synchronize()
        assert prims.LAUNCHES[key] == before + 1
        for g, w in zip(got, want) if key == "E5" else [(got, want)]:
            assert torch.equal(g, w), fn
