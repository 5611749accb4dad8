"""Each CUDA kernel of the PyTorch port against its plain version, on a GPU.

Marked `cuda`; without a CUDA device they skip. The file imports no JAX, so
on a machine with a GPU and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.ops.kernels import tonemap as k1
from raymarchcl_tpu_torch.options import render_options


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
