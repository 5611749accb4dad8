"""The brick build's counter and spans (ops/accel.LAST_BUILD, the
`rmcl.accel.*` spans) and the render pass's bound bytes
(ops/kernels/render_pass.BOUND_BYTES), which the benchmark's
`setup.accel_voxels_s` and `kernel.k2_footprint_mb` read.

The `cuda` case skips without a card. The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_accel_counters.py
"""

import pytest
import torch

from raymarchcl_tpu_torch.models import generators
from raymarchcl_tpu_torch.ops import accel as accel_mod
from raymarchcl_tpu_torch.ops import sampling
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.kernels import render_pass as k2
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.utils import metrics

SPANS = [f"rmcl.accel.{p}" for p in accel_mod.BUILD_PHASES]


def _gyroid(vres):
    return generators.make_gyroid_volume({"vres": [vres] * 3})


def test_last_build_is_replaced_at_each_build():
    acc = accel_mod.build_accel(_gyroid(64), (64, 64, 64), 32)
    first = accel_mod.LAST_BUILD
    assert set(first["seconds"]) == set(accel_mod.BUILD_PHASES)
    assert all(s >= 0.0 for s in first["seconds"].values())
    assert first["voxels"] == 64**3
    assert first["rows_bytes"] == acc.rows.numel() * 4 == 8**3 * 18 * 4
    acc = accel_mod.build_accel(_gyroid(16), (16, 16, 16), 32)
    last = accel_mod.LAST_BUILD
    assert set(last["seconds"]) == set(accel_mod.BUILD_PHASES)
    assert last["voxels"] == 16**3  # replaced, not added to
    assert last["rows_bytes"] == acc.rows.numel() * 4 == 2**3 * 18 * 4


def test_build_spans_only_under_a_profiler(monkeypatch):
    """Under the CPU profiler without Kineto (Kineto's first start in a
    process costs ~2 s; the spans are gated alike under both)."""
    vol = _gyroid(32)
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        accel_mod.build_accel(vol, (32, 32, 32), 32)
    assert [e.name for e in prof.function_events if e.name.startswith("rmcl.")] == SPANS
    called = []
    monkeypatch.setattr(metrics, "record_function", lambda name: called.append(name))
    accel_mod.build_accel(vol, (32, 32, 32), 32)  # no profiler records
    assert called == []


def _pass_inputs(device):
    vres = 16
    vol = torch.from_numpy(_gyroid(vres)).to(device)
    opts = render_options(width=4, height=4, vres=[vres] * 3, iter=1, mat="ao", maxIter=8,
                          maxVoxelIter=8, shadowIter=4, aoIter=1,
                          eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])
    tables = sampling.make_mc_tables(1, seed=3, device=device)
    acc = accel_mod.build_accel(vol, opts.voxelRes, opts.isoVal)
    return vol, opts, tables, acc


def _bound_bytes_after_one_call(device):
    vol, opts, tables, acc = _pass_inputs(device)
    accum = torch.zeros((opts.num_pixels, 3), dtype=torch.float32, device=device)
    k2.render_passes(vol, opts, tables, torch.zeros(1), accum, acc)
    with_table = k2.BOUND_BYTES
    k2.render_passes(vol, opts, tables, torch.zeros(1), accum.zero_(), None)
    return with_table, k2.BOUND_BYTES, vol, tables, acc


def test_bound_bytes_of_the_last_call_on_the_cpu():
    with_table, without, vol, tables, acc = _bound_bytes_after_one_call("cpu")
    assert with_table == 16**3 + tables.numel() * 4 + acc.rows.numel() * 4
    assert without == 16**3 + tables.numel() * 4  # the last call's, not a sum


@pytest.mark.cuda
def test_bound_bytes_after_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launches = k2.LAUNCHES
    with_table, without, vol, tables, acc = _bound_bytes_after_one_call("cuda")
    torch.cuda.synchronize()
    assert k2.LAUNCHES == launches + 2
    assert with_table == vol.nbytes + tables.nbytes + acc.rows.nbytes
    assert without == vol.nbytes + tables.nbytes
