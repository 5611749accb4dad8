"""The plain versions of the primitive probes E1-E5 (ops/kernels/prims.py)
against NumPy transcriptions of the Pallas kernel bodies in
scripts/bench_pallas_prims.py, at the script's sizes.

The script's kernels are closures inside its timing functions, at fixed
sizes with 64-step loops: they cannot be called on their own, so each body
is transcribed here line by line, with int32 wraparound where the Pallas
body adds int32 or uint32. On the CPU each wrapper runs its plain version
and counts no launch; the kernels themselves are compared with their plain
versions on a GPU (test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.ops.kernels import prims
from raymarchcl_tpu_torch.scripts import bench_prims

torch.set_num_threads(1)

K, S, REPS_IN, LANES = 1024, 4096, 64, 128  # bench_pallas_prims.py:35-37


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@pytest.fixture(scope="module")
def x():
    return bench_prims.inputs("cpu", seed=1)


def test_sizes_are_the_scripts():
    assert (prims.K, prims.S, prims.REPS_IN, prims.LANES) == (K, S, REPS_IN, LANES)
    assert prims.E2_DEPTHS == (8, 32, 128, 512, 4096) and prims.E3_U == 8


def test_e1_row_fetch(x):
    """bench_pallas_prims.py:72-79: for j < REPS_IN, for k < K:
    out[k] = table[(sidx[k] + j) % S]; the script's own check (:98) is
    out == table[(sidx + REPS_IN - 1) % S]."""
    table, sidx = x["e1_table"], x["e1_sidx"]
    t_np, s_np = table.numpy(), sidx.numpy()
    want = np.empty((K, LANES), np.int32)
    for j in range(REPS_IN):
        for k in range(K):
            want[k, :] = t_np[(s_np[k] + j) % S, :]
    got = prims.e1_row_fetch(table, sidx)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), t_np[(s_np + REPS_IN - 1) % S])  # :98
    # fewer rounds end on another row
    np.testing.assert_array_equal(prims.e1_row_fetch(table, sidx, 16).numpy(),
                                  t_np[(s_np + 15) % S])


def _e2_numpy(table, idx, depth):
    """bench_pallas_prims.py:108-114: acc += take_along_axis(table,
    (idx + j) % depth, axis=0), int32 wraparound."""
    acc = np.zeros((8, LANES), np.int32)
    with np.errstate(over="ignore"):
        for j in range(REPS_IN):
            ix = (idx + np.int32(j)) % depth
            acc = acc + np.take_along_axis(table, ix, axis=0)
    return acc


@pytest.mark.parametrize("depth", [8, 32, 128, 512, 4096])
def test_e2_sublane_gather(x, depth):
    table, idx = x[f"e2_table_{depth}"], x[f"e2_idx_{depth}"]
    got = prims.e2_gather(table, idx)
    np.testing.assert_array_equal(got.numpy(), _e2_numpy(table.numpy(), idx.numpy(), depth))
    # int32 wraparound: values near the top of the range
    rng = np.random.default_rng(depth)
    big = rng.integers(2**30, 2**31, (depth, LANES)).astype(np.int32)
    want = _e2_numpy(big, idx.numpy(), depth)
    assert (want < 0).any()  # the sums did wrap
    np.testing.assert_array_equal(prims.e2_gather(_t(big), idx).numpy(), want)


def test_e3_probe(x):
    """bench_pallas_prims.py:138-152: for j < REPS_IN // u, i < u:
    word = rows[k, (w + j + i) % 128] (the masked lane max), hits +=
    (word >> (b + i) % 32) & 1."""
    rows, w, b = x["e3_rows"], x["e3_w"], x["e3_b"]
    r_np = rows.numpy().view(np.uint32)
    w_np, b_np = w.numpy(), b.numpy()
    lanes = np.arange(LANES)[None, :]
    hits = np.zeros((K, 1), np.int32)
    for j in range(REPS_IN // 8):
        for i in range(8):
            wi = (w_np + j + i) % 128
            bit = (b_np + i) % 32
            word = np.max(np.where(lanes == wi, r_np, np.uint32(0)), axis=1, keepdims=True)
            hits = hits + ((word >> bit.astype(np.uint32)) & 1).astype(np.int32)
    got = prims.e3_probe(rows, w, b)
    assert got.shape == (K, 1)
    np.testing.assert_array_equal(got.numpy(), hits)
    assert 0 < hits.min() and hits.max() < REPS_IN  # random words: some bits set, some not


def test_e4_transpose(x):
    """bench_pallas_prims.py:175-179: acc + x.T, REPS_IN times, int32
    wraparound."""
    xt = x["e4_x"]
    want = np.zeros((LANES, K), np.int32)
    with np.errstate(over="ignore"):
        for _ in range(REPS_IN):
            want = want + xt.numpy().T
    got = prims.e4_transpose(xt)
    assert got.shape == (LANES, K)
    np.testing.assert_array_equal(got.numpy(), want)
    big = _t(np.full((K, LANES), 2**26 + 3, np.int64))  # 64 * (2^26 + 3) wraps
    got = prims.e4_transpose(big).numpy()
    assert (got == np.int32(np.int64(64 * (2**26 + 3)) - 2**32)).all()


@pytest.mark.parametrize("case", ["script", "random", "none"])
def test_e5_while(case):
    """bench_pallas_prims.py:200-208: while max(v[:, :1]) > 0: i += 1,
    v -= 1; out = v + i. The trip count is max(0, max x[:, 0])."""
    rng = np.random.default_rng(5)
    xs = {"script": np.full((8, LANES), 5), "random": rng.integers(-50, 300, (8, LANES)),
          "none": rng.integers(-9, 1, (8, LANES))}[case].astype(np.int32)
    v, i = xs.copy(), 0
    while np.max(v[:, :1]) > 0:
        i, v = i + 1, v - 1
    out, trips = prims.e5_while(_t(xs))
    np.testing.assert_array_equal(out.numpy(), v + i)
    assert int(trips[0]) == i == max(0, int(xs[:, 0].max()))
    # int32 wraparound inside the loop: v - 1 at INT32_MIN
    xw = xs.copy()
    xw[:, 1] = np.iinfo(np.int32).min
    out, trips = prims.e5_while(_t(xw))
    np.testing.assert_array_equal(out.numpy(), xw)
    assert int(trips[0]) == i


def test_wrappers_cpu_and_checks(x):
    before = dict(prims.LAUNCHES)
    prims.e4_transpose(x["e4_x"][:64], reps=2)
    prims.e5_while(x["e5_x"])
    assert prims.LAUNCHES == before  # plain versions are no launch
    with pytest.raises(ValueError, match="int32"):
        prims.e1_row_fetch(x["e1_table"].long(), x["e1_sidx"])
    with pytest.raises(ValueError, match="int32"):
        prims.e4_transpose(x["e4_x"].t())
    with pytest.raises(ValueError, match="int32"):
        prims.e2_gather(x["e2_table_8"].float(), x["e2_idx_8"])


def test_bench_entry_point_cpu_rehearsal():
    """The entry point's checks and report lines, with the plain versions on
    the CPU (a few timed calls)."""
    lines = []
    res = bench_prims.run("cpu", n=1, log=lines.append)
    assert set(res) == {"E0", "E1", "E3", "E4", "E5"} | {f"E2/{d}" for d in prims.E2_DEPTHS}
    assert lines[0] == "device: cpu"
    assert any("E5 while_loop in kernel: OK (out[0,0]=5, trips 5)" in ln for ln in lines)
    assert all(r["us"] > 0 and r["mps"] > 0 for r in res.values())
