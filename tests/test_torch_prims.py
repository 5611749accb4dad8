"""The plain versions of the primitive probes E1-E5 (ops/kernels/prims.py)
against NumPy transcriptions of the Pallas kernel bodies in
scripts/bench_pallas_prims.py, at the script's sizes.

The script's kernels are closures inside its timing functions, at fixed
sizes with 64-step loops: they cannot be called on their own, so each body
is transcribed here line by line, with int32 wraparound where the Pallas
body adds int32 or uint32. On the CPU each wrapper runs its plain version
and counts no launch; the kernels themselves are compared with their plain
versions on a GPU (test_torch_cuda.py, chip_smoke.py)."""

import os
import re

import numpy as np
import pytest
import torch

from raymarchcl_tpu_torch.ops.kernels import build, prims
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


def _prims_src():
    return open(os.path.join(build.CSRC_DIR, "prims.cu")).read()


def _e4_tile():
    """(kE4TileR, kE4TileC, kE4Split) as csrc/prims.cu declares them."""
    m = re.search(r"constexpr int kE4TileR = (\d+), kE4TileC = (\d+), kE4Split = (\d+);",
                  _prims_src())
    return tuple(int(g) for g in m.groups())


def e4_word(i, c):
    """csrc/prims.cu e4_word, its expression evaluated as written there: the
    shared-memory word of tile element (input row i, column c)."""
    expr = re.search(r"int e4_word\(int i, int c\) \{\s*return (.*?);", _prims_src(), re.S)
    return eval(expr.group(1), {"kE4TileR": _e4_tile()[0]}, {"i": i, "c": c})


@pytest.mark.parametrize("reps", [1, 7, 64])
@pytest.mark.parametrize("shape", [(1024, 128), (37, 70), (1, 5), (33, 9)])
def test_e4_swizzle_map(shape, reps):
    """E4's tile map, as the kernel runs it: the swizzle is a bijection of
    the tile onto its words, a warp's stores and a quarter warp's 16-byte
    reads hit distinct banks, each rep of a chunk is read by exactly one of
    its lanes, and over the grid every element of out is written once with
    reps times its input (ragged edges included)."""
    tr, tc, split = _e4_tile()
    r_all, c_all = shape
    # load phase: thread t < tr*tc/4 stores 4 elements of input row i
    t = np.arange(tr * tc // 4)
    i, g = t // (tc // 4), t % (tc // 4) * 4
    words = np.stack([e4_word(i, g + q) for q in range(4)], axis=1)  # (threads, q)
    np.testing.assert_array_equal(np.sort(words.ravel()), np.arange(tr * tc))
    for w0 in range(0, len(t), 32):
        for q in range(4):
            assert len(set(words[w0:w0 + 32, q] % 32)) == min(32, len(t) - w0)
    # read phase: thread t reads chunk o = t // split, rows 4h..4h+3 of column cl
    t = np.arange(tr * tc // 4 * split)
    o, part = t // split, t % split
    cl, h = o // (tr // 4), o % (tr // 4)
    at = e4_word(4 * h, cl)
    assert (at % 4 == 0).all()
    for q in range(4):
        np.testing.assert_array_equal(at + q, e4_word(4 * h + q, cl))
    for w0 in range(0, len(t), 8):  # distinct addresses of a quarter warp: distinct banks
        chunks = set(at[w0:w0 + 8] // 4)
        assert len({ch % 8 for ch in chunks}) == len(chunks)
    for ch in set(o):
        parts = part[o == ch]
        reads = sorted(j for p in parts for j in range(p, reps, split))
        assert reads == list(range(reps))  # each rep once, by one lane
    # the grid: the kernel's result from the map, against the plain version
    rng = np.random.default_rng(reps)
    xs = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    out = np.full((c_all, r_all), -1, np.int64)
    writes = np.zeros((c_all, r_all), int)
    lane0 = part == 0
    for r0 in range(0, r_all, tr):
        for c0 in range(0, c_all, tc):
            smem = np.zeros(tr * tc, np.int64)
            rr, cc = r0 + i, c0 + g
            for q in range(4):
                ok = (rr < r_all) & (cc + q < c_all)
                smem[words[ok, q]] = xs[rr[ok], cc[ok] + q]
            for q in range(4):
                orow, ocol = c0 + cl[lane0], r0 + 4 * h[lane0] + q
                ok = (orow < c_all) & (ocol < r_all)
                out[orow[ok], ocol[ok]] = smem[at[lane0][ok] + q] * reps
                writes[orow[ok], ocol[ok]] += 1
    assert (writes == 1).all()
    want = prims.e4_transpose_plain(_t(xs), reps).numpy()
    np.testing.assert_array_equal(prims._wrap(torch.from_numpy(out)).numpy(), want)


def _e1_ring():
    """(kE1Split, kE1Ring) as csrc/prims.cu declares them."""
    m = re.search(r"constexpr int kE1Split = (\d+), kE1Ring = (\d+);", _prims_src())
    return int(m.group(1)), int(m.group(2))


def e1_warp_ops(w, reps, split, depth):
    """csrc/prims.cu e1_row_fetch_kernel, warp w of a row's block: ("copy",
    slot, round) (a commit group), ("wait_group", n pending allowed), and
    ("store", slot) by the warp that took round reps - 1."""
    ops, n = [], 0
    for j in range(w, reps, split):
        if n >= depth:
            ops.append(("wait_group", depth - 1))
        ops.append(("copy", n % depth, j))
        n += 1
    ops.append(("wait_group", 0))
    if n and (reps - 1) % split == w:
        ops.append(("store", (n - 1) % depth))
    return ops


@pytest.mark.parametrize("depth", [1, 3, 8, 128])
@pytest.mark.parametrize("reps", [1, 2, 7, 16, 64])
def test_e1_ring_schedule(reps, depth):
    """E1's round-to-slot schedule against a model of cp.async groups (a
    wait_group n lands all but the n newest pending groups of the warp): no
    round is copied into a slot whose copy is in flight, every round is
    copied once, one warp stores, with nothing in flight, the slot holding
    round reps - 1. Depths below and above the rounds a warp takes; the
    kernel's own depth is kE1Ring."""
    split = _e1_ring()[0]
    copied, stores = [], []
    for w in range(split):
        pending, held = [], {}  # (slot, round) in commit order; round landed in each slot
        for op in e1_warp_ops(w, reps, split, depth):
            if op[0] == "copy":
                _, slot, j = op
                assert all(p[0] != slot for p in pending), f"round {j} races into slot {slot}"
                pending.append((slot, j))
                copied.append(j)
            elif op[0] == "wait_group":
                while len(pending) > op[1]:
                    slot, j = pending.pop(0)
                    held[slot] = j
            else:
                assert not pending, "a copy is in flight at the store"
                stores.append(held[op[1]])
    assert sorted(copied) == list(range(reps))
    assert stores == [reps - 1]


def test_e1_row_fetch_reps_checked(x):
    with pytest.raises(ValueError, match="reps"):
        prims.e1_row_fetch(x["e1_table"], x["e1_sidx"], 0)


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
