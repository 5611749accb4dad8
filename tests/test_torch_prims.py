"""The plain versions of the primitive probes E1-E5 (ops/kernels/prims.py)
against NumPy transcriptions of the Pallas kernel bodies in
scripts/bench_pallas_prims.py, at the script's sizes.

The script's kernels are closures inside its timing functions, at fixed
sizes with 64-step loops: they cannot be called on their own, so each body
is transcribed here line by line, with int32 wraparound where the Pallas
body adds int32 or uint32. On the CPU each wrapper runs its plain version
and counts no launch; the kernels themselves are compared with their plain
versions on a GPU (test_torch_cuda.py, chip_smoke.py)."""

import functools
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


def _e5_cases(rng):
    cases = {"script": np.full((8, LANES), 5), "random": rng.integers(-50, 300, (8, LANES)),
             "none": rng.integers(-9, 1, (8, LANES))}
    zero_col0 = rng.integers(-9, 300, (8, LANES))  # the other columns do not count
    zero_col0[:, 0] = rng.integers(-9, 1, 8)
    single_one = zero_col0.copy()
    single_one[5, 0] = 1
    return {**cases, "zero_col0": zero_col0, "single_one": single_one}


@pytest.mark.parametrize("case", ["script", "random", "none", "zero_col0", "single_one"])
def test_e5_while(case):
    """bench_pallas_prims.py:200-208: while max(v[:, :1]) > 0: i += 1,
    v -= 1; out = v + i. The trip count is max(0, max x[:, 0]): 0 where
    column 0 is all <= 0 (whatever the other columns hold), 1 where its
    largest value is a single 1."""
    xs = _e5_cases(np.random.default_rng(5))[case].astype(np.int32)
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
    assert set(res) == ({"E0", "E1", "E3", "E4", "E5", "E5/short"}
                        | {f"E2/{d}" for d in prims.E2_DEPTHS})
    assert res["E5/short"]["elems"] == 100 and res["E5"]["elems"] == 1000
    assert lines[0] == "device: cpu"
    assert any("E5 while_loop in kernel: OK (out[0,0]=5, trips 5)" in ln for ln in lines)
    assert all(r["us"] > 0 and r["mps"] > 0 for r in res.values())


INT32_MAX = 2**31 - 1


@functools.cache
def _device_expr(fn):
    """The return expression of `__device__ ... fn(...)` in csrc/prims.cu,
    compiled as Python (C's integer `/` on non-negative ints becomes `//`)."""
    m = re.search(rf"\b{fn}\([^)]*\) \{{\s*return (.*?);", _prims_src(), re.S)
    return compile(m.group(1).replace("/", "//"), f"prims.cu:{fn}", "eval")


@functools.cache
def _e2_consts():
    """(kE2Lanes, kE2Batch) as csrc/prims.cu declares them."""
    m = re.search(r"constexpr int kE2Lanes = (\d+), kE2Batch = (\d+);", _prims_src())
    return int(m.group(1)), int(m.group(2))


def e2_lane_rounds(i0, reps, depth, part, lanes, batch):
    """csrc/prims.cu e2_gather_kernel, lane `part` of the `lanes` sharing an
    output with start row i0: the (round j, table row) it loads, in order.
    e2_share and e2_steps are evaluated as written there."""
    env = {"kE2Lanes": lanes, "INT32_MAX": INT32_MAX}
    share = eval(_device_expr("e2_share"), env, {"reps": reps})
    steps = eval(_device_expr("e2_steps"), env, {"i0": i0, "reps": reps})
    j, j1 = part * share, min(reps, part * share + share)
    r = int(prims._wrap(i0 + j)) % depth  # the lane's one floor modulo
    loads = []
    while j < j1:
        for b in range(batch):
            if j + b < j1:
                if not steps:
                    r = int(prims._wrap(i0 + j + b)) % depth
                loads.append((j + b, r))
                r = 0 if r + 1 == depth else r + 1
        j += batch
    return loads


def _e2_starts(rng):
    """Start rows: near INT32_MAX (every overflow boundary of reps <= 64),
    negative ones down to INT32_MIN, and small ones."""
    return np.concatenate([INT32_MAX - np.arange(70), [-2**31, -2**31 + 1, -4097, -3, -1],
                           rng.integers(-2**31, 0, 8), [0, 1, 2, 4095, 4096],
                           rng.integers(0, 2**31, 8)])


@pytest.mark.parametrize("depth", [1, 3, 8, 4096])
@pytest.mark.parametrize("reps", [1, 7, 64])
@pytest.mark.parametrize("lanes", [1, 4, 16, 32])
def test_e2_lane_schedule(lanes, reps, depth):
    """E2's schedule, as the kernel runs it for `lanes` lanes an output:
    every round is loaded by exactly one lane of the group, from row
    (idx + j) mod depth of int32-wrapped idx + j (the +1 steps with their
    wrap, and the per-round formula past the int32 overflow), and never more
    than kE2Batch loads are held before they are summed."""
    batch = _e2_consts()[1]
    starts = _e2_starts(np.random.default_rng(reps * depth))
    for i0 in starts.tolist():
        loads = [ld for part in range(lanes)
                 for ld in e2_lane_rounds(i0, reps, depth, part, lanes, batch)]
        assert sorted(j for j, _ in loads) == list(range(reps)), (i0, reps)
        for j, r in loads:
            assert r == int(prims._wrap(i0 + j)) % depth, (i0, j, depth)


def test_e2_groups_within_a_warp():
    """The kernel's lanes an output: a power of two that divides a warp, so
    that a group's shuffles stay in its warp; over a grid of 128-thread
    blocks every output gets exactly that many lanes and threads past the
    last output none."""
    lanes, _ = _e2_consts()
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    for n in (1, 5, 1024, 6600):
        t = np.arange(-(-n * lanes // 128) * 128)
        o = t // lanes
        counts = np.bincount(o[o < n], minlength=n)
        assert (counts == lanes).all()
        assert (t[o < n] // 32 == (o[o < n] * lanes) // 32).all()  # one warp a group


@pytest.mark.parametrize("depth", [1, 3, 8, 4096])
@pytest.mark.parametrize("kind", ["near_max", "negative"])
def test_e2_plain_wrapping_starts(kind, depth):
    """The plain E2 at start rows near INT32_MAX (idx + j wraps to
    negative) and negative ones, against the Pallas body's transcription."""
    rng = np.random.default_rng(depth)
    if kind == "near_max":
        idx = INT32_MAX - rng.integers(0, 80, (8, LANES))
    else:
        idx = rng.integers(-2**31, 0, (8, LANES))
        idx[0, :3] = [-2**31, -1, -depth]
    idx = idx.astype(np.int32)
    table = rng.integers(-2**31, 2**31, (depth, LANES)).astype(np.int32)
    np.testing.assert_array_equal(prims.e2_gather(_t(table), _t(idx)).numpy(),
                                  _e2_numpy(table, idx, depth))


def test_e2_reps_checked(x):
    with pytest.raises(ValueError, match="reps"):
        prims.e2_gather(x["e2_table_8"], x["e2_idx_8"], 0)


def _e5_slots():
    m = re.search(r"constexpr int kE5Slots = (\d+);", _prims_src())
    return int(m.group(1))


def e5_layout(R, C):
    """csrc/prims.cu e5_while_kernel's layout: ({(lane, slot): element} of
    the tile, {(lane, column slot): row} of the column-0 slots each lane
    decrements, for k < e5_rows(R) as written there; a lane past the last
    row holds row 0 there)."""
    slots, rows = _e5_slots(), eval(_device_expr("e5_rows"), {}, {"R": R})
    tile = {(lane, q): lane + 32 * q for lane in range(32) for q in range(slots)
            if lane + 32 * q < R * C}
    col = {(lane, k): lane + 32 * k if lane + 32 * k < R else 0
           for lane in range(32) for k in range(rows)}
    return tile, col


@pytest.mark.parametrize("shape", [(8, 128), (37, 27), (1, 1), (1024, 1), (32, 32)])
def test_e5_slot_layout(shape):
    """E5's one-warp layout: every element of the tile in exactly one slot
    of one lane, every column-0 element (row r) in exactly one lane's column
    slots (the others there repeat row 0), and the loop run on that layout
    (decrement the column slots, OR within the lane, vote across lanes)
    gives the plain version's trips and output, with INT32_MIN outside
    column 0."""
    R, C = shape
    tile, col = e5_layout(R, C)
    assert sorted(tile.values()) == list(range(R * C))
    held = [r for (lane, k), r in col.items() if lane + 32 * k < R]
    assert sorted(held) == list(range(R))
    assert all(r == 0 for (lane, k), r in col.items() if lane + 32 * k >= R)
    rng = np.random.default_rng(R * C)
    xs = rng.integers(-2**31, 2**31, (R, C)).astype(np.int32)
    xs[:, 0] = rng.integers(-20, 30, R)
    if C > 1:
        xs[-1, 1] = -2**31
    flat = xs.reshape(-1).astype(np.int64)
    c0 = {s: int(flat[r * C]) for s, r in col.items()}
    i = 0
    while any(v > 0 for v in c0.values()):  # __any_sync over the lanes' ORs
        i += 1
        c0 = {s: int(prims._wrap(v - 1)) for s, v in c0.items()}
    out = np.empty(R * C, np.int64)
    for s, e in tile.items():
        out[e] = prims._wrap(prims._wrap(flat[e] - i) + i)
    want, trips = prims.e5_while_plain(_t(xs))
    assert i == int(trips[0])
    np.testing.assert_array_equal(out.reshape(R, C), want.numpy())


@functools.cache
def _e3_consts():
    """(kE3Lanes, kE3Batch) as csrc/prims.cu declares them."""
    m = re.search(r"constexpr int kE3Lanes = (\d+), kE3Batch = (\d+);", _prims_src())
    return int(m.group(1)), int(m.group(2))


def e3_lane_probes(w, b, u, rounds, width, part, lanes, batch):
    """csrc/prims.cu e3_probe_kernel, lane `part` of the `lanes` sharing a ray,
    for a vector of rays with word offsets w and bit offsets b (int64 arrays):
    the (round j, column i, word index per ray, bit per ray) it probes, in
    order. e3_cols, e3_share and e3_steps are evaluated as written there."""
    env = {"kE3Lanes": lanes, "INT32_MAX": INT32_MAX, "min": min}
    env["e3_cols"] = lambda u_: eval(_device_expr("e3_cols"), env, {"u": u_})
    cols = env["e3_cols"](u)
    share = eval(_device_expr("e3_share"), env, {"rounds": rounds, "u": u})
    h, j0 = part // cols, part // cols * share
    probes = []
    if h >= lanes // cols or j0 >= rounds:
        return probes
    j1 = j0 + min(share, rounds - j0)
    for i in range(part % cols, u, cols):
        bit = prims._wrap(b + i) & 31
        v0 = prims._wrap(w + j0 + i)
        steps = eval(_device_expr("e3_steps"), env, {"v0": v0, "n": j1 - j0})
        r = v0 % width  # the column's one floor modulo
        for j in range(j0, j1, batch):
            for q in range(batch):
                if j + q < j1:
                    r = np.where(steps, r, prims._wrap(w + j + q + i) % width)
                    probes.append((j + q, i, r, bit))
                    r = np.where(r + 1 == width, 0, r + 1)
    return probes


def _e3_starts(rng):
    """Word offsets near INT32_MAX (every overflow boundary of the shares
    below), negative ones down to INT32_MIN, and small ones."""
    return np.concatenate([INT32_MAX - np.arange(1100), [-2**31, -2**31 + 1, -129, -3, -1],
                           rng.integers(-2**31, 0, 8), [0, 1, 2, 127, 128],
                           rng.integers(0, 2**31, 8)]).astype(np.int64)


@functools.cache
def _e3_case(reps, u, width):
    """Rays at _e3_starts with random bit offsets and rows: (w, b, the rows'
    words as uint32 values, the plain E3's hits), shared by every lane count."""
    rng = np.random.default_rng(reps * u * width)
    w = _e3_starts(rng)
    b = rng.integers(-2**31, 2**31, w.size)
    rows = rng.integers(-2**31, 2**31, (w.size, width)).astype(np.int32)
    want = prims.e3_probe_plain(_t(rows), _t(w[:, None]), _t(b[:, None]), u, reps)
    return w, b, rows.view(np.uint32).astype(np.int64), want.numpy()[:, 0]


@pytest.mark.parametrize("width", [1, 3, 128])
@pytest.mark.parametrize("u", [1, 8, 33])
@pytest.mark.parametrize("reps", [1, 7, 64, 1024])
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_e3_lane_schedule(lanes, reps, u, width):
    """E3's schedule, as the kernel runs it for `lanes` lanes a ray: every
    (round, column) probe is taken by exactly one lane of the group, from
    word (w + j + i) mod W of int32-wrapped w + j + i (the +1 steps with their
    wrap, and the per-probe formula past the int32 overflow) and bit
    (b + i) mod 32, and the group's sum equals the plain E3 (u = 33 repeats
    bits; reps < u is no round)."""
    batch = _e3_consts()[1]
    w, b, words, want = _e3_case(reps, u, width)
    rounds = reps // u
    seen, bad, hits = [], 0, np.zeros(w.size, np.int64)
    for part in range(lanes):
        for j, i, r, bit in e3_lane_probes(w, b, u, rounds, width, part, lanes, batch):
            seen.append((j, i))
            bad += int(np.count_nonzero(r != prims._wrap(w + j + i) % width))
            hits += (np.take_along_axis(words, r[:, None], 1)[:, 0] >> bit) & 1
    assert sorted(seen) == [(j, i) for j in range(rounds) for i in range(u)]
    assert bad == 0, f"{bad} probes read the wrong word"
    np.testing.assert_array_equal(hits, want)


def test_e3_groups_within_a_warp():
    """The kernel's lanes a ray: a power of two that divides a warp, so that
    a group's shuffles stay in its warp."""
    lanes, batch = _e3_consts()
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0 and batch >= 1


@pytest.mark.parametrize("bad", ["W0", "u0", "reps0", "w_shape", "b_shape", "rows_1d"])
def test_e3_degenerate_shapes_refused(x, bad):
    """E3 refuses an empty row width, u < 1, reps < 1 and offsets that are
    not (K, 1) or (K,), before its plain version runs; reps < u is zero
    rounds, all hits 0."""
    rows, w, b = x["e3_rows"][:8], x["e3_w"][:8], x["e3_b"][:8]
    args, kw = {"W0": ((rows[:, :0], w, b), {}), "u0": ((rows, w, b), {"u": 0}),
                "reps0": ((rows, w, b), {"reps": 0}), "w_shape": ((rows, w[:7], b), {}),
                "b_shape": ((rows, w, b.reshape(1, 8)), {}),
                "rows_1d": ((rows.reshape(-1), w, b), {})}[bad]
    with pytest.raises(ValueError, match="E3"):
        prims.e3_probe(*args, **kw)
    got = prims.e3_probe(rows, w.reshape(-1), b, u=8, reps=7)
    assert got.shape == (8, 1) and not got.any()
