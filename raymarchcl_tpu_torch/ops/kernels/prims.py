"""E1-E5: the primitive probes of a brick march (gather, row staging, bit
probes, transpose, in-kernel loop).

Replace the five Pallas kernels of scripts/bench_pallas_prims.py, which
measured on the TPU whether Mosaic supported what a brick-march kernel
needs. CUDA source: csrc/prims.cu (what bounds each on the H100 is noted
there). Each wrapper runs its plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); every tensor is int32, uint32 data
held as its bits. The entry point that drives them at the script's sizes
is raymarchcl_tpu_torch/scripts/bench_prims.py.
"""

from __future__ import annotations

import torch

from . import build

# kernel launches by each wrapper (plain-version calls excluded)
LAUNCHES = dict.fromkeys(("E1", "E2", "E3", "E4", "E5"), 0)

# scripts/bench_pallas_prims.py:35-37
K = 1024  # rays per band
S = 4096  # brick rows in the table
REPS_IN = 64  # kernel-internal repetitions
LANES = 128
E2_DEPTHS = (8, 32, 128, 512, 4096)
E3_U = 8


def _wrap(x):
    """int64 -> the int32 value of its low 32 bits (as int64)."""
    return (x + 2**31) % 2**32 - 2**31


def e1_row_fetch_plain(table, sidx, reps=REPS_IN):
    """reps rounds of out[k, :] = table[(sidx[k] + j) mod S, :]; the last
    round's rows (bench_pallas_prims.py:72-79)."""
    out = None
    for j in range(reps):
        out = table.index_select(0, torch.remainder(_wrap(sidx.long() + j), table.shape[0]))
    return out


def e2_gather_plain(table, idx, reps=REPS_IN):
    """out = sum_{j<reps} take_along_axis(table, (idx + j) mod depth, 0),
    int32 wrap (bench_pallas_prims.py:108-114)."""
    acc = torch.zeros(idx.shape, dtype=torch.long, device=idx.device)
    for j in range(reps):
        ix = torch.remainder(_wrap(idx.long() + j), table.shape[0])
        acc = acc + torch.gather(table.long(), 0, ix)
    return _wrap(acc).int()


def e3_probe_plain(rows, w, b, u=E3_U, reps=REPS_IN):
    """hits[k] = sum over reps//u rounds j and i < u of bit (b[k]+i) mod 32
    of word (w[k]+j+i) mod W of rows[k] (bench_pallas_prims.py:138-152)."""
    words = rows.long() & 0xFFFFFFFF
    w, b = w.long().reshape(-1), b.long().reshape(-1)
    hits = torch.zeros(rows.shape[0], dtype=torch.long, device=rows.device)
    for j in range(reps // u):
        for i in range(u):
            at = torch.remainder(_wrap(w + j + i), rows.shape[1])
            word = torch.gather(words, 1, at[:, None])[:, 0]
            hits = hits + ((word >> torch.remainder(_wrap(b + i), 32)) & 1)
    return hits.int().reshape(-1, 1)


def e4_transpose_plain(x, reps=REPS_IN):
    """out = sum_{j<reps} x.T, int32 wrap (bench_pallas_prims.py:175-179)."""
    acc = torch.zeros(x.shape[::-1], dtype=torch.long, device=x.device)
    for _ in range(reps):
        acc = acc + x.t().long()
    return _wrap(acc).int()


def e5_while_plain(x):
    """while max(v[:, 0]) > 0: i += 1; v -= 1; then out = v + i, int32 wrap
    (bench_pallas_prims.py:200-208). Returns (out, trips (1,) int32)."""
    v, i = x.long(), 0
    while int(v[:, 0].max()) > 0:
        i += 1
        v = _wrap(v - 1)
    return _wrap(v + i).int(), torch.tensor([i], dtype=torch.int32, device=x.device)


def _on_cpu(name, **tensors):
    """Check the tensors (contiguous int32, one device); True on the CPU."""
    dev = None
    for arg, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous int32, got {t.dtype}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device}, {dev})")
        dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cpu"


def _launch(name, fn, dev, *args):
    """Launch C entry point `fn` with tensors as pointers and ints as ints,
    on the current stream; count the launch."""
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                                for a in args], stream)
    build.check(rc, fn)
    LAUNCHES[name] += 1


def e1_row_fetch(table, sidx, reps=REPS_IN):
    """E1 on (S, W) table rows for (K,) row indices -> (K, W)."""
    if reps < 1:
        raise ValueError(f"E1: reps must be >= 1, got {reps}")
    if _on_cpu("E1", table=table, sidx=sidx):
        return e1_row_fetch_plain(table, sidx, reps)
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] % 4 or sidx.dim() != 1:
        raise ValueError(f"E1: table (S >= 1, 4m) and sidx (K,), got {tuple(table.shape)}, "
                         f"{tuple(sidx.shape)}")
    out = torch.empty((sidx.shape[0], table.shape[1]), dtype=torch.int32, device=table.device)
    if table.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("E1: table must be 16-byte aligned (uint4 loads)")
    _launch("E1", "rmcl_e1_row_fetch", table.device, table, sidx, out, sidx.shape[0],
            table.shape[0], table.shape[1], reps)
    return out


def e2_gather(table, idx, reps=REPS_IN):
    """E2 on a (depth, C) table for (R, C) indices -> (R, C)."""
    if reps < 1:
        raise ValueError(f"E2: reps must be >= 1, got {reps}")
    if _on_cpu("E2", table=table, idx=idx):
        return e2_gather_plain(table, idx, reps)
    if (table.dim() != 2 or idx.dim() != 2 or idx.shape[1] != table.shape[1]
            or min(table.shape) < 1):
        raise ValueError(f"E2: table (depth >= 1, C >= 1) and idx (R, C), got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    out = torch.empty_like(idx)
    depth, cols = table.shape
    _launch("E2", "rmcl_e2_gather", table.device, table, idx, out, idx.numel(), cols, depth,
            reps)
    return out


def e3_probe(rows, w, b, u=E3_U, reps=REPS_IN):
    """E3 on (K, W) rows and (K, 1) or (K,) word and bit offsets -> (K, 1).
    reps < u is zero rounds: all hits 0."""
    if u < 1 or reps < 1:
        raise ValueError(f"E3: u and reps must be >= 1, got u={u}, reps={reps}")
    on_cpu = _on_cpu("E3", rows=rows, w=w, b=b)
    k = rows.shape[0] if rows.dim() == 2 else -1
    if k < 0 or rows.shape[1] < 1 or any(x.shape not in ((k, 1), (k,)) for x in (w, b)):
        raise ValueError(f"E3: rows (K, W >= 1), w and b (K, 1) or (K,), got "
                         f"{tuple(rows.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    if on_cpu:
        return e3_probe_plain(rows, w, b, u, reps)
    out = torch.empty((k, 1), dtype=torch.int32, device=rows.device)
    _launch("E3", "rmcl_e3_probe", rows.device, rows, w, b, out, k, rows.shape[1], reps // u, u)
    return out


def e4_transpose(x, reps=REPS_IN):
    """E4 on (R, C) -> (C, R)."""
    if _on_cpu("E4", x=x):
        return e4_transpose_plain(x, reps)
    if x.dim() != 2:
        raise ValueError(f"E4: x must be 2-D, got {tuple(x.shape)}")
    out = torch.empty(x.shape[::-1], dtype=torch.int32, device=x.device)
    _launch("E4", "rmcl_e4_transpose", x.device, x, out, x.shape[0], x.shape[1], reps)
    return out


def e5_while(x):
    """E5 on an (R, C) tile of 1 to 1024 elements -> (out, trips)."""
    if _on_cpu("E5", x=x):
        return e5_while_plain(x)
    if x.dim() != 2 or not 1 <= x.numel() <= 1024:
        raise ValueError(f"E5: x must be (R, C) with 1 <= R*C <= 1024, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    trips = torch.empty(1, dtype=torch.int32, device=x.device)
    _launch("E5", "rmcl_e5_while", x.device, x, out, trips, x.shape[0], x.shape[1])
    return out, trips
