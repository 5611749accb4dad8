"""The brick-march primitive probes E1-E5 on the GPU: the port of
scripts/bench_pallas_prims.py, at its sizes (K=1024 rays, S=4096 table
rows, REPS_IN=64 in-kernel repetitions, E2 depths 8..4096, E3 u=8).

    python -m raymarchcl_tpu_torch.scripts.bench_prims [--device cuda] [--n 20]

Each kernel (ops/kernels/prims.py, csrc/prims.cu) is first checked against
its plain version (exactly equal integers, or the script raises), then
timed on the card alone (`kernel_ms`: n launches queued behind a spin
kernel, between two CUDA events). One report line per probe with
microseconds and millions of elements per second, as the JAX script
prints; E5 also at a tenth of its trips, for the time a trip, and on the
card the launch floor (an empty `torch.cuda._sleep(0)` kernel). E0, the
script's XLA `jnp.take` baseline, becomes the same loop of `torch.take`:
the library yardstick, not a kernel.
`--device cpu` runs the plain versions on the CPU and times them with the
host clock, as a rehearsal.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.kernels import prims
from ..ops.kernels.prims import E2_DEPTHS, E3_U, K, LANES, REPS_IN, S

# E5's timed input: column 0 holds up to this many loop trips
E5_TRIPS = 1000


def kernel_ms(fn, n):
    """Device milliseconds per call of `fn` on the current CUDA stream.

    A wrapper spends tens of microseconds on the host per launch, more than
    a small kernel runs, so launches timed one by one (or back to back)
    measure the host. Here a spin kernel holds the stream while the host
    queues the n calls, and the two events around them time the device
    work alone. The spin lasts twice the host's queueing time (measured on
    an untimed round) at 2 GHz, the card's top clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2 * host_s * 2e9) + 100_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def best_seconds(fn, device, n):
    """Seconds per call: `kernel_ms` over n calls on the card; on the CPU
    the best of n calls on the host clock."""
    if device.type == "cuda":
        return kernel_ms(fn, n) / 1e3
    fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def require_equal(name, got, want):
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"{name}: kernel differs from its plain version at {bad} elements")


def inputs(device, seed=0):
    """The script's inputs, made with numpy from `seed`: a dict of int32
    tensors on `device`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    x5 = np.full((8, LANES), 5, np.int32)
    x5_timed = rng.integers(-3, E5_TRIPS, (8, LANES)).astype(np.int32)
    x5_timed[rng.integers(0, 8), 0] = E5_TRIPS
    x5_short = x5_timed.copy()  # column 0 scaled to a tenth of the trips
    x5_short[:, 0] //= 10
    return {
        "e0_table": t(np.arange(S * LANES, dtype=np.uint32).view(np.int32)),
        "e0_idx": t(rng.integers(0, S * LANES, K)).long(),  # torch.take's index type
        "e1_table": t(np.arange(S * LANES, dtype=np.uint32).reshape(S, LANES).view(np.int32)),
        "e1_sidx": t(rng.integers(0, S, K)),
        **{f"e2_table_{d}": t(np.arange(d * LANES).reshape(d, LANES)) for d in E2_DEPTHS},
        **{f"e2_idx_{d}": t(rng.integers(0, d, (8, LANES))) for d in E2_DEPTHS},
        "e3_rows": t(rng.integers(0, 2**32, (K, LANES), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32)),
        "e3_w": t(rng.integers(0, LANES, (K, 1))),
        "e3_b": t(rng.integers(0, 32, (K, 1))),
        "e4_x": t(np.arange(K * LANES).reshape(K, LANES)),
        "e5_x": t(x5),
        "e5_x_timed": t(x5_timed),
        "e5_x_short": t(x5_short),
    }


def run(device="cuda", n=20, log=print):
    """Check and time E0-E5 on `device`. Returns {probe: {"us", "elems",
    "mps"}}: microseconds per call over n calls (best_seconds); "E5/short"
    is E5 at a tenth of the trips, res["E5"]["ns_per_trip"] the time a trip
    from the two, and on a card "floor" the launch floor (an empty
    `torch.cuda._sleep(0)` kernel, timed the same way)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to rehearse on the CPU")
    x = inputs(device)
    res = {}

    def report(key, name, fn, elems):
        dt = best_seconds(fn, device, n)
        res[key] = {"us": dt * 1e6, "elems": elems, "mps": elems / dt / 1e6}
        log(f"  {name:34s} {dt * 1e6:9.2f} us  {elems / dt / 1e6:10.1f} M/s")

    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    table0, idx0 = x["e0_table"], x["e0_idx"]

    def e0():
        c = torch.zeros(K, dtype=torch.int32, device=device)
        for i in range(REPS_IN):
            c = c + torch.take(table0, (idx0 + i) % table0.numel())
        return c

    report("E0", "E0 torch.take (1 elem/probe)", e0, K * REPS_IN)

    table, sidx = x["e1_table"], x["e1_sidx"]
    got = prims.e1_row_fetch(table, sidx)
    require_equal("E1", got, prims.e1_row_fetch_plain(table, sidx))
    require_equal("E1 (bench_pallas_prims.py:98)", got,
                  table[(sidx.long() + REPS_IN - 1) % S])
    report("E1", "E1 row fetch loop (rows/s)", lambda: prims.e1_row_fetch(table, sidx),
           K * REPS_IN)
    log(f"  {'   as bits staged (bit/s)':34s} {res['E1']['us']:9.2f} us  "
        f"{K * REPS_IN * 4096 / res['E1']['us']:10.1f} M/s")
    log(f"  {'   row bytes of all rounds (MB/s)':34s} {res['E1']['us']:9.2f} us  "
        f"{K * REPS_IN * LANES * 4 / res['E1']['us']:10.1f} M/s")

    for d in E2_DEPTHS:
        tab, idx = x[f"e2_table_{d}"], x[f"e2_idx_{d}"]
        require_equal(f"E2 depth={d}", prims.e2_gather(tab, idx), prims.e2_gather_plain(tab, idx))
        report(f"E2/{d}", f"E2 sublane gather depth={d:4d}",
               lambda: prims.e2_gather(tab, idx), 8 * LANES * REPS_IN)

    rows, w, b = x["e3_rows"], x["e3_w"], x["e3_b"]
    require_equal("E3", prims.e3_probe(rows, w, b), prims.e3_probe_plain(rows, w, b))
    report("E3", "E3 in-brick probe (bit test)", lambda: prims.e3_probe(rows, w, b),
           K * (REPS_IN // E3_U) * E3_U)

    xt = x["e4_x"]
    require_equal("E4", prims.e4_transpose(xt), prims.e4_transpose_plain(xt))
    report("E4", "E4 transpose (K,128)->(128,K)", lambda: prims.e4_transpose(xt),
           K * LANES * REPS_IN)
    log(f"  {'   shared-memory bytes read (MB/s)':34s} {res['E4']['us']:9.2f} us  "
        f"{K * LANES * 4 * REPS_IN / res['E4']['us']:10.1f} M/s")

    n_trips = {}
    for key, xs in (("E5", x["e5_x"]), ("E5/timed", x["e5_x_timed"]),
                    ("E5/short", x["e5_x_short"])):
        out, trips = prims.e5_while(xs)
        want, want_trips = prims.e5_while_plain(xs)
        require_equal(key, out, want)
        require_equal(f"{key} trips", trips, want_trips)
        n_trips[key] = int(want_trips[0])
        if key == "E5":
            log(f"  E5 while_loop in kernel: OK (out[0,0]={int(out[0, 0])}, "
                f"trips {int(trips[0])})")
    report("E5", f"E5 while_loop, {n_trips['E5/timed']} trips (trips/s)",
           lambda: prims.e5_while(x["e5_x_timed"]), n_trips["E5/timed"])
    report("E5/short", f"E5 while_loop, {n_trips['E5/short']} trips (trips/s)",
           lambda: prims.e5_while(x["e5_x_short"]), n_trips["E5/short"])
    ns = (res["E5"]["us"] - res["E5/short"]["us"]) * 1e3 / (n_trips["E5/timed"] -
                                                             n_trips["E5/short"])
    res["E5"]["ns_per_trip"] = ns
    log(f"  {'   ns a trip (the difference)':34s} {ns:9.2f} ns")
    if device.type == "cuda":
        # the launch floor: an empty spin kernel, timed as the probes are
        floor_us = kernel_ms(lambda: torch.cuda._sleep(0), n) * 1e3
        res["floor"] = {"us": floor_us}
        log(f"  {'launch floor torch.cuda._sleep(0)':34s} {floor_us:9.2f} us")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=20, help="timed calls per probe")
    args = ap.parse_args(argv)
    run(args.device, args.n)


if __name__ == "__main__":
    main()
