"""One run of one benchmark cell.

    python3 -m rmcl_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from this module's start): the inputs from
the seed (the volume and MC tables made on the card, the camera ring),
the port's own state (its options, the brick table, the kernel library,
built at the first run of a checkout under build/ and loaded after), one
warm frame. Then a closed loop of frames for `--seconds` seconds, the next
frame asked when the last is back, the poses going round the ring. A
reservoir drawn from the seed keeps a few frames' outputs, which are
judged once the window has closed (check.py). With `--trace 1` the
profiler records the window's first frames and the per-layer metrics are
read from its chrome trace (trace.py, metrics/).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with `--trace 1`
`breakdown`), then `checks`, each compared number beside its limit, which
also end standard error; set-up writes a line on the host's CPU there too.
Without a card, with fewer cards than the cell asks for, with a volume
generator or entry point that neither the harness nor the checkout's
files define, or with JAX or the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raymarchcl_tpu")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return smi.stdout.strip().replace("\n", "; ") or f"nvidia-smi rc {smi.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"


def host_line() -> str:
    """The host CPU's model (with its vendor, family, model and stepping,
    which a virtual machine that hides the name still shows), logical
    cores and current MHz (their mean over the cores) from /proc/cpuinfo:
    paired runs on one machine read alike."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), []).append(value.strip())
    except OSError as e:
        return f"unavailable ({e.__class__.__name__})"
    first = {k: v[0] for k, v in info.items()}
    ident = " ".join(f"{k} {first[k]}" for k in ("cpu family", "model", "stepping") if k in first)
    mhz = [float(v) for v in info.get("cpu MHz", [])]
    return (f"{first.get('model name', 'unknown model')} ({first.get('vendor_id', '?')} {ident}), "
            f"{len(info.get('processor', []))} logical cores, "
            + (f"{sum(mhz) / len(mhz):.1f} MHz" if mhz else "MHz unknown"))


def _devices(cell, device):
    import torch

    if device is not None:
        return [torch.device(device)] * cell.chips
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} found")
    return [torch.device("cuda", i) for i in range(cell.chips)]


def _sync(devices):
    import torch

    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counters():
    from raymarchcl_tpu_torch.ops.kernels import render_pass, tonemap

    return {"K2": render_pass.LAUNCHES, "K2c": render_pass.REFLECTIVE_LAUNCHES,
            "packs": render_pass.PACKS, "K1": tonemap.LAUNCHES}


def window(scene, seconds, keep, seed, trace_frames=0):
    """The closed loop. Returns the frame latencies (s), the window (s),
    the kept frames [(pose, accum, argb)] and the profiler (or None)."""
    from . import inputs

    prof = None
    if trace_frames:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        scene.traced = True
    pick = inputs.rng(seed, "keep")
    ring = scene.ring
    lat, kept = [], []
    if prof is not None:
        prof.start()
    t_start = time.perf_counter()
    t1 = t_start
    i = 0
    while i == 0 or t1 - t_start < seconds:
        pose = i % len(ring)
        t0 = time.perf_counter()
        if scene.traced:
            with record_function("rmcl_bench.frame"):
                argb, accum = scene.frame(ring[pose])
        else:
            argb, accum = scene.frame(ring[pose])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if i < keep:
            kept.append((pose, accum, argb))
        else:
            j = pick.randrange(i + 1)
            if j < keep:
                kept[j] = (pose, accum, argb)
        i += 1
        if scene.traced and i == trace_frames:
            prof.stop()
            scene.traced = False
    if scene.traced:
        prof.stop()
        scene.traced = False
    return lat, t1 - t_start, kept, prof


def _trace_ctx(prof):
    from .trace import Trace

    with tempfile.TemporaryDirectory() as tmp:  # under TMPDIR
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Trace(json.load(f)["traceEvents"])


def run(workload, seed, seconds, trace, device=None, control=False, t_start=None,
        log=None, root=spec.ROOT):
    """One run of the cell `workload` of the checkout `root`: the result
    object, its last key `checks`. `device` ('cpu' in the tests) skips the
    look for cards and renders there; `control` judges the control in the
    program's place (check.judge)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = T0 if t_start is None else t_start
    cell = spec.find_cell(workload, root)
    import torch

    phases = {"torch": time.perf_counter() - t_start}
    devices = _devices(cell, device)
    cuda = devices[0].type == "cuda"
    if cuda:
        torch.set_num_threads(2)
    from . import check
    from .entries import Scene

    phases["cards and imports"] = time.perf_counter() - t_start
    scene = Scene(cell, seed, devices)
    _sync(devices)
    phases["inputs and port state"] = time.perf_counter() - t_start
    argb, accum = scene.frame(scene.ring[0])  # builds or loads the kernels
    keep = int(cell.data["check"]["frames"])
    spare = [torch.empty_like(accum) for _ in range(keep + 1)]  # warms the allocator
    del spare, argb, accum
    _sync(devices)
    phases["warm frame"] = time.perf_counter() - t_start
    if cuda:
        from raymarchcl_tpu_torch.ops.kernels import build

        log(f"kernel library: {build.build_info.get('path')} nvcc "
            f"{build.build_info.get('seconds')} s cached {build.build_info.get('cached')}")
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    log("set-up, s from the start: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    log(f"host: {host_line()}")
    before = _counters()
    trace_frames = int(cell.traffic["trace_frames"]) if trace else 0
    lat, window_s, kept, prof = window(scene, seconds, keep, seed, trace_frames)
    _sync(devices)
    after = _counters()
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    n = len(lat)
    if cuda:
        log(f"card: {card_line()}")
    quarters = [lat[k * n // 4:(k + 1) * n // 4] for k in range(4)]
    log("frame ms by quarter of the window: " + ", ".join(
        f"{1e3 * sum(q) / len(q):.4f}" for q in quarters if q))
    log(f"window: {n} frames in {window_s:.6f} s; launches a frame "
        + ", ".join(f"{k} {(after[k] - before[k]) / n:.3f}" for k in after))
    ms = sorted(x * 1e3 for x in lat)
    log(f"frame latency ms over {n} frames: median {ms[n // 2]:.4f}, "
        f"p95 {ms[min(n - 1, int(0.95 * n))]:.4f}, max {ms[-1]:.4f}; setup {setup_s:.3f} s, "
        f"brick table {scene.accel_s:.3f} s")
    vol, tables, ring = scene.vol, scene.tables, scene.ring
    scene.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(cell, seed, vol, tables, ring, kept, control=control)
    log(f"check: {len(kept)} frames x {verdict['pixels'] // max(len(kept), 1)} pixels "
        f"against the reference in {time.perf_counter() - t_check:.3f} s")
    correct = n > 0 and all(v["value"] <= v["limit"] for v in verdict["numbers"].values())
    ctx = {"cell": cell, "setup_s": setup_s, "frames": n, "window_s": window_s,
           "accel_s": scene.accel_s,
           "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu"}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx["kind"], "count": len(devices),
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = ctx["trace"] = _trace_ctx(prof)
        w0, w1 = tr.window
        dev["busy_s"] = sum(tr.busy_us(c) for c in tr.cards) / max(len(tr.cards), 1) * 1e-6
        dev["window_s"] = (w1 - w0) * 1e-6
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps(tr.cards[0] if tr.cards else None)}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_reader(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": n, "failed": verdict["failed_frames"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except (NoDevice, spec.UnknownName) as e:
        print(f"rmcl_bench: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print(f"rmcl_bench: loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
