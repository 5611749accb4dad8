"""What the port records about itself, for the per-layer metric readers
(metrics/): its spans (`rmcl.<layer>.<step>`, `torch.profiler`
annotations that land in a traced run's chrome trace beside the device's
events, on their clock), its counters and its kernel's occupancy query.

A version of the port that records none of them (one from before they
were added) gives None here, never an error: each reader then leaves its
metric out.
"""

from __future__ import annotations

import bisect

from .trace import render_kind

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
TILE = "rmcl.tiling.tile"


def _spans_by_frame(ctx, name):
    """Per traced frame, the port's spans `name` that start in it (host
    events of the trace); None without a trace or without such a span."""
    tr = ctx.get("trace")
    if tr is None or not tr.frames:
        return None
    starts = [f0 for f0, _ in tr.frames]
    out = [[] for _ in tr.frames]
    found = False
    for e in tr.host:
        if e.get("name") != name or e.get("cat") != "user_annotation":
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] < tr.frames[i][1]:
            out[i].append(e)
            found = True
    return out if found else None


def span_ms(ctx, name):
    """Mean host ms a traced frame inside the port's spans `name`."""
    by_frame = _spans_by_frame(ctx, name)
    if by_frame is None:
        return None
    return sum(e["dur"] for f in by_frame for e in f) / len(by_frame) * 1e-3


def _render_kernels(tr):
    return [e for e in tr.device
            if e.get("cat") == "kernel" and render_kind(e.get("name", "")) is not None]


def after_kernel_ms(ctx, name):
    """Mean host ms a traced frame inside the spans `name` after the last
    render-pass kernel that started in the frame ended (the whole span in a
    frame without one): what a span that first waits for the kernel costs
    beyond that wait."""
    by_frame = _spans_by_frame(ctx, name)
    if by_frame is None:
        return None
    tr = ctx["trace"]
    kernels = _render_kernels(tr)
    total = 0.0
    for (f0, f1), spans in zip(tr.frames, by_frame):
        ends = [k["ts"] + k["dur"] for k in kernels if f0 <= k["ts"] < f1]
        last = max(ends, default=f0)
        total += sum(e["ts"] + e["dur"] - max(e["ts"], min(last, e["ts"] + e["dur"]))
                     for e in spans)
    return total / len(tr.frames) * 1e-3


def band_wait_ms(ctx):
    """Mean over the traced frames of the longest wait of a band: for each
    `rmcl.tiling.tile` span, the render-pass kernel launched inside it (its launch
    event's `correlation` matched to the kernel's) started this long after
    the launch call returned (0 where it started before). None where no
    launch inside a tile span is matched to a kernel."""
    by_frame = _spans_by_frame(ctx, TILE)
    if by_frame is None:
        return None
    tr = ctx["trace"]
    kernel_of = {(k.get("args") or {}).get("correlation"): k for k in _render_kernels(tr)}
    kernel_of.pop(None, None)
    launches = sorted((e for e in tr.host
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e.get("name", "").startswith(LAUNCH_PREFIXES)),
                      key=lambda e: e["ts"])
    starts = [e["ts"] for e in launches]
    waits = []
    for spans in by_frame:
        frame = []
        for s in spans:
            lo = bisect.bisect_left(starts, s["ts"])
            hi = bisect.bisect_right(starts, s["ts"] + s["dur"])
            for e in launches[lo:hi]:
                k = kernel_of.get((e.get("args") or {}).get("correlation"))
                if k is not None:
                    frame.append(max(k["ts"] - (e["ts"] + e["dur"]), 0.0))
        if frame:
            waits.append(max(frame))
    return sum(waits) / len(waits) * 1e-3 if waits else None


def copied_mb():
    """The tiled entries' bytes moved to or from a card other than the
    mesh's home a call (parallel/tiling.py's COPIED_BYTES over CALLS), in
    MB: every call of a cell, warm frame included, moves the same bytes."""
    from raymarchcl_tpu_torch.parallel import tiling

    calls = getattr(tiling, "CALLS", 0)
    if not calls:
        return None
    return tiling.COPIED_BYTES / calls / 1e6


def occupancy_pct(ctx, reflective):
    """Resident warps per SM of the render-pass kernel's brick-table
    instance (K2c's with `reflective`) over the most an SM holds, in %,
    from the port's occupancy query on the card."""
    if ctx.get("kind", "cpu") == "cpu":
        return None
    import torch

    from raymarchcl_tpu_torch.ops.kernels import render_pass

    query = getattr(render_pass, "occupancy", None)
    occ = query(reflective) if query is not None else None
    if occ is None:
        return None
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    threads = getattr(props, "max_threads_per_multi_processor", 2048)  # 2048 on sm_90
    return 100.0 * occ["warps_per_sm"] / (threads // 32)
