"""Reduction of a torch.profiler chrome trace to per-frame numbers.

The frames are the harness's `FRAME` annotations; the device's events are
its kernels, copies and fills (on each card). The arithmetic here,
`idle_by_place` with it, is the harness's own and shares no code with the
program, so that the yardstick does not move with the program.
Times in the trace are microseconds.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

FRAME = "rmcl_bench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# K2 and K2c are the instances of one template; its third flag is kReflect
RENDER_KERNEL = re.compile(r"render_passes_kernel<\s*Build<\s*\w+\s*,\s*\w+\s*,\s*(\w+)\s*>")


def _merge(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_place(frames, device):
    """Idle device time of the frames by place: before a frame's first
    device event, in the gaps between device events (overlapping events
    merged), after its last; and the busy time and the frames' wall time.
    frames, device: (start, end) spans."""
    out = {"before": 0.0, "between": 0.0, "after": 0.0, "busy": 0.0, "wall": 0.0}
    for f0, f1 in frames:
        spans = [(max(a, f0), min(b, f1)) for a, b in device if b > f0 and a < f1]
        out["wall"] += f1 - f0
        if not spans:
            out["before"] += f1 - f0
            continue
        merged = _merge(spans)
        out["before"] += merged[0][0] - f0
        out["after"] += f1 - merged[-1][1]
        out["between"] += sum(b[0] - a[1] for a, b in zip(merged, merged[1:]))
        out["busy"] += sum(b - a for a, b in merged)
    return out


def render_kind(name: str):
    """'k2c' for the render-pass kernel's reflective instances, 'k2' for the
    others, None for any other kernel."""
    m = RENDER_KERNEL.search(name)
    if m is None:
        return None
    return "k2c" if m.group(1) == "true" else "k2"


class Trace:
    """The traced frames of one run and the device events in them."""

    def __init__(self, events):
        self.frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                             if e.get("name") == FRAME and e.get("ph") == "X")
        self.device = [e for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                     and e.get("name") != FRAME]

    @staticmethod
    def card(e) -> int:
        return int((e.get("args") or {}).get("device", e.get("pid", 0)))

    @property
    def cards(self) -> list:
        return sorted({self.card(e) for e in self.device})

    def spans(self, card=None):
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.device
                if card is None or self.card(e) == card]

    @property
    def window(self):
        """(start, end) of the traced frames."""
        return (self.frames[0][0], self.frames[-1][1]) if self.frames else (0.0, 0.0)

    def idle(self, card=None) -> dict:
        """idle_by_place over the traced frames, on one card (default all)."""
        return idle_by_place(self.frames, self.spans(card))

    def busy_us(self, card) -> float:
        """Microseconds of the traced window in which `card` ran an
        operation (events merged, clipped to the window)."""
        w0, w1 = self.window
        spans = [(max(a, w0), min(b, w1)) for a, b in self.spans(card) if b > w0 and a < w1]
        return sum(b - a for a, b in _merge(spans))

    def kernel_us_by_frame(self, kind: str, card=None) -> list:
        """Per traced frame, the device microseconds of the render-pass
        kernel of `kind` ('k2' or 'k2c') that started in it."""
        out = [0.0] * len(self.frames)
        starts = [f0 for f0, _ in self.frames]
        for e in self.device:
            if e.get("cat") != "kernel" or render_kind(e.get("name", "")) != kind:
                continue
            if card is not None and self.card(e) != card:
                continue
            i = _frame_of(starts, self.frames, e["ts"])
            if i is not None:
                out[i] += e["dur"]
        return out

    def device_ops(self, top=10) -> list:
        """[name, seconds] of the device operations that took most time in
        the traced window, summed over the cards."""
        w0, w1 = self.window
        by = defaultdict(float)
        for e in self.device:
            if w0 <= e["ts"] < w1:
                by[e.get("name", "?")[:160]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, card, top=10) -> list:
        """[host activity, seconds] of the card's idle time in the traced
        frames, each gap put under the innermost host event of its frame
        that spans its middle ('harness' where none does), largest
        first."""
        starts = [f0 for f0, _ in self.frames]
        host = defaultdict(list)
        for e in self.host:
            i = _frame_of(starts, self.frames, e["ts"])
            if i is not None:
                host[i].append(e)
        by = defaultdict(float)
        for i, (f0, f1) in enumerate(self.frames):
            spans = _merge([(max(a, f0), min(b, f1)) for a, b in self.spans(card)
                            if b > f0 and a < f1])
            edges = [f0] + [x for s in spans for x in s] + [f1]
            for a, b in zip(edges[::2], edges[1::2]):
                if b > a:
                    by[_host_at(host[i], (a + b) / 2)] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _host_at(events, t) -> str:
    best = None
    for e in events:
        if e["ts"] <= t < e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return "harness" if best is None else best.get("name", "?")[:160]


def _frame_of(starts, frames, ts):
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts < frames[i][1]:
        return i
    return None
