"""Published peaks of the cards the benchmark runs on, and the roofline.

NVIDIA H100 SXM data sheet, dense rates: 67 TFLOP/s float32 outside the
tensor cores (the render kernels' arithmetic), 3.35 TB/s of HBM3. They
assume the card's full 700 W; runs print the card's power limit beside
every share.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str):
    """The peaks of a card by its name (torch.cuda.get_device_name), or
    None for a card this table does not hold."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    return None


def least_seconds(kind: str, ops: float, nbytes: float):
    """The least time the card could take for `ops` float32 operations and
    `nbytes` bytes: the larger of the two bounds; None for an unknown
    card."""
    p = peak(kind)
    if p is None:
        return None
    return max(ops / p["fp32_flops"], nbytes / p["hbm_bytes_per_s"])


def roofline_pct(kind: str, ops: float, nbytes: float, seconds: float):
    """Share of the roofline in %: least_seconds over the measured device
    seconds of the same work; None without a reading."""
    least = least_seconds(kind, ops, nbytes)
    if least is None or not seconds or seconds <= 0:
        return None
    return 100.0 * least / seconds
