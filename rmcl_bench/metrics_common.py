"""What the per-layer metric readers (metrics/) share: reductions of a run's
trace (trace.Trace) to a frame's milliseconds, shares and ratios. Each
returns None where the run has nothing to read."""

from __future__ import annotations

from . import peaks


def _trace(ctx):
    tr = ctx.get("trace")
    return tr if tr is not None and tr.frames and tr.device else None


def idle_ms(ctx, place):
    """Mean idle ms a frame at `place` ('before', 'after') on the home card."""
    tr = _trace(ctx)
    if tr is None:
        return None
    return tr.idle(tr.cards[0])[place] / len(tr.frames) * 1e-3


def idle_share(ctx):
    """100 * (1 - busy / window), the mean of the cards that ran."""
    tr = _trace(ctx)
    if tr is None:
        return None
    w0, w1 = tr.window
    shares = [1.0 - tr.busy_us(c) / (w1 - w0) for c in tr.cards]
    return 100.0 * sum(shares) / len(shares)


def kernel_ms(ctx, kind):
    """Device ms a frame of the render-pass kernel of `kind`, summed over
    the cards; None where it did not run."""
    tr = _trace(ctx)
    if tr is None:
        return None
    total = sum(tr.kernel_us_by_frame(kind))
    return total / len(tr.frames) * 1e-3 if total > 0 else None


def roofline(ctx, kind):
    """The kernel's share of the roofline (peaks.roofline_pct) of the
    cell's frozen work a frame."""
    work = ctx["cell"].data.get("work")
    ms = kernel_ms(ctx, kind)
    if not work or ms is None:
        return None
    return peaks.roofline_pct(ctx["kind"], work["ops_per_frame"], work["bytes_per_frame"],
                              ms * 1e-3)


def band_imbalance(ctx):
    """Mean over the traced frames of the slowest card's K2c time over the
    cards' mean."""
    tr = _trace(ctx)
    if tr is None or len(tr.cards) < 2:
        return None
    per_card = [tr.kernel_us_by_frame("k2c", c) for c in tr.cards]
    ratios = [max(f) / (sum(f) / len(f)) for f in zip(*per_card) if sum(f) > 0]
    return sum(ratios) / len(ratios) if ratios else None
