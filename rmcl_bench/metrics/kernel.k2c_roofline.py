"""K2c's share of the roofline, in %: the least time of the cell's
frozen work a frame (workloads/<cell>.json `work`: operations at the
card's float32 peak, bytes at its HBM rate, the larger) over the
kernel's device seconds a frame (summed over the cards). Device trace."""

from rmcl_bench.metrics_common import roofline


def read(ctx):
    return roofline(ctx, "k2c")
