"""Device idle a frame before the frame's first device event, in ms: the
host launch path (options, parameter block, pinned copy, the launch) up
to the card's first work. Device trace."""

from rmcl_bench.metrics_common import idle_ms


def read(ctx):
    return idle_ms(ctx, "before")
