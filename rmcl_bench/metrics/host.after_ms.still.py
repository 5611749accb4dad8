"""Device idle a frame after its last device event, in ms: the image's
readback, the synchronize and the return. Device trace."""

from rmcl_bench.metrics_common import idle_ms


def read(ctx):
    return idle_ms(ctx, "after")
