"""Device ms a frame of K2c, the render-pass kernel's reflective
instances, summed over the cards. Device trace."""

from rmcl_bench.metrics_common import kernel_ms


def read(ctx):
    return kernel_ms(ctx, "k2c")
