"""Device ms a frame of K2, the render-pass kernel's `ao` instances
(csrc/render_pass.cu). Device trace."""

from rmcl_bench.metrics_common import kernel_ms


def read(ctx):
    return kernel_ms(ctx, "k2")
