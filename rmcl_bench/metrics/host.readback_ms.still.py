"""Host ms a traced frame inside the port's `rmcl.readback` span (the
packed image's copy to the host, ops/render.render_image) after the
frame's last render-pass kernel ended: the copy first waits for the
kernel, and that wait is kernel time. Device trace."""

from rmcl_bench.program import after_kernel_ms


def read(ctx):
    return after_kernel_ms(ctx, "rmcl.readback")
