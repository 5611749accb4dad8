"""Host ms a traced frame inside the port's `rmcl.k2.launch` span
(ops/kernels/render_pass._launch: the kernel library and the ctypes call
of rmcl_render_passes, which launches K2 or K2c). Device trace: the span
lands in the profiler's trace."""

from rmcl_bench.program import span_ms


def read(ctx):
    return span_ms(ctx, "rmcl.k2.launch")
