"""Host ms a traced frame inside the port's `rmcl.k2.params` span
(ops/kernels/render_pass.make_params: the launch's ctypes parameter
block). Device trace: the span lands in the profiler's trace."""

from rmcl_bench.program import span_ms


def read(ctx):
    return span_ms(ctx, "rmcl.k2.params")
