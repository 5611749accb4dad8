"""Host ms a traced frame inside the port's `rmcl.k2.block` span
(ops/kernels/render_pass._launch: launch_block, its pinned copy to the
card, the zeroed tile counter). Device trace: the span lands in the
profiler's trace."""

from rmcl_bench.program import span_ms


def read(ctx):
    return span_ms(ctx, "rmcl.k2.block")
