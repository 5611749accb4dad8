"""Host ms a traced frame inside the port's `rmcl.tiling.inputs` spans
(parallel/tiling.render_image_tiled: each tile's accum and image slices
and the replicas put on its card). Device trace: the spans land in the
profiler's trace."""

from rmcl_bench.program import span_ms


def read(ctx):
    return span_ms(ctx, "rmcl.tiling.inputs")
