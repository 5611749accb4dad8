"""Resident warps per SM of K2's brick-table instance over the most an SM
holds, in % (render_pass.occupancy(False), the query the launch sizes its
grid from). Program counter."""

from rmcl_bench.program import occupancy_pct


def read(ctx):
    return occupancy_pct(ctx, reflective=False)
