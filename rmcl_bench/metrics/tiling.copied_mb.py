"""MB a frame that the tiled entry moved to or from cards other than its
mesh's home (parallel/tiling.py's COPIED_BYTES over CALLS, read from the
process after the window): the replicas and the tiles out and back.
Program counter."""

from rmcl_bench.program import copied_mb


def read(ctx):
    return copied_mb()
