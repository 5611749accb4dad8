"""The longest a band's render-pass kernel sat queued after the host
launched it inside its `rmcl.tiling.tile` span (the kernel's start less
the end of its launch call, matched by correlation), in ms, the mean of
the traced frames. Device trace."""

from rmcl_bench.program import band_wait_ms


def read(ctx):
    return band_wait_ms(ctx)
