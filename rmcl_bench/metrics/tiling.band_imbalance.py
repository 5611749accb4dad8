"""The slowest card's K2c device time a frame over the mean of the cards,
averaged over the traced frames (parallel/tiling.render_image_tiled's row
bands). Device trace."""

from rmcl_bench.metrics_common import band_imbalance


def read(ctx):
    return band_imbalance(ctx)
