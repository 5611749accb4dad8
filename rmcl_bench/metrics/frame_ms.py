"""frame_ms: the window's seconds over the frames completed in it, in ms
(a frame: options for its pose, the entry's call, the packed image on the
host). Host clock over the whole window."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["frames"] if ctx["frames"] else None
