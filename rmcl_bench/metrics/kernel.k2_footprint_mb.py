"""MB of inputs the last render-pass call bound (ops/kernels/render_pass
.BOUND_BYTES: the volume, the MC tables and the brick rows), read from
the process after the window; above 50 the H100's L2 cannot hold them.
Program counter. None from a version of the port that records no such
counter."""


def read(ctx):
    from raymarchcl_tpu_torch.ops.kernels import render_pass

    bound = getattr(render_pass, "BOUND_BYTES", 0)
    return bound / 1e6 if bound else None
