"""Host seconds of the brick table's build phases that touch every voxel
(ops/accel.LAST_BUILD: `to_host`, the volume to the host, and `bitplane`,
the threshold, brick transpose and packbits of the STOP bitplane), read
from the process after the window: the cell's one build. Program counter:
the build runs before any profiler starts. None from a version of the port
that records no such counter."""


def read(ctx):
    from raymarchcl_tpu_torch.ops import accel

    seconds = getattr(accel, "LAST_BUILD", {}).get("seconds")
    if not seconds:
        return None
    return seconds["to_host"] + seconds["bitplane"]
