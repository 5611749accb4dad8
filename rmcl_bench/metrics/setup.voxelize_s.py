"""Host seconds of the configuration's mesh into voxels
(models/mesh.LAST_VOXELIZE: `read_stl`, the STL file's read into distinct
vertices, and `voxelize`, the voxelizer), read from the process after the
window: the cell's one voxelization. Program counter: it runs in set-up,
before any profiler starts. None from a version of the port that records
no such counter."""


def read(ctx):
    from raymarchcl_tpu_torch.models import mesh

    seconds = getattr(mesh, "LAST_VOXELIZE", {}).get("seconds")
    if not seconds:
        return None
    return seconds["read_stl"] + seconds["voxelize"]
