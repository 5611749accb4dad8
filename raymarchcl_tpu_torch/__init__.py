"""raymarchcl_tpu_torch: the PyTorch + CUDA port of raymarchcl_tpu, a voxel
raymarching renderer with the capabilities of thi-ng/raymarchcl.

Layers (module names mirror raymarchcl_tpu):
  api             default_volume / render_frame / test_render, with `device=`
  scene/data      options + materials presets, models/ volumes, io/ formats,
                  convert (numpy state in)
  ops             plain PyTorch renderer: sampling, camera, march, shade, render
  ops/kernels     hand-written CUDA kernels (csrc/) with their plain versions:
                  K2 render_pass (one spp pass), K1 tonemap (pack)

Importing the package imports neither jax nor raymarchcl_tpu, and builds no
kernel: ops/kernels/build.py compiles csrc/ with nvcc on first CUDA use.
"""

from .api import default_volume, render_frame, test_render
from .materials import PRESETS, get_preset
from .options import RenderOpts, render_options

__version__ = "0.1.0"

__all__ = [
    "default_volume",
    "render_frame",
    "test_render",
    "render_options",
    "RenderOpts",
    "PRESETS",
    "get_preset",
]
