"""raymarchcl_tpu_torch: the PyTorch + CUDA port of raymarchcl_tpu, a voxel
raymarching renderer with the capabilities of thi-ng/raymarchcl.

Layers (module names mirror raymarchcl_tpu):
  api             default_volume / render_frame / test_render / test_anim,
                  with `device=`; __main__ (the CLI), compat (render from
                  TRenderOpts blobs), runtime (devices, the kernel build log)
  scene/data      options + materials presets, options_codec, models/
                  volumes (gyroid, terrain, STL meshes, heatmaps), io/
                  formats and checkpoints, convert (numpy state in)
  ops             plain PyTorch renderer: sampling, camera, march, shade, render
  ops/kernels     hand-written CUDA kernels (csrc/) with their plain versions:
                  K2 render_pass (a frame's spp passes, over a pixel range),
                  K1 tonemap (pack), E1-E5 prims (probes)
  parallel        tiling (pixel tiles, pass shards and both over a mesh of
                  devices), distributed (process groups, torch.distributed)
  utils           metrics (timers, ray budgets, frame reports, the hit
                  fraction) and stats (march occupancy)
  scripts         gallery, render_tiled (one tile a process), run_config5,
                  and the card's measurement tools

Importing the package imports neither jax nor raymarchcl_tpu, and builds no
kernel: ops/kernels/build.py compiles csrc/ with nvcc on first CUDA use.
"""

from .api import default_volume, render_frame, test_anim, test_render
from .materials import PRESETS, get_preset
from .options import RenderOpts, render_options

__version__ = "0.1.0"

__all__ = [
    "default_volume",
    "render_frame",
    "test_render",
    "test_anim",
    "render_options",
    "RenderOpts",
    "PRESETS",
    "get_preset",
]
