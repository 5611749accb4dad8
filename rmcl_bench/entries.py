"""The system under test: a cell's set-up and its frame, through the
port's entry points (raymarchcl_tpu_torch), by the name in the cell's
traffic (`entry`).

A frame is one call into the entry point, from a zeroed accum to the
packed ARGB image as a host array, with its options built for its pose by
the port's `options.render_options` inside the frame.
"""

from __future__ import annotations

import contextlib
import time

from . import inputs


def _span(name, on):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Scene:
    """A cell's inputs (made from the seed) and the port's state derived
    from them; `frame(eye)` renders one frame at an eye position."""

    def __init__(self, cell, seed, devices):
        from raymarchcl_tpu_torch.ops.accel import build_accel
        from raymarchcl_tpu_torch.options import render_options

        cfg, tr = cell.config, cell.traffic
        home = devices[0]
        self.cell, self.devices, self.traced = cell, devices, False
        vol_cfg = cfg["volume"]
        self.vol = inputs.VOLUMES[vol_cfg["generator"]](vol_cfg["vres"], home)
        self.tables = inputs.mc_tables(tr["spp"], seed, home)
        self.ring = inputs.camera_ring(tr["camera"], seed)
        cam = tr["camera"]
        self.user = dict(width=tr["width"], height=tr["height"], vres=vol_cfg["vres"],
                         iter=tr["spp"], mat=cfg["mat"], targetpos=cam["target"],
                         **{k: cam[k] for k in ("fov", "dof") if cam.get(k) is not None},
                         **cfg.get("options", {}), **tr.get("budgets", {}))
        self.render_options = render_options
        opts = render_options(eyepos=self.ring[0], **self.user)
        t0 = time.perf_counter()
        self.accel = build_accel(self.vol, opts.voxelRes, opts.isoVal)
        if home.type == "cuda":
            import torch

            torch.cuda.synchronize(home)
        self.accel_s = time.perf_counter() - t0
        self.entry = ENTRIES[tr["entry"]](self)

    def frame(self, eye):
        with _span("rmcl_bench.options", self.traced):
            opts = self.render_options(eyepos=eye, **self.user)
        with _span("rmcl_bench.render", self.traced):
            return self.entry(opts)

    def release(self):
        """Drop the port's state (the brick table, the mesh)."""
        self.accel = self.entry = None


def _render_image(scene):
    from raymarchcl_tpu_torch.ops.render import render_image

    return lambda opts: render_image(scene.vol, opts, scene.tables, accel=scene.accel)


def _render_image_tiled(scene):
    from raymarchcl_tpu_torch.parallel.tiling import make_mesh, render_image_tiled

    mesh = make_mesh(devices=scene.devices)
    return lambda opts: render_image_tiled(scene.vol, opts, scene.tables, mesh=mesh,
                                           accel=scene.accel)


ENTRIES = {"render_image": _render_image, "render_image_tiled": _render_image_tiled}
