"""The system under test: a cell's set-up and its frame, through the
port's entry points (raymarchcl_tpu_torch), by the name in the cell's
traffic (`entry`): one of `ENTRIES`, else the module
`entrypoints/<entry>.py` of the cell's checkout, whose `make(scene)`
returns the frame's call, opts -> (argb, accum), as `ENTRIES`' do.

A frame is one call into the entry point, from a zeroed accum to the
packed ARGB image as a host array, with its options built for its pose by
the port's `options.render_options` inside the frame.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from . import inputs, spec


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
        make_volume = volume_source(vol_cfg, cell.root)
        make_entry = entry_point(tr["entry"], cell.root)
        self.vol = make_volume(home)
        n = int(vol_cfg["vres"]) ** 3
        if self.vol.dtype != torch.uint8 or tuple(self.vol.shape) != (n,):
            raise ValueError(f"volume {vol_cfg['generator']!r} is {self.vol.dtype} "
                             f"{tuple(self.vol.shape)}, not flat uint8 of vres^3 = {n}")
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
            torch.cuda.synchronize(home)
        self.accel_s = time.perf_counter() - t0
        self.entry = make_entry(self)

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


def volume_source(vol_cfg: dict, root: str):
    """The configuration's volume as f(device): a generator of
    `inputs.VOLUMES` at the `volume` object's `vres`, else
    `make(volume_cfg, device)` of `volumes/<generator>.py` of the checkout
    `root`, given the whole object. Either returns the flat uint8 volume
    (index z*rx*ry + y*rx + x); spec.UnknownName for a generator neither has."""
    name = vol_cfg["generator"]
    make = spec.load_named("volumes", name, root, inputs.VOLUMES)
    return functools.partial(make, vol_cfg["vres"] if name in inputs.VOLUMES else vol_cfg)


def entry_point(name: str, root: str):
    """`ENTRIES[name]`, else `make` of `entrypoints/<name>.py` of the
    checkout `root`: f(scene) -> the frame's call; spec.UnknownName for an
    entry neither has."""
    return spec.load_named("entrypoints", name, root, ENTRIES)
