"""Multi-device rendering: shard the pixel grid, or the passes, over devices.

Counterpart of `raymarchcl_tpu/parallel/tiling.py`, with its public names
and return shapes. The reference is strictly single-GPU (core.clj:121-123
picks one device); its parallelism is one work-item per pixel. The
scale-out axis is the same data parallelism lifted across cards: the flat
pixel axis is cut into one contiguous band a device, the voxel volume, MC
tables and options are replicated (a 256^3 volume is 16.8 MB), and the
only communication is the gather of finished bands. Equal pixels are not
equal work (the ground near the camera marches longest), so where the
bands' device times are measured, each frame's bands are cut from the
times of the frames before it to take equal time (`_Bands`).

Pixel identity drives the jitter seeds, so each band renders its GLOBAL
pixel ids, through one K2 launch over its pixel range
(ops/kernels/render_pass.render_passes(pix_lo=, pix_count=)): a tiled
render equals the single-device render bit for bit. The pass (spp) axis
shards too, merged with the closed-form weights of the exponential blend.

A mesh lists devices, which may repeat: the shards of one device run one
after another on it (this is how the tests run on the CPU and how
chip_smoke.py runs a 4-tile mesh on one card). In a process group
(parallel/distributed.py) a mesh spans the ranks and each rank renders its
own entries only; the results are gathered (tiles) or summed (pass shards)
so that every rank holds the whole accum and image.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import runtime
from ..convert import accum_on, tables_on, volume_on
from ..ops import render as render_mod
from ..ops.accel import Accel
from ..ops.kernels.render_pass import pass_times
from ..utils.metrics import span
from . import distributed

AXIS = "tiles"
PASS_AXIS = "passes"

# Bytes the tiled and pass-sharded entries moved to or from a device other
# than their mesh's home (the replicas; the accum and image tiles out and
# back; the pass shards' parts), and the calls of those entries. The
# collectives of a process group are not counted.
COPIED_BYTES = 0
CALLS = 0

# Pixel rows of K2's warp tiles (csrc/render_pass.cu kTileH): a band cut on
# a multiple of them keeps every tile whole.
STRIP_ROWS = 4
# The weight of a frame's measured band times in each strip's cost.
NEW_COST_WEIGHT = 0.5


@dataclass(frozen=True)
class Mesh:
    """Devices of a render split, one entry a shard, in row-major order over
    `axis_names` (`make_mesh`: tiles; `make_mesh2d`: passes x tiles).

    ranks: None in one process; in a process group, the rank that renders
    each entry, and `devices` holds this process's device at its own
    entries (None at the others). home: the device where this process
    keeps the whole accum and image."""

    devices: tuple
    axis_names: tuple
    dims: tuple
    home: torch.device
    ranks: tuple | None = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh's `shape`."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_entries(self) -> list:
        """The entries this process renders."""
        if self.ranks is None:
            return list(range(self.size))
        rank = distributed.process_info()[0]
        return [i for i, r in enumerate(self.ranks) if r == rank]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _group_mesh(size, axis_names, dims, devices) -> Mesh:
    """A mesh over the first `size` ranks of the process group, this
    process on devices[0] (default its card, distributed.local_device)."""
    rank, world, _ = distributed.process_info()
    if world < size:
        raise ValueError(f"a mesh of {size} entries needs {size} ranks, the group has {world}")
    home = _device(devices[0]) if devices else distributed.local_device()
    return Mesh(tuple(home if r == rank else None for r in range(size)), axis_names, dims, home,
                tuple(range(size)))


def make_mesh(devices=None, n=None) -> Mesh:
    """1-D pixel-tile mesh over the given devices (default every CUDA card,
    runtime.devices(), which raises without one), the first n of them if
    n is given. In a process group the mesh spans the ranks, one tile a
    rank; `devices` then names this process's own device (its first entry)
    and n, if given, must be the group's size."""
    if distributed.is_initialized():
        world = distributed.process_info()[1]
        if n is not None and n != world:
            raise ValueError(f"in a process group the tile mesh spans its {world} ranks, not {n}")
        return _group_mesh(world, (AXIS,), (world,), devices)
    devs = [_device(d) for d in (runtime.devices() if devices is None else devices)]
    if n is not None:
        devs = devs[:n]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), (AXIS,), (len(devs),), devs[0])


def make_mesh2d(n_spp, n_tiles, devices=None) -> Mesh:
    """2-D (passes, tiles) mesh over the first n_spp * n_tiles devices
    (default the CUDA cards), or, in a process group, ranks: spp sharding
    keeps each shard's passes at full-tile granularity while pixel tiling
    bounds each device's pixels."""
    size = n_spp * n_tiles
    if distributed.is_initialized():
        return _group_mesh(size, (PASS_AXIS, AXIS), (n_spp, n_tiles), devices)
    devs = [_device(d) for d in (runtime.devices() if devices is None else devices)]
    if len(devs) < size:
        raise ValueError(f"a {n_spp}x{n_tiles} mesh needs {size} devices, got {len(devs)}")
    return Mesh(tuple(devs[:size]), (PASS_AXIS, AXIS), (n_spp, n_tiles), devs[0])


class _Replicas:
    """The frame's volume, MC tables and brick table on each device that
    renders a shard, copied there once a call (no copy on their own
    device); copies to a device other than `home` count in COPIED_BYTES."""

    def __init__(self, vol, tables, accel, home):
        self._src, self._home, self._on = (vol, tables, accel), home, {}

    def on(self, dev):
        global COPIED_BYTES
        if dev not in self._on:
            vol, tables, accel = self._src
            self._on[dev] = (volume_on(vol, dev), tables_on(tables, dev),
                             None if accel is None else Accel(accel.rows.to(dev), accel.edge))
            if dev != self._home:
                COPIED_BYTES += vol.nbytes + tables.nbytes + (0 if accel is None
                                                              else accel.rows.nbytes)
        return self._on[dev]


class _Bands:
    """Where the bands of a w x h frame over n mesh entries start.

    Band t holds pixels [t * blk, (t + 1) * blk), blk = ceil(N / n), until
    a frame's band times are `record`ed. The first frame's are dropped:
    between a band's two events they hold one-time costs, such as a card's
    first load of the kernel, which would skew the cut for many frames
    after. From the second, each band's device ms is spread evenly over the strips (STRIP_ROWS pixel rows) it covers and
    blended into a cost a strip, and `offsets` cuts the next frame's bands
    on strip edges where the strips' running cost is nearest each n-th of
    its total: a split whose bands took equal times stays as it is. The
    last band always runs to n_pad = n * blk, its rows past pixel N-1
    rendering N-1 again."""

    def __init__(self, n, w, h):
        self.n, self.w, self.n_pix = n, w, w * h
        self.blk = -(-self.n_pix // n)
        self.strips = -(-h // STRIP_ROWS)
        self.cost = None  # each strip's device ms, blended over the frames
        self.frames = 0  # frames recorded

    def offsets(self) -> list:
        """The n + 1 pixel offsets of the bands in the home buffers."""
        if self.cost is None:
            return [t * self.blk for t in range(self.n + 1)]
        run = np.concatenate([[0.0], np.cumsum(self.cost)])
        edges = [0]
        for k in range(1, self.n):
            goal = run[-1] * k / self.n
            e = int(np.searchsorted(run, goal))
            e -= int(run[e] - goal > goal - run[e - 1])
            edges.append(min(max(e, edges[-1] + 1), self.strips - (self.n - k)))
        return [e * STRIP_ROWS * self.w for e in edges] + [self.n * self.blk]

    def record(self, offsets, ms):
        """The device ms of the bands that started at `offsets`."""
        self.frames += 1
        if self.frames == 1:
            return
        at = np.minimum(offsets, self.n_pix) / (STRIP_ROWS * self.w)
        spent = np.interp(np.arange(self.strips + 1), at, np.concatenate([[0.0], np.cumsum(ms)]))
        cost = np.diff(spent)
        self.cost = cost if self.cost is None else (
            (1 - NEW_COST_WEIGHT) * self.cost + NEW_COST_WEIGHT * cost)


@functools.lru_cache(maxsize=16)
def _bands(mesh, w, h) -> _Bands:
    """The bands of a mesh's w x h frames, kept across its calls."""
    return _Bands(mesh.size, w, h)


def _band_ms(marks) -> list:
    """Each band's device ms, from the events around its launch."""
    for _, end in marks:
        end.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def _times(times, n_passes):
    return render_mod.default_times(n_passes) if times is None else times


def _start_accum(accum, rows, home):
    if accum is None:
        return torch.zeros((rows, 3), dtype=torch.float32, device=home)
    accum = accum_on(accum, home)
    if accum.shape != (rows, 3):
        raise ValueError(f"accum must be ({rows}, 3) (the padded frame of this mesh), got "
                         f"{tuple(accum.shape)}")
    return accum


def render_image_tiled(vol, opts, mc_tables, times=None, accum=None, mesh=None, accel=None):
    """Drop-in tiled equivalent of ops.render.render_image.

    Band t of the mesh's n renders global pixel ids [lo_t, lo_{t+1}) on its
    device: one K2 launch over that pixel range, which packs the band's
    image; rows past pixel N-1 render N-1 again. The bands start where
    `_Bands` says: equal, blk = ceil(N / n) pixels, until the mesh has
    rendered a frame of this size with its band times measured (every
    entry a CUDA card, in one process), then cut to take equal time.
    Returns (argb (H, W) uint32 numpy, accum (n_pad, 3) float32 on the
    mesh's home device), n_pad = n * blk; feed accum back in to refine
    progressively. An accum passed in on the home device is updated in
    place."""
    global CALLS, COPIED_BYTES
    with span("rmcl.render_image_tiled"):
        CALLS += 1
        mesh = make_mesh() if mesh is None else mesh
        bands = _bands(mesh, *opts.resolution)
        off = bands.offsets()
        timed = (mesh.ranks is None and mesh.size > 1 and bands.strips >= mesh.size
                 and all(d.type == "cuda" for d in mesh.devices))
        times = _times(times, mc_tables.shape[0])
        accum = _start_accum(accum, off[-1], mesh.home)
        argb = torch.empty(off[-1], dtype=torch.int32, device=mesh.home)
        replicas = _Replicas(vol, mc_tables, accel, mesh.home)
        # Every band's inputs go to its device before any band launches: a
        # cross-card copy is queued on the source card's current stream, so
        # a copy made after the home band's launch would wait for its
        # kernel, and that band's device with it.
        staged = []
        for t in mesh.local_entries():
            dev, lo, hi = mesh.devices[t], off[t], off[t + 1]
            with span("rmcl.tiling.inputs"):
                acc_t, argb_t = accum[lo:hi].to(dev), argb[lo:hi].to(dev)
                staged.append((lo, hi, acc_t, argb_t, replicas.on(dev)))
            if dev != mesh.home:
                COPIED_BYTES += acc_t.nbytes + argb_t.nbytes
        marks = []
        for lo, hi, acc_t, argb_t, (v, tabs, bricks) in staged:
            with span("rmcl.tiling.tile"):
                if timed:
                    marks.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                    marks[-1][0].record(torch.cuda.current_stream(acc_t.device))
                render_mod.render_passes(v, opts, tabs, times, acc_t, bricks, argb_t,
                                         pix_lo=lo, pix_count=hi - lo)
                if timed:
                    marks[-1][1].record(torch.cuda.current_stream(acc_t.device))
        with span("rmcl.tiling.gather"):
            for lo, hi, acc_t, argb_t, _ in staged:  # bands rendered off the home device come back
                if acc_t.device != mesh.home:
                    accum[lo:hi].copy_(acc_t)
                    argb[lo:hi].copy_(argb_t)
                    COPIED_BYTES += acc_t.nbytes + argb_t.nbytes
            if mesh.ranks is not None:  # equal bands: all_gather_rows takes equal parts
                (lo, hi, *_), = staged
                accum = distributed.all_gather_rows(accum[lo:hi])
                argb = distributed.all_gather_rows(argb[lo:hi])
        image = render_mod.host_image(opts, argb)
        if timed:  # the readback waited for every band's copy, so for its launch
            bands.record(off, _band_ms(marks))
        return image, accum


def _pass_sharded(vol, opts, mc_tables, times, accum, mesh, accel):
    """Entry (k, t) of a (passes, tiles) mesh renders passes [k*blk_p,
    (k+1)*blk_p) of pixel tile t from a zero buffer. Its blend weights pass
    j of its own (fb)(1-fb)^(blk_p-1-j); the global blend wants exponent
    (n_passes-1) - (k*blk_p+j) = (blk_p-1-j) + blk_p*(n_sp-1-k), so the
    shard is re-weighted by (1-fb)^(blk_p*(n_sp-1-k)) (float32 pow, as the
    JAX package computes it) before the sum, and an incoming accum survives
    all n_passes blends. The image is packed by K1 alone. Returns (argb
    (H, W), accum (n_pad, 3))."""
    global CALLS, COPIED_BYTES
    CALLS += 1
    n_sp, n_tiles = mesh.dims if len(mesh.dims) == 2 else (mesh.size, 1)
    n_passes = mc_tables.shape[0]
    if n_passes % n_sp != 0:
        raise ValueError(f"spp sharding needs n_passes ({n_passes}) divisible by the mesh's "
                         f"pass dimension ({n_sp}); pad the pass axis or use pixel tiling")
    blk_p = n_passes // n_sp
    blk = -(-opts.num_pixels // n_tiles)
    times = pass_times(_times(times, n_passes))
    accum = _start_accum(accum, blk * n_tiles, mesh.home)
    keep = (1.0 - opts.frameBlend).to(torch.float32)

    def weight(e):
        # (1-fb)^e as a float32 pow on the host (a python float, so that no
        # device waits for a copy of it)
        return float(torch.pow(keep, torch.tensor(float(e), dtype=torch.float32)))

    total = torch.zeros_like(accum)
    replicas = _Replicas(vol, mc_tables, accel, mesh.home)
    for i in mesh.local_entries():
        k, t = divmod(i, n_tiles)
        dev = mesh.devices[i]
        with span("rmcl.tiling.tile"):
            with span("rmcl.tiling.inputs"):
                v, tabs, bricks = replicas.on(dev)
                part = torch.zeros((blk, 3), dtype=torch.float32, device=dev)
            ps = slice(k * blk_p, (k + 1) * blk_p)
            render_mod.render_passes(v, opts, tabs[ps], times[ps], part, bricks,
                                     pix_lo=t * blk, pix_count=blk)
        with span("rmcl.tiling.gather"):
            total[t * blk:(t + 1) * blk] += (part * weight(blk_p * (n_sp - 1 - k))).to(mesh.home)
            if dev != mesh.home:
                COPIED_BYTES += part.nbytes
    if mesh.ranks is not None:
        with span("rmcl.tiling.gather"):
            distributed.all_reduce_sum(total)
    total += accum * weight(n_passes)
    return render_mod.host_image(opts, render_mod.pack_argb(opts, total)), total


def render_image_spp_sharded(vol, opts, mc_tables, times=None, accum=None, mesh=None,
                             accel=None):
    """Shard the PASS (spp) axis over the mesh (reference pass loop:
    core.clj:82-90), the other embarrassingly parallel axis: each shard
    keeps the whole frame. Shard k renders passes [k*blk, (k+1)*blk) from a
    zero buffer; the re-weighted shards are summed (`_pass_sharded`). The
    weights are exact, but the sum is another evaluation order than the
    sequential blend, so it agrees with render_image to float32 rounding,
    not bit for bit. Requires n_passes % mesh size == 0 (ValueError
    otherwise).

    Returns (argb (H, W) uint32 numpy, accum (N, 3) float32 on the mesh's
    home device; feed it back in for progressive refinement)."""
    mesh = make_mesh() if mesh is None else mesh
    return _pass_sharded(vol, opts, mc_tables, times, accum, mesh, accel)


def render_image_2d(vol, opts, mc_tables, times=None, accum=None, mesh=None, accel=None):
    """Pass x pixel sharding over a 2-D (passes, tiles) mesh (make_mesh2d;
    default 2 x n/2 of the n CUDA cards, or ranks): entry (k, t) renders
    passes [k*blk_p, (k+1)*blk_p) of pixel tile t from a zero buffer; the
    re-weighted blends are summed down each tile's pass column (the same
    float32 story as render_image_spp_sharded).

    Returns (argb (H, W) uint32 numpy, accum (n_pad, 3) for progressive
    refinement)."""
    if mesh is None:
        n_dev = (distributed.process_info()[1] if distributed.is_initialized()
                 else len(runtime.devices()))
        if n_dev < 2:
            raise ValueError("render_image_2d needs >= 2 devices")
        mesh = make_mesh2d(2, n_dev // 2)
    return _pass_sharded(vol, opts, mc_tables, times, accum, mesh, accel)
