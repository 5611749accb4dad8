"""Observability: timers, throughput metrics, structured frame reports.

Counterpart of `raymarchcl_tpu/utils/metrics.py`. The reference's
instrumentation is `(time ...)` wrappers and progress prns
(core.clj:133/171/175/191/203, SURVEY.md §5). Here: a monotonic Timer, a
ray-throughput model (primary + the secondary-ray budget from the
reference's cost model), and structured per-frame reports.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch

from ..ops.camera import camera_ray_lookat
from ..ops.march import raymarch
from ..ops.sampling import init_render_state


class Timer:
    """Context-manager stopwatch: `with Timer() as t: ...; t.seconds`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def primary_rays(opts, spp=None):
    w, h = opts.resolution
    return w * h * (spp if spp is not None else round(1.0 / float(opts.frameBlend)))


def estimated_total_rays(opts, spp=None, hit_fraction=1.0):
    """Primary + per-hit secondary rays (shadow per light, AO probes,
    reflection bounces each re-shading) — the reference's per-ray budget
    model (BASELINE.md 'per-ray compute budgets').

    hit_fraction scales the secondary-ray term by the measured fraction of
    primary rays that hit geometry (misses spawn no shadows/AO/bounces —
    renderer.cl:480-487 shades sky/fog only). The default 1.0 keeps the
    historical upper-bound model; pass measured_hit_fraction(...) for the
    honest variant. First-order: bounce rays that themselves miss are still
    charged their full secondary budget."""
    p = primary_rays(opts, spp)
    per_hit = opts.numLights + (opts.aoIter + 1)
    per_hit += opts.reflectIter * (1 + opts.numLights + (opts.aoIter + 1))
    return p * (1 + hit_fraction * per_hit)


def mean_f32(mask: torch.Tensor) -> float:
    """The float32 mean of a boolean tensor as the JAX package's jnp.mean
    computes it: XLA turns the division by the count into a product with
    its float32 reciprocal, which can round one ulp away from the
    quotient."""
    return float(mask.float().sum() * torch.tensor(1.0 / mask.numel(), dtype=torch.float32))


def measured_hit_fraction(vol, opts, mc_table, accel=None):
    """Fraction of primary rays hitting geometry (distance < maxDist) for
    ONE pass at the given config: the measurement input for the honest
    total-rays model above. One primary march of all pixels with the fast
    normal's march (smooth=False, no normal), as the JAX package's; a hit
    is distance < maxDist, which the normal does not change. vol, mc_table
    (T, 4) and accel live on one device; on a CUDA device this is the
    plain PyTorch march on CUDA tensors (a diagnostic, not the render
    path)."""
    ids = torch.arange(opts.num_pixels, device=vol.device)
    state = init_render_state(opts, mc_table, ids)
    ray_pos, ray_dir = camera_ray_lookat(opts, state)
    act = torch.ones(ids.shape[0], dtype=torch.bool, device=vol.device)
    isec = raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, act,
                    want_normal=False, accel=accel, smooth=False)
    return mean_f32(isec["distance"] < opts.maxDist)


@dataclass
class FrameReport:
    """Structured render telemetry, json-serializable."""

    width: int
    height: int
    spp: int
    preset: str
    seconds: float
    device: str
    extras: dict = field(default_factory=dict)

    @property
    def mrays_per_sec(self):
        return self.width * self.height * self.spp / self.seconds / 1e6

    def to_dict(self):
        d = {
            "width": self.width,
            "height": self.height,
            "spp": self.spp,
            "preset": self.preset,
            "seconds": round(self.seconds, 4),
            "mrays_per_sec": round(self.mrays_per_sec, 3),
            "device": self.device,
        }
        d.update(self.extras)
        return d

    def json(self):
        return json.dumps(self.to_dict())

    def __str__(self):
        return (
            f"{self.width}x{self.height} @ {self.spp} spp [{self.preset}] "
            f"{self.seconds:.3f}s ({self.mrays_per_sec:.2f} Mrays/s primary)"
        )
