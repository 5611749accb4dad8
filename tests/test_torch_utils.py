"""The port's utils (raymarchcl_tpu_torch/utils/metrics.py and stats.py)
against the JAX package's on the same inputs: the ray-budget model and
frame reports, the measured primary hit fraction (exactly), and the eager
sphere-trace occupancy (rounds and per-ray rounds exactly). The JAX
package's hit fractions and occupancy are read from tests/jax_answers.

The gallery (raymarchcl_tpu_torch/scripts/gallery.py) is not run here: at
16x9 its four reflective and DOF images take about a minute of the plain
version on the CPU. chip_smoke.py runs it at its defaults on the card."""

import numpy as np
import pytest
import torch

import jax_answers
from raymarchcl_tpu.models import generators as j_generators
from raymarchcl_tpu.ops import sampling as j_sampling
from raymarchcl_tpu.ops.accel import build_accel as j_build_accel
from raymarchcl_tpu.options import render_options as j_render_options
from raymarchcl_tpu.utils import metrics as j_metrics
from raymarchcl_tpu.utils import stats as j_stats
from raymarchcl_tpu_torch.convert import accel_from_numpy, volume_from_numpy
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.vecmath import V3
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.utils import metrics, stats

torch.set_num_threads(1)

VRES = [32, 32, 96]
# the main path's camera, which sees ground or volume everywhere, and one
# tilted up, which sees the sky over the volume
CAMERAS = {"main": dict(eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0]),
           "up": dict(eyepos=compute_eyepos(45.0, 2.0, 0.1), targetpos=[0, 0.9, 0])}
OCCUPANCY = dict(width=16, height=12, vres=VRES, iter=1, mat="ao", maxIter=48, maxVoxelIter=96,
                 **CAMERAS["up"])


def hit_fraction_kw(cam):
    return dict(width=24, height=16, vres=VRES, iter=1, mat="ao", **CAMERAS[cam])


def table0():
    """The MC table both packages take (pass 0 of seed 0)."""
    return np.asarray(j_sampling.make_mc_tables(1, seed=0)[0])


def _both(**kw):
    return j_render_options(**kw), render_options(**kw)


@pytest.mark.parametrize("mat", ["ao", "metal"])
def test_ray_budget_and_report_match_jax(mat):
    jo, opts = _both(width=64, height=48, vres=VRES, iter=4, mat=mat)
    for spp in (None, 7):
        assert metrics.primary_rays(opts, spp) == j_metrics.primary_rays(jo, spp)
        for hf in (1.0, 0.37):
            assert metrics.estimated_total_rays(opts, spp, hf) == \
                j_metrics.estimated_total_rays(jo, spp, hf)
    kw = dict(width=64, height=48, spp=4, preset=mat, seconds=0.0123, device="cuda:0",
              extras={"hit_fraction": 0.5})
    got, want = metrics.FrameReport(**kw), j_metrics.FrameReport(**kw)
    assert got.to_dict() == want.to_dict() and got.json() == want.json()
    assert str(got) == str(want)
    with metrics.Timer() as t:
        pass
    assert t.seconds >= 0.0


@pytest.fixture(scope="module")
def volume():
    vol = j_generators.make_gyroid_volume({"vres": VRES})
    jo = j_render_options(vres=VRES)
    rows = np.asarray(j_build_accel(vol, jo.voxelRes, jo.isoVal).rows)
    return vol, rows


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("with_table", [False, True])
def test_measured_hit_fraction_equals_jax(volume, cam, with_table):
    vol, rows = volume
    kw, table = hit_fraction_kw(cam), table0()
    opts = render_options(**kw)
    want = float(jax_answers.load(
        f"utils-hit-fraction-{cam}-{'table' if with_table else 'raw'}",
        jax_answers.digest(vol, table, kw, *([rows] if with_table else [])))["hit_fraction"])
    t_acc = accel_from_numpy(rows) if with_table else None
    got = metrics.measured_hit_fraction(volume_from_numpy(vol), opts,
                                        torch.from_numpy(table.copy()), t_acc)
    assert got == want
    assert 0.0 < got <= 1.0


def test_raymarch_occupancy_equals_jax(volume):
    """Both loops march the same rays (the JAX camera's, handed over as
    numpy): the rounds, the active fraction of each round and each ray's
    round of completion agree exactly."""
    vol, rows = volume
    opts = render_options(**OCCUPANCY)
    want = jax_answers.load("utils-occupancy", jax_answers.digest(vol, table0(), OCCUPANCY))
    pos, rdir = want["pos"], want["rdir"]
    act = np.ones(opts.num_pixels, bool)
    got = stats.raymarch_occupancy(volume_from_numpy(vol), opts,
                                   V3(*torch.from_numpy(pos)), V3(*torch.from_numpy(rdir)),
                                   opts.maxDist, opts.maxIter, torch.from_numpy(act),
                                   accel=accel_from_numpy(rows))
    assert got["rounds"] == int(want["rounds"]) > 1
    assert got["active_frac"] == want["active_frac"].tolist()
    np.testing.assert_array_equal(got["steps_used"], want["steps_used"])
    assert got["wasted_lane_ratio"] == float(want["wasted_lane_ratio"])
    assert stats.histogram_report(got["steps_used"]) == \
        j_stats.histogram_report(want["steps_used"])
