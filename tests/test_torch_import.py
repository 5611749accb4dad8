"""Import hygiene of the PyTorch port: no module of raymarchcl_tpu_torch
imports jax or raymarchcl_tpu, and importing builds no kernel."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import raymarchcl_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "raymarchcl_tpu.")) or m == "raymarchcl_tpu")
from raymarchcl_tpu_torch.ops.kernels import build
print(json.dumps({"mods": mods, "bad": bad, "loaded": build._lib is not None}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["mods"]) >= 38, out.stdout  # every module was imported
    assert {"raymarchcl_tpu_torch.ops.accel", "raymarchcl_tpu_torch.ops.kernels.prims",
            "raymarchcl_tpu_torch.scripts.bench_prims", "raymarchcl_tpu_torch.models.mesh",
            "raymarchcl_tpu_torch.options_codec", "raymarchcl_tpu_torch.compat",
            "raymarchcl_tpu_torch.io.checkpoint", "raymarchcl_tpu_torch.runtime",
            "raymarchcl_tpu_torch.__main__",
            "raymarchcl_tpu_torch.scripts.run_config5",
            "raymarchcl_tpu_torch.parallel.tiling", "raymarchcl_tpu_torch.parallel.distributed",
            "raymarchcl_tpu_torch.utils.metrics", "raymarchcl_tpu_torch.utils.stats",
            "raymarchcl_tpu_torch.scripts.gallery",
            "raymarchcl_tpu_torch.scripts.render_tiled", "raymarchcl_tpu_torch.scripts.bench",
            "raymarchcl_tpu_torch.scripts.run_configs", "raymarchcl_tpu_torch.scripts.bench_anim",
            "raymarchcl_tpu_torch.scripts.preview_quality",
            "raymarchcl_tpu_torch.scripts.digests"} <= set(res["mods"])
    assert res["bad"] == [], f"port imported {res['bad']}"
    assert not res["loaded"]  # no kernel library loaded at import
