"""Import hygiene: nothing the benchmark runs is JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from rmcl_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "raymarchcl_tpu"}
REFERENCE_MAY = {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}


def _imports(path):
    """(level, top-level name) of each import statement of a file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield node.level, (node.module or "").split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for level, top in _imports(path):
            assert level or top not in FORBIDDEN, (path, top)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for level, top in _imports(path):
            if level:
                assert level == 1, (path, "leaves reference/")
            else:
                assert top in REFERENCE_MAY, (path, top)


def _loaded_after(code, cwd):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    """A whole run (set-up, window, trace, check) in a fresh process."""
    code = ("import time; from rmcl_bench import run\n"
            f"r = run.run('tiny-ao.still8', 7, 0.0, True, device='cpu', root={tiny_root!r},"
            " t_start=time.perf_counter(), log=lambda *a: None)\n"
            "assert r['correct']\n")
    loaded = _loaded_after(code, spec.ROOT)
    assert not loaded & FORBIDDEN
    assert "raymarchcl_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    code = ("import numpy as np, torch\n"
            "from rmcl_bench.reference.options import frame_options\n"
            "from rmcl_bench.reference.render import reference_pixels\n"
            "from rmcl_bench.reference.vecmath import V3\n"
            "o = frame_options(4, 4, 16, 1, 'metal')\n"
            "vol = torch.zeros(16 ** 3, dtype=torch.uint8)\n"
            "t = torch.nn.functional.normalize(torch.rand(1, 16384, 4) - 0.5, dim=-1)\n"
            "reference_pixels(vol, o, t, torch.zeros(1), torch.tensor([[0.0, 0.3, 2.0]]),"
            " torch.arange(16)[None])\n")
    loaded = _loaded_after(code, spec.ROOT)
    assert not loaded & (FORBIDDEN | {"raymarchcl_tpu_torch"})
