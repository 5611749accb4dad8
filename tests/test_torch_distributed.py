"""The port's process-group path (raymarchcl_tpu_torch/parallel/distributed.py
with parallel/tiling.py), for real: two processes of
raymarchcl_tpu_torch.scripts.render_tiled join a gloo group on localhost
through torchrun's variables, each renders its tile of a small frame on the
CPU, and both must hold the whole image, bit-equal to a single-process
render (the multi-process claim of tests/distributed_worker.py). Skips only
when no localhost socket can be bound."""

import hashlib
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from raymarchcl_tpu_torch import api
from raymarchcl_tpu_torch.convert import volume_from_numpy
from raymarchcl_tpu_torch.ops import render
from raymarchcl_tpu_torch.ops.camera import compute_eyepos
from raymarchcl_tpu_torch.ops.sampling import make_mc_tables
from raymarchcl_tpu_torch.options import render_options
from raymarchcl_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = dict(width=24, height=16, iter=2, vres=16)


def _free_port():
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def test_initialize_unconfigured_is_a_noop(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_initialized()
    assert distributed.process_info()[:2] == (0, 1)


def test_two_process_tiled_render():
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no localhost socket can be bound")
    argv = [f"--{k}={v}" for k, v in FRAME.items()] + ["--device=cpu", "--backend=gloo"]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-m", "raymarchcl_tpu_torch.scripts.render_tiled",
                               *argv], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]

    vol_np, vres = api.default_volume(FRAME["vres"], cache=False)
    opts = render_options(width=FRAME["width"], height=FRAME["height"], iter=FRAME["iter"],
                          vres=list(vres), mat="ao", targetpos=[0, -0.4, 0],
                          eyepos=compute_eyepos(135, 2.25, 0.35))
    vol = volume_from_numpy(vol_np)
    argb, accum = render.render_image(vol, opts, make_mc_tables(FRAME["iter"], seed=0),
                                      accel=api.build_accel_for(vol, opts))
    want = (hashlib.sha256(accum.numpy().tobytes()).hexdigest(),
            hashlib.sha256(argb.tobytes()).hexdigest())
    for r, got in enumerate(res):
        assert got["rank"] == r and got["world"] == 2 and got["local_devices"] == (
            torch.cuda.device_count() if torch.cuda.is_available() else 1)
        assert got["initialize"] == [True, False]  # the second call is a no-op
        assert (got["accum_sha256"], got["argb_sha256"]) == want
