"""The multi-device paths over every card of the host, against one card.

    python -m raymarchcl_tpu_torch.scripts.multi_card

Renders the main path (gyroid 256^3, 512x512, 16 spp, `ao`, brick table)
on cuda:0 alone, then in one process over all the cards: tiled
(parallel/tiling.render_image_tiled over make_mesh()), pass-sharded
(render_image_spp_sharded) and over a 2 x n/2 (passes, tiles) mesh
(render_image_2d); then tiled by one process a card in an NCCL group
(scripts/render_tiled.py). Each path's frames are timed on the host clock,
each ending when every card is done (median of 5 after a warm-up). Prints
one JSON line: the card's name and power limit, each path's frames, and
whether it agrees with the single card's frame (tiled: the same sha256;
pass-sharded: within rtol=2e-5, atol=1e-6, as tests/test_parallel.py).
Exits 1 if a path disagrees. Needs at least 2 cards.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _frames(fn, devs, n=5):
    fn()
    for d in devs:
        torch.cuda.synchronize(d)
    out, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = fn()
        for d in devs:
            torch.cuda.synchronize(d)
        out.append(time.perf_counter() - t0)
    return out, res


def _sha(a):
    return hashlib.sha256((a.cpu().numpy() if torch.is_tensor(a) else a).tobytes()).hexdigest()


def _nccl_processes(n):
    """scripts/render_tiled.py in n processes, one card each (NCCL)."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "raymarchcl_tpu_torch.scripts.render_tiled"],
                              cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    seconds = time.perf_counter() - t0
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"render_tiled exited {p.returncode}: {err[-2000:]}")
    return seconds, [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def main():
    from .. import api, runtime
    from ..convert import volume_on
    from ..ops import render
    from ..ops.camera import compute_eyepos
    from ..ops.sampling import make_mc_tables
    from ..options import render_options
    from ..parallel import tiling

    cards = runtime.devices()
    if len(cards) < 2:
        print(f"multi_card: needs >= 2 cards, found {len(cards)}", file=sys.stderr)
        return 2
    smi = runtime.card().splitlines()
    runtime.build()
    vol_np, res = api.default_volume(256)
    opts = render_options(width=512, height=512, iter=16, vres=list(res), mat="ao",
                          eyepos=compute_eyepos(135, 2.25, 0.35), targetpos=[0, -0.4, 0])
    vol = volume_on(vol_np, cards[0])
    bricks = api.build_accel_for(vol, opts)
    tables = make_mc_tables(16, seed=0, device=cards[0])
    out = {"cards": smi, "count": len(cards)}
    one, (argb_1, acc_1) = _frames(lambda: render.render_image(vol, opts, tables, accel=bricks),
                                   cards[:1])
    out["one card"] = {"frames_s": one, "accum_sha256": _sha(acc_1), "argb_sha256": _sha(argb_1)}
    ok = True
    mesh = tiling.make_mesh()
    paths = {"tiled": (tiling.render_image_tiled, mesh),
             "spp": (tiling.render_image_spp_sharded, mesh),
             "2d": (tiling.render_image_2d, tiling.make_mesh2d(2, len(cards) // 2))}
    for name, (fn, m) in paths.items():
        fr, (argb, acc) = _frames(lambda: fn(vol, opts, tables, mesh=m, accel=bricks), cards)
        acc = acc[: opts.num_pixels].to(cards[0])
        if name == "tiled":
            agree = _sha(acc) == _sha(acc_1) and _sha(argb) == _sha(argb_1)
        else:
            agree = bool(torch.allclose(acc, acc_1, rtol=2e-5, atol=1e-6))
        ok &= agree
        out[name] = {"frames_s": fr, "agree": agree, "mesh": m.shape}
    seconds, ranks = _nccl_processes(len(cards))
    agree = all((r["accum_sha256"], r["argb_sha256"]) == (_sha(acc_1), _sha(argb_1))
                for r in ranks)
    ok &= agree
    out["nccl processes"] = {"process_s": seconds, "render_s": [r["seconds"] for r in ranks],
                             "devices": [r["device"] for r in ranks], "agree": agree}
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
