"""Preview mode's cost and quality on the card: the same scene rendered with
the full reference budgets and with api.PREVIEW_BUDGETS, their times, the
speed-up and the SSIM of the preview against the full render.

    python -m raymarchcl_tpu_torch.scripts.preview_quality [--size 256]
        [--vres 256] [--mat ao] [--spp 4] [--device cuda]

Counterpart of the JAX package's scripts/preview_quality.py. The volume is
built once and each render's brick table before its timing, so a time is
the render alone: the second of two frames, from a zeroed accum to the
packed image on the host. SSIM: uniform 8x8 windows, the standard K1/K2
constants, per RGB channel of the packed bytes, averaged.
"""

from __future__ import annotations

import argparse

import numpy as np


def ssim(a, b, window=8, k1=0.01, k2=0.03, L=255.0):
    """Mean SSIM over non-overlapping window x window blocks."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    h, w = a.shape[:2]
    h, w = h - h % window, w - w % window
    a, b = a[:h, :w], b[:h, :w]

    def blocks(x):
        return x.reshape(h // window, window, w // window, window, -1).transpose(
            0, 2, 4, 1, 3
        ).reshape(h // window, w // window, -1, window * window)

    ba, bb = blocks(a), blocks(b)
    mu_a, mu_b = ba.mean(-1), bb.mean(-1)
    var_a, var_b = ba.var(-1), bb.var(-1)
    cov = (ba * bb).mean(-1) - mu_a * mu_b
    c1, c2 = (k1 * L) ** 2, (k2 * L) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())


def argb_to_rgb(argb):
    return np.stack(
        [(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF], axis=-1
    ).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description="preview budgets against the full budgets")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--vres", type=int, default=256)
    ap.add_argument("--mat", default="ao")
    ap.add_argument("--spp", type=int, default=4, help="full-quality spp")
    ap.add_argument("--device", default="cuda", help="torch device (cuda|cpu)")
    args = ap.parse_args(argv)

    from .. import api
    from ..convert import volume_on
    from ..ops.camera import compute_eyepos
    from ..options import render_options
    from ..runtime import check_device
    from .bench import make_scene, timed_frame

    dev = check_device(args.device)
    volume, vres3 = api.default_volume((args.vres,) * 3)
    vol = volume_on(volume, dev)
    base_kw = dict(width=args.size, height=args.size, vres=list(vres3), mat=args.mat,
                   eyepos=compute_eyepos(135.0, 2.25, 0.35), targetpos=[0, -0.4, 0])

    def render_timed(preview, n_iter, tag):
        kw = dict(base_kw)
        if preview:
            merged, n_iter = api.preview_overrides({}, n_iter)
            kw.update(merged)
        opts = render_options(iter=n_iter, **kw)
        dt, argb, _ = timed_frame(make_scene(vol, opts, n_iter, args.mat, dev))
        print(f"  {tag}: {dt:.6f}s", flush=True)
        return argb, dt

    full, t_full = render_timed(False, args.spp, f"full ({args.spp} spp, ref budgets)")
    prev, t_prev = render_timed(True, 1, "preview (1 spp, quarter budgets)")
    s = ssim(argb_to_rgb(full), argb_to_rgb(prev))
    print(f"size={args.size} vres={args.vres} mat={args.mat}: full={t_full:.6f}s "
          f"preview={t_prev:.6f}s speedup={t_full / t_prev:.1f}x SSIM={s:.4f}")
    return {"full_s": t_full, "preview_s": t_prev, "speedup": t_full / t_prev, "ssim": s}


if __name__ == "__main__":
    main()
