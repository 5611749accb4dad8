"""The march (renderer.cl:146-257): box intersection, voxel sampling, the
fixed-step volume march, the sphere trace and the smooth and fast voxel
normals. Rays are V3 triples of flat (L,) tensors run in lock step with
masks; the fixed-step march tests MARCH_CHUNK samples a round."""

from __future__ import annotations

import numpy as np
import torch

from .vecmath import V3, f2i_sat, fma, fma3, norm, normalize, where3

MARCH_CHUNK = 16


def dist_union(d1, m1, d2, m2):
    """renderer.cl:146-148: the strictly smaller distance (ties -> second)."""
    take1 = d1 < d2
    return torch.where(take1, d1, d2), torch.where(take1, m1, m2)


def intersects_box(bmin, bmax, p: V3, d: V3):
    """Slab test (renderer.cl:153-161): entry distance, or -1.0 on a miss,
    with NaN-suppressing fmin/fmax."""
    a = torch.zeros_like(p.x)
    b = None
    for c in range(3):
        o1 = (bmin[c] - p[c]) / d[c]
        o2 = (bmax[c] - p[c]) / d[c]
        a = torch.maximum(a, torch.fmin(o1, o2))
        hi = torch.fmax(o1, o2)
        b = hi if b is None else torch.minimum(b, hi)
    return torch.where(b > a, a, -1.0)


def voxel_coord(opts, p: V3) -> V3:
    """renderer.cl:165: truncation toward zero, saturating."""
    rx, ry, rz, _ = opts.voxelRes
    return V3(f2i_sat(p.x * float(rx)), f2i_sat(p.y * float(ry)), f2i_sat(p.z * float(rz)))


def _bounds_and_index(opts, q: V3):
    rx, ry, rz, rxy = opts.voxelRes
    valid = (q.x >= 0) & (q.x < rx) & (q.y >= 0) & (q.y < ry) & (q.z >= 0) & (q.z < rz)
    return valid, torch.where(valid, q.z * rxy + q.y * rx + q.x, 0)


def voxel_fetch(vol, opts, q: V3):
    """Byte value (int64, -1 outside the grid)."""
    valid, idx = _bounds_and_index(opts, q)
    return torch.where(valid, vol[idx].long(), -1)


def occupancy_i(vol, opts, q: V3):
    """renderer.cl:172-178: 1.0 where v >= isoVal."""
    valid, idx = _bounds_and_index(opts, q)
    return (valid & (vol[idx] >= opts.isoVal)).float()


def voxel_material(v):
    """renderer.cl:205-207."""
    return torch.where(v < 84, 1.0, torch.where(v < 168, 2.0, 3.0))


_r5 = np.arange(-2, 3)
_OFF5 = [torch.from_numpy(o.reshape(-1).copy())
         for o in np.meshgrid(_r5, _r5, _r5, indexing="ij")]


def voxel_normal_fast(vol, opts, q: V3) -> V3:
    """renderer.cl:180-188, 228."""
    def occ(dx, dy, dz):
        return occupancy_i(vol, opts, V3(q.x + dx, q.y + dy, q.z + dz))

    n = V3(occ(1, 0, 0) - occ(-1, 0, 0), occ(0, 1, 0) - occ(0, -1, 0),
           occ(0, 0, 1) - occ(0, 0, -1))
    return normalize(-n)


def voxel_normal_smooth(vol, opts, q: V3) -> V3:
    """renderer.cl:190-203: gradient normals summed over the occupied
    3x3x3 neighbourhood (integer-valued sums: exact in any order)."""
    ox, oy, oz = (o.to(q.x.device)[:, None] for o in _OFF5)
    occ = occupancy_i(vol, opts, V3(q.x[None] + ox, q.y[None] + oy, q.z[None] + oz))
    occ = occ.reshape((5, 5, 5) + q.x.shape)
    c = occ[1:4, 1:4, 1:4]
    gx = occ[2:5, 1:4, 1:4] - occ[0:3, 1:4, 1:4]
    gy = occ[1:4, 2:5, 1:4] - occ[1:4, 0:3, 1:4]
    gz = occ[1:4, 1:4, 2:5] - occ[1:4, 1:4, 0:3]
    w = (c > 0.0).float()
    return normalize(V3(-(w * gx).sum((0, 1, 2)), -(w * gy).sum((0, 1, 2)),
                        -(w * gz).sum((0, 1, 2))))


def march_volume(vol, opts, p0: V3, delta: V3, steps, active, max_k=None, max_k_dyn=None):
    """renderer.cl:219-234: the first sample k in [0, steps) that leaves
    the grid or exceeds isoVal, sample k at p0 + delta*k; samples k >=
    max_k (static) or >= max_k_dyn (per lane) count as not reached.
    Returns (hit, hit_k; 0 where nothing stopped)."""
    eff = steps if max_k is None else min(steps, max_k)
    n = p0.x.shape[0]
    dev = p0.x.device
    iso = opts.isoVal
    cap = torch.full((n,), eff, dtype=torch.long, device=dev)
    if max_k_dyn is not None:
        cap = torch.minimum(cap, max_k_dyn.long())
    ks = torch.arange(MARCH_CHUNK, device=dev)[:, None]
    act = active.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_k = torch.zeros(n, dtype=torch.long, device=dev)
    for k0 in range(0, eff, MARCH_CHUNK):
        if not bool(act.any()):
            break
        kabs = k0 + ks
        kf = kabs.float()
        p = V3(fma(delta.x[None], kf, p0.x[None]), fma(delta.y[None], kf, p0.y[None]),
               fma(delta.z[None], kf, p0.z[None]))
        v = voxel_fetch(vol, opts, voxel_coord(opts, p))
        stop = ((v < 0) | (v > iso)) & (kabs < cap[None])
        any_stop = stop.any(0)
        first = stop.int().argmax(0)
        newly = act & any_stop
        hit = torch.where(newly, v.gather(0, first[None])[0] > iso, hit)
        hit_k = torch.where(newly, k0 + first.long(), hit_k)
        act = act & ~any_stop & (k0 + MARCH_CHUNK < cap)
    return hit, hit_k


def distance_to_scene(vol, opts, rpos: V3, rdir: V3, steps, active, idist=None, max_k=None,
                      max_k_dyn=None, want_material=True):
    """renderer.cl:209-237: ground plane U voxel volume. The ground's
    "material" is its own distance (renderer.cl:211)."""
    gd = rpos.y + opts.groundY
    res_d, res_m = dist_union(gd, gd, torch.full_like(gd, 1e5), torch.full_like(gd, -1.0))
    if idist is None:
        idist = intersects_box(opts.voxelBoundsMin, opts.voxelBoundsMax, rpos, rdir)
    march_mask = active & (idist >= 0.0) & (idist < res_d)
    inv_s, vb = opts.invVoxelScale, opts.voxelBounds
    scale = 1.0 / (steps * 0.5)
    delta = V3(rdir.x * scale * inv_s[0], rdir.y * scale * inv_s[1],
               rdir.z * scale * inv_s[2])
    adv = torch.where(idist > 0.0, idist, 0.0)
    p0 = V3(fma(rdir.x, adv, rpos.x + vb[0]) * inv_s[0],
            fma(rdir.y, adv, rpos.y + vb[1]) * inv_s[1],
            fma(rdir.z, adv, rpos.z + vb[2]) * inv_s[2])
    hit, hit_k = march_volume(vol, opts, p0, delta, steps, march_mask, max_k=max_k,
                              max_k_dyn=max_k_dyn)
    hit_p = fma3(delta, hit_k.float(), p0)
    q = voxel_coord(opts, hit_p)
    vb2 = opts.voxelBounds2
    world = V3(hit_p.x * vb2[0] - vb[0], hit_p.y * vb2[1] - vb[1], hit_p.z * vb2[2] - vb[2])
    vdist = norm(rpos - world) - opts.voxelSize
    vmat = voxel_material(voxel_fetch(vol, opts, q)) if want_material else res_m
    hd, hm = dist_union(vdist, vmat, res_d, res_m)
    return {"dist": torch.where(hit, hd, res_d), "mat": torch.where(hit, hm, res_m),
            "hit": hit, "q": q, "gd": gd}


def isec_normal(vol, opts, hit, q, gd, rdir: V3, smooth=True):
    """renderer.cl:212: the voxel normal on a hit, +y for the ground, -dir
    for the backstop."""
    up = V3(torch.zeros_like(gd), torch.ones_like(gd), torch.zeros_like(gd))
    ground_n = where3(gd < 1e5, up, -rdir)
    vn = (voxel_normal_smooth if smooth else voxel_normal_fast)(vol, opts, q)
    return where3(hit, vn, ground_n)


def raymarch(vol, opts, ray_pos: V3, ray_dir: V3, max_dist, max_steps, active,
             want_normal=True, truncate_to_max_dist=False, smooth=True):
    """Sphere trace (renderer.cl:239-257); misses get objectID -1 and
    distance 1000. truncate_to_max_dist (shadow rays) caps each volume
    march at the samples that could still place a hit within max_dist,
    which changes no output."""
    n = ray_pos.x.shape[0]
    dev = ray_pos.x.device
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=torch.float32, device=dev),
                                  (n,))
    bmin, bmax = opts.voxelBoundsMin, opts.voxelBoundsMax
    if truncate_to_max_dist:
        f_min = min(a * b for a, b in zip(opts.invVoxelScale, opts.voxelBounds2))
        base_step = (2.0 / opts.maxVoxelIter) * f_min
        inv_steplen = 1.0 / (base_step * torch.clamp(norm(ray_dir), min=1e-20))
    act = active.clone()
    dist = torch.full((n,), float(opts.startDist), device=dev)
    obj = torch.zeros(n, dtype=torch.long, device=dev)
    pos = ray_pos
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    zero_i = torch.zeros(n, dtype=torch.long, device=dev)
    q = V3(zero_i, zero_i, zero_i)
    gd = torch.zeros(n, device=dev)
    steps = torch.zeros(n, dtype=torch.long, device=dev)
    for _ in range(max_steps):
        if not bool(act.any()):
            break
        p = fma3(ray_dir, dist, ray_pos)
        idist = intersects_box(bmin, bmax, p, ray_dir)
        mkd = None
        if truncate_to_max_dist:
            lim = fma(((max_dist - dist) + opts.eps) + opts.voxelSize, inv_steplen, 3.0)
            mkd = f2i_sat(torch.clamp(lim, 0.0, float(opts.maxVoxelIter)))
        sd = distance_to_scene(vol, opts, p, ray_dir, opts.maxVoxelIter, act, idist=idist,
                               max_k_dyn=mkd)
        done = (sd["dist"].abs() <= opts.eps) | (dist >= max_dist)
        steps = steps + act.long()
        obj = torch.where(act, f2i_sat(sd["mat"]), obj)
        pos = where3(act, p, pos)
        hit = torch.where(act, sd["hit"], hit)
        q = where3(act, sd["q"], q)
        gd = torch.where(act, sd["gd"], gd)
        dist = torch.where(act & ~done, dist + sd["dist"], dist)
        act = act & ~(done | (steps >= max_steps))
    miss = dist >= max_dist
    isec = {"pos": where3(miss, fma3(ray_dir, dist, ray_pos), pos),
            "distance": torch.where(miss, 1000.0, dist),
            "object_id": torch.where(miss, -1, obj)}
    if want_normal:
        isec["normal"] = isec_normal(vol, opts, hit & ~miss, q, gd, ray_dir, smooth)
    return isec
