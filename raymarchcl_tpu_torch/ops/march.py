"""Marcher, plain PyTorch: box intersection, voxel sampling, the fixed-step
volume march, the sphere trace and the smooth and fast voxel normals.

Counterpart of `raymarchcl_tpu/ops/march.py` (reference:
renderer.cl:146-257), with and without its brick table (ops/accel.py).
Rays are V3 triples of flat (N,) tensors. The per-ray semantics are the
reference's loops; the lanes run them in lock step with masks, the march in
chunks of MARCH_CHUNK samples, and every loop stops as soon as no lane is
active. The JAX package's flat state machine, substep grouping and ground
batching are TPU scheduling that change no value and are not ported. This
module is the plain version of the CUDA render-pass kernel, which runs the
same loops one thread per ray.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import brick_dims, skip_samples, skips_per_distance
from .vecmath import V3, f2i_sat, fma, fma3, norm, normalize, where3

# Samples per lane per round of the fixed-step march.
MARCH_CHUNK = 16

# Sample positions the march has read since it was last set to 0: the
# samples up to each lane's stop or budget, plus the brick march's skip
# landings (the work count behind the render kernel's bound).
SAMPLES = 0


def dist_union(d1, m1, d2, m2):
    """distUnion (renderer.cl:146-148): the pair with the strictly smaller
    distance (ties -> second)."""
    take1 = d1 < d2
    return torch.where(take1, d1, d2), torch.where(take1, m1, m2)


def intersects_box(bmin, bmax, p: V3, d: V3):
    """Slab test (renderer.cl:153-161): entry distance, or -1.0 on a miss.

    Zero direction components divide to +-inf, and 0/0 -> NaN for a ray that
    starts exactly on a slab plane; NaN-suppressing fmin/fmax resolve them
    with the reference's IEEE semantics (torch.minimum would propagate)."""
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
    """Volume-space position -> integer voxel coord: C truncation toward
    zero, saturating like convert_int3_sat (renderer.cl:165)."""
    rx, ry, rz, _ = opts.voxelRes
    return V3(f2i_sat(p.x * float(rx)), f2i_sat(p.y * float(ry)),
              f2i_sat(p.z * float(rz)))


def _bounds_and_index(opts, q: V3):
    rx, ry, rz, rxy = opts.voxelRes
    valid = (
        (q.x >= 0) & (q.x < rx) & (q.y >= 0) & (q.y < ry) & (q.z >= 0) & (q.z < rz)
    )
    idx = q.z * rxy + q.y * rx + q.x
    return valid, torch.where(valid, idx, 0)


def voxel_fetch(vol, opts, q: V3):
    """Bounds-checked byte fetch -> (value int64 with -1 outside, valid)."""
    valid, idx = _bounds_and_index(opts, q)
    v = vol[idx].long()
    return torch.where(valid, v, -1), valid


def occupancy_i(vol, opts, q: V3):
    """voxelLookupI (renderer.cl:172-178): 1.0 where v >= isoVal, 0.0
    otherwise and outside the grid. (The march's hit test is v > isoVal.)"""
    valid, idx = _bounds_and_index(opts, q)
    return (valid & (vol[idx] >= opts.isoVal)).float()


def voxel_material(v):
    """Byte value -> material slot (renderer.cl:205-207)."""
    return torch.where(v < 84, 1.0, torch.where(v < 168, 2.0, 3.0))


_r5 = np.arange(-2, 3)
_OFF5 = [torch.from_numpy(o.reshape(-1).copy())
         for o in np.meshgrid(_r5, _r5, _r5, indexing="ij")]


def voxel_normal_fast(vol, opts, q: V3) -> V3:
    """Central difference of the occupancy, normalized (renderer.cl:180-188
    and :228). A voxel with no gradient gives +y (vecmath.normalize)."""
    def occ(dx, dy, dz):
        return occupancy_i(vol, opts, V3(q.x + dx, q.y + dy, q.z + dz))

    n = V3(occ(1, 0, 0) - occ(-1, 0, 0), occ(0, 1, 0) - occ(0, -1, 0),
           occ(0, 0, 1) - occ(0, 0, -1))
    return normalize(-n)


def voxel_normal_smooth(vol, opts, q: V3) -> V3:
    """Sum of gradient normals over the occupied 3x3x3 neighbourhood,
    normalized (renderer.cl:190-203), from one (5^3, N) occupancy gather."""
    ox, oy, oz = (o.to(q.x.device)[:, None] for o in _OFF5)
    occ = occupancy_i(vol, opts, V3(q.x[None] + ox, q.y[None] + oy, q.z[None] + oz))
    occ = occ.reshape((5, 5, 5) + q.x.shape)
    c = occ[1:4, 1:4, 1:4]
    gx = occ[2:5, 1:4, 1:4] - occ[0:3, 1:4, 1:4]
    gy = occ[1:4, 2:5, 1:4] - occ[1:4, 0:3, 1:4]
    gz = occ[1:4, 1:4, 2:5] - occ[1:4, 1:4, 0:3]
    w = (c > 0.0).float()
    # integer-valued sums: exact in any order
    return normalize(V3(-(w * gx).sum((0, 1, 2)), -(w * gy).sum((0, 1, 2)),
                        -(w * gz).sum((0, 1, 2))))


def _samples_read(act, newly, first, kabs0, cap):
    """Sample positions one chunk round of the march needs, summed over its
    lanes: up to the first stop, else the samples below the budget."""
    left = torch.clamp(cap - kabs0, 0, MARCH_CHUNK)
    return int(torch.where(newly, first + 1, torch.where(act, left, 0)).sum())


def march_volume(vol, opts, p0: V3, delta: V3, steps, active, max_k=None,
                 max_k_dyn=None, accel=None):
    """Fixed-step march (renderer.cl:219-234): the first sample k in
    [0, steps) that leaves the grid (stop) or exceeds isoVal (hit), with
    sample k at p0 + delta*k. Samples k >= max_k (static) or >= max_k_dyn
    (per lane) count as not reached. Returns (hit bool, hit_k int64; 0 where
    nothing stopped).

    With a brick table (ops/accel.Accel) the march skips samples that the
    table proves free, and tests the others against its STOP bits; hit and
    hit_k are the raw march's, bit for bit."""
    global SAMPLES
    eff = steps if max_k is None else min(steps, max_k)
    if accel is not None:
        return _march_volume_brick(opts, accel, p0, delta, eff, active, max_k_dyn)
    n = p0.x.shape[0]
    dev = p0.x.device
    iso = opts.isoVal
    cap = torch.full((n,), eff, dtype=torch.long, device=dev)
    if max_k_dyn is not None:
        cap = torch.minimum(cap, max_k_dyn.long())
    ks = torch.arange(MARCH_CHUNK, device=dev)[:, None]  # (CH, 1)
    act = active.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_k = torch.zeros(n, dtype=torch.long, device=dev)
    for k0 in range(0, eff, MARCH_CHUNK):
        if not bool(act.any()):
            break
        kabs = k0 + ks  # (CH, 1)
        kf = kabs.float()
        p = V3(fma(delta.x[None], kf, p0.x[None]), fma(delta.y[None], kf, p0.y[None]),
               fma(delta.z[None], kf, p0.z[None]))
        v, _ = voxel_fetch(vol, opts, voxel_coord(opts, p))  # (CH, N)
        stop = ((v < 0) | (v > iso)) & (kabs < cap[None])
        any_stop = stop.any(0)
        first = stop.int().argmax(0)  # first True along the chunk
        v_first = v.gather(0, first[None])[0]
        newly = act & any_stop
        SAMPLES += _samples_read(act, newly, first, k0, cap)
        hit = torch.where(newly, v_first > iso, hit)
        hit_k = torch.where(newly, k0 + first.long(), hit_k)
        act = act & ~any_stop & (k0 + MARCH_CHUNK < cap)
    return hit, hit_k


def _stop_bits(accel, opts, q: V3, valid):
    """STOP bit of each in-grid voxel q from the brick rows (False outside
    the grid)."""
    e = accel.edge
    shift, mask = e.bit_length() - 1, e - 1
    nbx, nby, _ = brick_dims(opts.voxelRes, e)
    bid = ((q.z >> shift) * nby + (q.y >> shift)) * nbx + (q.x >> shift)
    local = ((q.z & mask) * e + (q.y & mask)) * e + (q.x & mask)
    words = accel.rows.shape[1]
    idx = torch.where(valid, bid * words + (local >> 5), 0)
    word = accel.rows.reshape(-1)[idx].long()
    return valid & (((word >> (local & 31)) & 1) == 1)


def _march_volume_brick(opts, accel, p0: V3, delta: V3, eff, active, max_k_dyn):
    """The fixed-step march over the brick table. Each round a lane lands on
    its next sample k: in a brick at distance D whose skip is > 0 it moves
    to k + 1 + skip (ops/accel.skip_samples), otherwise it tests samples
    k .. k+MARCH_CHUNK-1 against the STOP bits like the raw march, and
    stops at the first that leaves the grid or is set."""
    global SAMPLES
    n = p0.x.shape[0]
    dev = p0.x.device
    e = accel.edge
    shift = e.bit_length() - 1
    nbx, nby, _ = brick_dims(opts.voxelRes, e)
    words = accel.rows.shape[1]
    rows = accel.rows.reshape(-1)
    inv_vps = skips_per_distance(opts, delta)
    cap = torch.full((n,), eff, dtype=torch.long, device=dev)
    if max_k_dyn is not None:
        cap = torch.minimum(cap, max_k_dyn.long())
    ks = torch.arange(MARCH_CHUNK, device=dev)[:, None]  # (CH, 1)
    act = active & (cap > 0)
    k = torch.zeros(n, dtype=torch.long, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_k = torch.zeros(n, dtype=torch.long, device=dev)
    while bool(act.any()):
        kabs = k[None] + ks  # (CH, N); row 0 is the landing
        p = fma3(V3(delta.x[None], delta.y[None], delta.z[None]), kabs.float(),
                 V3(p0.x[None], p0.y[None], p0.z[None]))
        q = voxel_coord(opts, p)
        valid, _ = _bounds_and_index(opts, q)
        # the landing's brick distance decides a skip
        q0 = V3(q.x[0], q.y[0], q.z[0])
        bid = ((q0.z >> shift) * nby + (q0.y >> shift)) * nbx + (q0.x >> shift)
        dist = rows[torch.where(valid[0], bid * words + accel.dist_w, 0)]
        skip = skip_samples(accel, dist, inv_vps)
        jump = act & valid[0] & (skip > 0)
        probe = act & ~jump
        # the others test a chunk of samples like the raw march
        bit = _stop_bits(accel, opts, q, valid)
        stop = (~valid | bit) & (kabs < cap[None])
        any_stop = stop.any(0)
        first = stop.int().argmax(0)
        newly = probe & any_stop
        SAMPLES += int(jump.sum()) + _samples_read(probe, newly, first, k, cap)
        hit = torch.where(newly, bit.gather(0, first[None])[0], hit)
        hit_k = torch.where(newly, k + first.long(), hit_k)
        k = torch.where(jump, k + 1 + skip, torch.where(probe, k + MARCH_CHUNK, k))
        act = act & ~newly & (k < cap)
    return hit, hit_k


def distance_to_scene(vol, opts, rpos: V3, rdir: V3, steps, active, idist=None,
                      max_k=None, max_k_dyn=None, want_material=True, accel=None):
    """Scene distance = ground plane U voxel volume (renderer.cl:209-237).

    Returns dict dist, mat (ground quirk: its own distance), hit, q (hit
    voxel), gd. want_material=False leaves `mat` meaningless (AO reads
    only `dist`)."""
    gd = rpos.y + opts.groundY
    # distUnion((gd, gd), (1e5, -1)): the ground's "material" is its own
    # distance (renderer.cl:211)
    res_d, res_m = dist_union(gd, gd, torch.full_like(gd, 1e5),
                              torch.full_like(gd, -1.0))
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

    hit, hit_k = march_volume(vol, opts, p0, delta, steps, march_mask,
                              max_k=max_k, max_k_dyn=max_k_dyn, accel=accel)
    hit_p = fma3(delta, hit_k.float(), p0)
    q = voxel_coord(opts, hit_p)
    vb2 = opts.voxelBounds2
    world = V3(hit_p.x * vb2[0] - vb[0], hit_p.y * vb2[1] - vb[1],
               hit_p.z * vb2[2] - vb[2])
    vdist = norm(rpos - world) - opts.voxelSize
    if want_material:
        vmat = voxel_material(voxel_fetch(vol, opts, q)[0])
    else:
        vmat = res_m
    hd, hm = dist_union(vdist, vmat, res_d, res_m)
    return {"dist": torch.where(hit, hd, res_d), "mat": torch.where(hit, hm, res_m),
            "hit": hit, "q": q, "gd": gd}


def isec_normal(vol, opts, hit, q, gd, rdir: V3, smooth=True):
    """Normal of a raymarch result: the smooth (or, for reflection rays,
    the fast) voxel normal on a volume hit, else +y for the ground and -dir
    for the backstop (renderer.cl:212)."""
    up = V3(torch.zeros_like(gd), torch.ones_like(gd), torch.zeros_like(gd))
    ground_n = where3(gd < 1e5, up, -rdir)
    vn = (voxel_normal_smooth if smooth else voxel_normal_fast)(vol, opts, q)
    return where3(hit, vn, ground_n)


def raymarch(vol, opts, ray_pos: V3, ray_dir: V3, max_dist, max_steps, active,
             want_normal=True, truncate_to_max_dist=False, accel=None, smooth=True):
    """Sphere trace (renderer.cl:239-257): isec dict pos, distance,
    object_id (and, when want_normal, the smooth normal, or the fast one
    with smooth=False).

    Each step re-marches the volume from the current position (over the
    brick table `accel` when given, with the same results); a ray stops
    when it converged (|d| <= eps), escaped (distance >= max_dist) or used
    max_steps steps. Misses rewrite to objectID -1 / distance 1000
    (renderer.cl:252-256).

    truncate_to_max_dist (shadow rays, read only as distance >= max_dist)
    caps each volume march per ray at the samples that could still place a
    hit within max_dist (+eps +voxelSize margin); this changes no output."""
    n = ray_pos.x.shape[0]
    dev = ray_pos.x.device
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=torch.float32,
                                                  device=dev), (n,))
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
            remaining = max_dist - dist
            lim = fma((remaining + opts.eps) + opts.voxelSize, inv_steplen, 3.0)
            mkd = f2i_sat(torch.clamp(lim, 0.0, float(opts.maxVoxelIter)))
        sd = distance_to_scene(vol, opts, p, ray_dir, opts.maxVoxelIter, act,
                               idist=idist, max_k_dyn=mkd, accel=accel)
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
    isec = {
        "pos": where3(miss, fma3(ray_dir, dist, ray_pos), pos),
        "distance": torch.where(miss, 1000.0, dist),
        "object_id": torch.where(miss, -1, obj),
    }
    if want_normal:
        isec["normal"] = isec_normal(vol, opts, hit & ~miss, q, gd, ray_dir, smooth)
    return isec
