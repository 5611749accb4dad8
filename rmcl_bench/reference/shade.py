"""Shading (renderer.cl:259-446): sky, fog and flares, point lights with
hard shadows, Blinn-Phong + Schlick, Monte-Carlo AO and the bounces.

Reference quirks kept: albedo multiplies the diffuse sum inside the light
loop (renderer.cl:376); schlick() is 0 when its d term is 0
(renderer.cl:310); the glossy normal is not re-normalized
(renderer.cl:420); all lights of a pixel share one jitter sample
(renderer.cl:267); a bounce hits where its object id is >= 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sampling
from .march import distance_to_scene, raymarch
from .vecmath import V3, dot, fma, fma3, mix, normalize, reflect, reflect_fused, where3


def sky_gradient(opts, rdir: V3) -> V3:
    """renderer.cl:259-261."""
    t = rdir.y * 0.5 + 0.5
    s1, s2 = opts.skyColor1, opts.skyColor2
    return V3(s1[0] + (s2[0] - s1[0]) * t, s1[1] + (s2[1] - s1[1]) * t,
              s1[2] + (s2[2] - s1[2]) * t)


def light_pos_jittered(opts, lanes, px, py, i) -> V3:
    """renderer.cl:263-269."""
    j = sampling.rand_xyz(lanes, sampling.light_seed(lanes, px, py))
    lp = opts.lightPos
    return V3(fma(j.x, opts.lightScatter, lp[i, 0]), fma(j.y, opts.lightScatter, lp[i, 1]),
              fma(j.z, opts.lightScatter, lp[i, 2]))


def apply_atmosphere(opts, lanes, px, py, ray_pos: V3, ray_dir: V3, isec_dist, col: V3) -> V3:
    """renderer.cl:275-290: exponential-squared fog, per-light flares."""
    fa = 1.0 - torch.exp(isec_dist * isec_dist * -opts.fogPow)
    col = col + (sky_gradient(opts, ray_dir) - col) * fa
    lc = opts.lightColor
    for i in range(opts.numLights):
        lp = light_pos_jittered(opts, lanes, px, py, i)
        d = torch.minimum(torch.clamp(dot(lp - ray_pos, ray_dir), min=0.0), isec_dist)
        closest = (ray_pos - lp) + ray_dir * d
        amp = opts.flareAmp / dot(closest, closest)
        col = V3(col.x + lc[i, 0] * amp, col.y + lc[i, 1] * amp, col.z + lc[i, 2] * amp)
    return col


def shadow(vol, opts, p: V3, ldir: V3, light_max_dist, active):
    """renderer.cl:292-301."""
    isec = raymarch(vol, opts, p, ldir, light_max_dist, opts.shadowIter, active,
                    want_normal=False, truncate_to_max_dist=True)
    return (isec["distance"] >= light_max_dist).float()


def schlick(r0, smoothness, normal: V3, view: V3):
    """renderer.cl:304-311."""
    d = torch.clamp(1.0 - dot(normal, -view), 0.0, 1.0)
    d2 = d * d
    return torch.where(d > 0.0, (1.0 - r0) * smoothness * d2 * d2 * d + r0, 0.0)


def blinn_phong_intensity(smoothness, ray_dir: V3, light_dir: V3, normal: V3):
    """renderer.cl:317-325."""
    nh = dot(normalize(light_dir - ray_dir), normal)
    spec_pow = torch.exp2(6.0 * smoothness + 4.0)
    val = torch.pow(torch.clamp(nh, min=0.0), spec_pow) * (spec_pow + 2.0) * 0.125
    return torch.where(nh > 0.0, val, 0.0)


def ao_trunc_steps(opts, steps, i):
    """Samples past which an AO probe's march cannot change its factor."""
    d_i = opts.aoStepDist * (i + 1)
    f = min(a * b for a, b in zip(opts.invVoxelScale, opts.voxelBounds2))
    steplen = (2.0 / steps) * f
    if steplen <= 0:
        return steps
    return min(steps, int((d_i + opts.voxelSize) / steplen) + 3)


def ambient_occlusion(vol, opts, lanes, pos: V3, normal: V3, active):
    """renderer.cl:327-346: aoIter+1 probes with half the voxel budget,
    while ao > 0.01."""
    ao = torch.ones_like(pos.x)
    seed0 = sampling.ao_seed(lanes, pos)
    steps = opts.maxVoxelIter // 2
    for i in range(opts.aoIter + 1):
        act = active & (ao > 0.01)
        if not bool(act.any()):
            break
        d = np.float32(opts.aoStepDist) * np.float32(i + 1)
        seed = (seed0 + 37 * (i + 1)) & sampling.U32_MASK
        j = sampling.rand_xyz(lanes, seed)
        sn = normalize(V3(fma(j.x, 0.2, normal.x), fma(j.y, 0.2, normal.y),
                          fma(j.z, 0.2, normal.z)))
        sd = distance_to_scene(vol, opts, fma3(sn, float(d), pos), sn, steps, act,
                               max_k=ao_trunc_steps(opts, steps, i), want_material=False)
        inv_d = float(np.float32(1.0) / d)
        ao_new = ao * (1.0 - torch.clamp((float(d) - sd["dist"]) * opts.aoAmp * inv_d,
                                         min=0.0))
        ao = torch.where(act, ao_new, ao)
    return ao


def mat_gather(opts, mat_idx):
    dev = mat_idx.device
    alb = opts.mat_albedo.to(dev)
    return (V3(alb[mat_idx, 0], alb[mat_idx, 1], alb[mat_idx, 2]),
            opts.mat_r0.to(dev)[mat_idx], opts.mat_smoothness.to(dev)[mat_idx])


def object_lighting(vol, opts, lanes, px, py, ray_dir: V3, isec_pos: V3, mat_idx,
                    normal: V3, reflect_col: V3, active):
    """renderer.cl:348-381. A shadow ray is marched only where its factor
    can reach the colour (Lambert or Blinn-Phong term above 0)."""
    albedo, r0, smoothness = mat_gather(opts, mat_idx)
    lt = []
    for i in range(opts.numLights):
        delta = light_pos_jittered(opts, lanes, px, py, i) - isec_pos
        d2 = dot(delta, delta)
        ldir = normalize(delta)
        relevant = (dot(ldir, normal) > 0.0) | (dot(normalize(ldir - ray_dir), normal) > 0.0)
        att = 1.0 / d2
        in_range = att > opts.minLightAtt
        lt.append(dict(ldir=ldir, lmax=torch.minimum(torch.sqrt(d2) - opts.shadowBias,
                                                     opts.maxDist),
                       att=att, in_range=in_range,
                       origin=fma3(ldir, opts.shadowBias, isec_pos),
                       act=active & in_range & relevant))
    ao = ambient_occlusion(vol, opts, lanes, isec_pos, normal, active)
    sfs = [shadow(vol, opts, l["origin"], l["ldir"], l["lmax"], l["act"]) for l in lt]
    diff = sky_gradient(opts, normal) * ao
    spec = reflect_col * ao
    zero = torch.zeros_like(ao)
    final = V3(zero, zero, zero)
    fresnel = schlick(r0, smoothness, normal, ray_dir)
    lc = opts.lightColor
    for i, (l, sf) in enumerate(zip(lt, sfs)):
        gain = torch.where(l["in_range"] & (sf > 0.0), sf * l["att"], 0.0)
        di = torch.clamp(dot(l["ldir"], normal), min=0.0) * gain
        si = blinn_phong_intensity(smoothness, ray_dir, l["ldir"], normal) * gain
        diff = V3(diff.x + lc[i, 0] * di, diff.y + lc[i, 1] * di, diff.z + lc[i, 2] * di)
        spec = V3(spec.x + lc[i, 0] * si, spec.y + lc[i, 1] * si, spec.z + lc[i, 2] * si)
        diff = diff * albedo  # per-light albedo (renderer.cl:376)
        final = final + mix(diff, spec, fresnel)
    return final * float(np.float32(1.0) / np.float32(opts.numLights))


def basic_scene_color(vol, opts, lanes, px, py, ray_pos: V3, ray_dir: V3, active):
    """One bounce's colour (renderer.cl:383-405). Returns (colour, isec)."""
    isec = raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, active,
                    smooth=False)
    sky = sky_gradient(opts, ray_dir)
    hit = isec["object_id"] >= 0
    mat_idx = torch.clamp(isec["object_id"], 0, 3)
    refl_sky = sky_gradient(opts, reflect(ray_dir, isec["normal"]))
    lit = object_lighting(vol, opts, lanes, px, py, ray_dir, isec["pos"], mat_idx,
                          isec["normal"], refl_sky, active & hit)
    col = apply_atmosphere(opts, lanes, px, py, ray_pos, ray_dir, isec["distance"],
                           where3(hit, lit, sky))
    return col, isec


def scene_color(vol, opts, lanes, state, ray_pos: V3, ray_dir: V3) -> V3:
    """renderer.cl:407-446: the primary raymarch, glossy normal, the bounce
    loop (frozen lanes, r0 >= 0.001) or the sky reflection, lighting and
    atmosphere."""
    px, py = state["px"], state["py"]
    active = torch.ones(ray_pos.x.shape, dtype=torch.bool, device=ray_pos.x.device)
    isec = raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, active)
    sky = sky_gradient(opts, ray_dir)
    hit = isec["distance"] < opts.maxDist
    mat_idx = torch.clamp(isec["object_id"], 0, 3)
    _, r0, smoothness = mat_gather(opts, mat_idx)
    norm_p = fma3(state["mc_normal"], 1.0 / (smoothness * 200.0 + 5.0), isec["normal"])
    reflect_col = sky_gradient(opts, reflect(ray_dir, norm_p))
    if opts.reflectIter > 0:
        mat_r0 = opts.mat_r0.to(r0.device)
        b_active = hit & (r0 > 0.0)
        zero = torch.zeros_like(r0)
        acc = V3(zero, zero, zero)
        r_dir, r_pos, r_norm = ray_dir, isec["pos"], norm_p
        for _ in range(opts.reflectIter):
            r_dir = where3(b_active, reflect_fused(r_dir, r_norm), r_dir)
            origin = fma3(r_dir, 0.0075, r_pos)  # renderer.cl:434
            col_i, bisec = basic_scene_color(vol, opts, lanes, px, py, origin, r_dir,
                                             b_active)
            acc = where3(b_active, acc + col_i, acc)
            b_id = bisec["object_id"]
            b_active = b_active & (b_id >= 0) & (mat_r0[torch.clamp(b_id, 0, 3)] >= 0.001)
            r_pos, r_norm = bisec["pos"], bisec["normal"]
        reflect_col = where3(r0 > 0.0, acc, reflect_col)
    lit = object_lighting(vol, opts, lanes, px, py, ray_dir, isec["pos"], mat_idx, norm_p,
                          reflect_col, hit)
    return apply_atmosphere(opts, lanes, px, py, ray_pos, ray_dir, isec["distance"],
                            where3(hit, lit, sky))
