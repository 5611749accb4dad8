"""Shading, plain PyTorch: sky, fog and flares, point lights with hard
shadows, Blinn-Phong + Schlick, Monte-Carlo AO and multi-bounce
reflections.

Counterpart of `raymarchcl_tpu/ops/shade.py` (reference:
renderer.cl:259-446). Reference quirks kept: albedo multiplies the diffuse
sum inside the light loop (renderer.cl:376); schlick() is 0, not r0, when
its d term is 0 (renderer.cl:310); the glossy shading normal is not
re-normalized (renderer.cl:420); all lights of a pixel share one jitter
sample (renderer.cl:267).
"""

from __future__ import annotations

import numpy as np
import torch

from . import sampling
from .march import distance_to_scene, raymarch
from .vecmath import V3, dot, fma, fma3, mix, normalize, reflect, reflect_fused, where3


def sky_gradient(opts, rdir: V3) -> V3:
    """Vertical sky gradient (renderer.cl:259-261)."""
    t = rdir.y * 0.5 + 0.5
    s1, s2 = opts.skyColor1, opts.skyColor2
    return V3(s1[0] + (s2[0] - s1[0]) * t, s1[1] + (s2[1] - s1[1]) * t,
              s1[2] + (s2[2] - s1[2]) * t)


def light_pos_jittered(opts, table, px, py, i) -> V3:
    """Scattered light position (renderer.cl:263-269)."""
    j = sampling.rand_xyz(table, sampling.light_seed(opts, px, py))
    lp = opts.lightPos
    return V3(fma(j.x, opts.lightScatter, lp[i, 0]),
              fma(j.y, opts.lightScatter, lp[i, 1]),
              fma(j.z, opts.lightScatter, lp[i, 2]))


def apply_atmosphere(opts, table, px, py, ray_pos: V3, ray_dir: V3, isec_dist,
                     col: V3) -> V3:
    """Exponential-squared fog toward the sky + per-light lens flares
    (renderer.cl:275-290)."""
    fa = 1.0 - torch.exp(isec_dist * isec_dist * -opts.fogPow)
    col = col + (sky_gradient(opts, ray_dir) - col) * fa
    lc = opts.lightColor
    for i in range(opts.numLights):
        lp = light_pos_jittered(opts, table, px, py, i)
        d = torch.minimum(torch.clamp(dot(lp - ray_pos, ray_dir), min=0.0), isec_dist)
        closest = (ray_pos - lp) + ray_dir * d
        amp = opts.flareAmp / dot(closest, closest)
        col = V3(col.x + lc[i, 0] * amp, col.y + lc[i, 1] * amp, col.z + lc[i, 2] * amp)
    return col


def shadow(vol, opts, p: V3, ldir: V3, light_max_dist, active, accel=None):
    """Hard shadow: a re-raymarch toward the light, 0/1 (renderer.cl:292-301)."""
    isec = raymarch(vol, opts, p, ldir, light_max_dist, opts.shadowIter, active,
                    want_normal=False, truncate_to_max_dist=True, accel=accel)
    return (isec["distance"] >= light_max_dist).float()


def schlick(r0, smoothness, normal: V3, view: V3):
    """Schlick fresnel approximation (renderer.cl:304-311)."""
    d = torch.clamp(1.0 - dot(normal, -view), 0.0, 1.0)
    d2 = d * d
    return torch.where(d > 0.0, (1.0 - r0) * smoothness * d2 * d2 * d + r0, 0.0)


def diffuse_intensity(ldir: V3, normal: V3):
    """Lambert term (renderer.cl:313-315)."""
    return torch.clamp(dot(ldir, normal), min=0.0)


def blinn_phong_intensity(smoothness, ray_dir: V3, light_dir: V3, normal: V3):
    """Energy-normalized Blinn-Phong (renderer.cl:317-325)."""
    nh = dot(normalize(light_dir - ray_dir), normal)
    spec_pow = torch.exp2(6.0 * smoothness + 4.0)
    val = torch.pow(torch.clamp(nh, min=0.0), spec_pow) * (spec_pow + 2.0) * 0.125
    return torch.where(nh > 0.0, val, 0.0)


def ao_trunc_steps(opts, steps, i):
    """Exact AO march truncation for probe i: a hit at step k is at least
    k*steplen - voxelSize away, and any scene distance >= d_i gives the AO
    factor exactly 1, so samples beyond (d_i + voxelSize)/steplen (+3)
    cannot change the result."""
    d_i = opts.aoStepDist * (i + 1)
    f = min(a * b for a, b in zip(opts.invVoxelScale, opts.voxelBounds2))
    steplen = (2.0 / steps) * f
    if steplen <= 0:
        return steps
    return min(steps, int((d_i + opts.voxelSize) / steplen) + 3)


def ao_step_dist(opts, i):
    """Probe i's distance, float32 aoStepDist * (i + 1)."""
    return np.float32(opts.aoStepDist) * np.float32(i + 1)


def ambient_occlusion(vol, opts, table, pos: V3, normal: V3, active, accel=None):
    """Monte-Carlo AO: aoIter+1 scene probes along scatter-jittered normals
    with half the voxel budget, while ao > 0.01 (renderer.cl:327-346)."""
    ao = torch.ones_like(pos.x)
    seed0 = sampling.ao_seed(opts, pos)
    steps = opts.maxVoxelIter // 2
    for i in range(opts.aoIter + 1):
        act = active & (ao > 0.01)
        if not bool(act.any()):
            break
        d = float(ao_step_dist(opts, i))
        seed = (seed0 + 37 * (i + 1)) & sampling.U32_MASK
        j = sampling.rand_xyz(table, seed)
        sn = normalize(V3(fma(j.x, 0.2, normal.x), fma(j.y, 0.2, normal.y),
                          fma(j.z, 0.2, normal.z)))
        sd = distance_to_scene(vol, opts, fma3(sn, d, pos), sn, steps, act,
                               max_k=ao_trunc_steps(opts, steps, i),
                               want_material=False, accel=accel)
        # / d as XLA:CPU compiles a division by a constant: times float32 1/d
        inv_d = float(np.float32(1.0) / np.float32(d))
        ao_new = ao * (1.0 - torch.clamp((d - sd["dist"]) * opts.aoAmp * inv_d, min=0.0))
        ao = torch.where(act, ao_new, ao)
    return ao


def mat_gather(opts, mat_idx):
    """Material slot fields (albedo V3, r0, smoothness) per lane."""
    dev = mat_idx.device
    alb = opts.mat_albedo.to(dev)
    return (V3(alb[mat_idx, 0], alb[mat_idx, 1], alb[mat_idx, 2]),
            opts.mat_r0.to(dev)[mat_idx], opts.mat_smoothness.to(dev)[mat_idx])


def light_geometry(opts, table, px, py, isec_pos: V3, ray_dir: V3, normal: V3,
                   active):
    """Per-light shadow-ray geometry (renderer.cl:263-269, 359-366).

    A shadow ray is marched only where it can matter: the shadow factor
    reaches the colour only through the Lambert and Blinn-Phong terms, both
    exactly 0 when dot(ldir, n) <= 0 and dot(normalize(ldir - dir), n) <= 0."""
    lt = []
    for i in range(opts.numLights):
        delta = light_pos_jittered(opts, table, px, py, i) - isec_pos
        d2 = dot(delta, delta)
        att = 1.0 / d2
        in_range = att > opts.minLightAtt
        ldir = normalize(delta)
        lmax = torch.minimum(torch.sqrt(d2) - opts.shadowBias, opts.maxDist)
        relevant = (dot(ldir, normal) > 0.0) | (
            dot(normalize(ldir - ray_dir), normal) > 0.0)
        lt.append(dict(ldir=ldir, lmax=lmax, att=att, in_range=in_range,
                       origin=fma3(ldir, opts.shadowBias, isec_pos),
                       act=active & in_range & relevant))
    return lt


def light_combine(opts, ray_dir: V3, normal: V3, albedo, r0, smoothness,
                  reflect_col: V3, ao, lt, sfs) -> V3:
    """Post-shadow lighting combine (renderer.cl:368-381)."""
    diff = sky_gradient(opts, normal) * ao
    spec = reflect_col * ao
    zero = torch.zeros_like(ao)
    final = V3(zero, zero, zero)
    fresnel = schlick(r0, smoothness, normal, ray_dir)
    lc = opts.lightColor
    for i, (l, sf) in enumerate(zip(lt, sfs)):
        gain = torch.where(l["in_range"] & (sf > 0.0), sf * l["att"], 0.0)
        di = diffuse_intensity(l["ldir"], normal) * gain
        si = blinn_phong_intensity(smoothness, ray_dir, l["ldir"], normal) * gain
        diff = V3(diff.x + lc[i, 0] * di, diff.y + lc[i, 1] * di, diff.z + lc[i, 2] * di)
        spec = V3(spec.x + lc[i, 0] * si, spec.y + lc[i, 1] * si, spec.z + lc[i, 2] * si)
        diff = diff * albedo  # QUIRK: per-light albedo (renderer.cl:376)
        final = final + mix(diff, spec, fresnel)
    return final * float(np.float32(1.0) / np.float32(opts.numLights))


def object_lighting(vol, opts, table, px, py, ray_dir: V3, isec_pos: V3, mat_idx,
                    normal: V3, reflect_col: V3, active, accel=None):
    """Direct lighting of a surface point (renderer.cl:348-381)."""
    albedo, r0, smoothness = mat_gather(opts, mat_idx)
    lt = light_geometry(opts, table, px, py, isec_pos, ray_dir, normal, active)
    ao = ambient_occlusion(vol, opts, table, isec_pos, normal, active, accel)
    sfs = [shadow(vol, opts, l["origin"], l["ldir"], l["lmax"], l["act"], accel)
           for l in lt]
    return light_combine(opts, ray_dir, normal, albedo, r0, smoothness,
                         reflect_col, ao, lt, sfs)


def basic_scene_color(vol, opts, table, px, py, ray_pos: V3, ray_dir: V3, active,
                      accel=None):
    """One bounce's colour (renderer.cl:383-405): a fast-normal raymarch,
    lighting with a sky reflection, atmosphere. A bounce hits where its
    object id is >= 0 (not distance < maxDist as the primary ray). Returns
    (colour V3, isec)."""
    isec = raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, active,
                    accel=accel, smooth=False)
    sky = sky_gradient(opts, ray_dir)
    hit = isec["object_id"] >= 0
    mat_idx = torch.clamp(isec["object_id"], 0, 3)
    refl_sky = sky_gradient(opts, reflect(ray_dir, isec["normal"]))
    lit = object_lighting(vol, opts, table, px, py, ray_dir, isec["pos"], mat_idx,
                          isec["normal"], refl_sky, active & hit, accel)
    col = apply_atmosphere(opts, table, px, py, ray_pos, ray_dir, isec["distance"],
                           where3(hit, lit, sky))
    return col, isec


def scene_color(vol, opts, table, state, ray_pos: V3, ray_dir: V3, accel=None) -> V3:
    """Primary shading (renderer.cl:407-446): smooth-normal raymarch, then
    shade_after_march. Every march takes the brick table `accel` when given."""
    active = torch.ones(ray_pos.x.shape, dtype=torch.bool, device=ray_pos.x.device)
    isec = raymarch(vol, opts, ray_pos, ray_dir, opts.maxDist, opts.maxIter, active,
                    accel=accel)
    return shade_after_march(vol, opts, table, state["px"], state["py"],
                             state["mc_normal"], ray_pos, ray_dir, isec, accel)


def shade_after_march(vol, opts, table, px, py, mc_normal: V3, ray_pos: V3,
                      ray_dir: V3, isec, accel=None) -> V3:
    """Everything in sceneColor after the primary raymarch
    (renderer.cl:414-445): glossy normal, the bounce loop or the sky
    reflection, lighting, atmosphere.

    The bounce loop runs reflectIter times with frozen inactive lanes: a
    lane bounces while its primary ray hit a reflective surface (r0 > 0)
    and every bounce so far hit a material with r0 >= 0.001
    (renderer.cl:430-437); the bounce colours sum where r0 > 0."""
    sky = sky_gradient(opts, ray_dir)
    hit = isec["distance"] < opts.maxDist  # renderer.cl:415
    mat_idx = torch.clamp(isec["object_id"], 0, 3)
    _, r0, smoothness = mat_gather(opts, mat_idx)
    # glossy perturbation, NOT re-normalized (renderer.cl:420)
    norm_p = fma3(mc_normal, 1.0 / (smoothness * 200.0 + 5.0), isec["normal"])
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
            col_i, bisec = basic_scene_color(vol, opts, table, px, py, origin, r_dir,
                                             b_active, accel)
            acc = where3(b_active, acc + col_i, acc)
            b_id = bisec["object_id"]
            b_active = b_active & (b_id >= 0) & (mat_r0[torch.clamp(b_id, 0, 3)] >= 0.001)
            r_pos, r_norm = bisec["pos"], bisec["normal"]
        reflect_col = where3(r0 > 0.0, acc, reflect_col)
    lit = object_lighting(vol, opts, table, px, py, ray_dir, isec["pos"], mat_idx,
                          norm_p, reflect_col, hit, accel)
    col = where3(hit, lit, sky)
    return apply_atmosphere(opts, table, px, py, ray_pos, ray_dir,
                            isec["distance"], col)
