// K2: the spp passes of one frame in one launch, blended into accum.
//
// Replaces the per-pass jnp program of the JAX package (on the TPU it is XLA
// code, with no Pallas source): sampling.init_render_state,
// camera.camera_ray_lookat, march.raymarch with the smooth normal,
// shade.shade_after_march (ambient_occlusion, shadow, light_combine,
// apply_atmosphere and, for reflectIter > 0, the bounce loop of
// basic_scene_color with the fast normal) and render.render_pass's blend. A thread
// runs the reference's own per-ray loops (RenderImage, renderer.cl:478-494;
// tests/scalar_ref.py), i.e. the semantics of the JAX package's lane-parallel
// loops, for every pass of its pixel in order. Plain version: the functions
// of raymarchcl_tpu_torch/ops named beside each device function here.
//
// Bound on the H100: dependent loads and warp divergence, not bytes or
// operations (the main path's frame runs ~140x its bound, which is the 9
// operations of each of its ~379 M march samples). A ray's march is a
// serial chain of loads whose addresses depend on the previous step, and
// rays in one warp stop after different numbers of sphere steps, march
// samples, AO probes and shadow steps: the counting build finds the shadow
// sample loop at 0.47 and the AO sample loop at 0.51 active lanes (PERF.md).
//
// - One launch per frame. A thread loops over the passes of its pixel in
//   order and keeps accum in registers (the exponential blend needs only
//   the pass order per pixel), so the frame costs one launch, one parameter
//   block and one read and write of accum.
// - Brick-local sample tests. Over the brick table a sample is tested
//   against the STOP bit of its brick's 72-byte row (STOP is v > isoVal, the
//   march's hit test), loaded only in bricks at distance 0: a brick at
//   distance >= 1 holds no STOP bit. The row's distance word is re-read only
//   when the brick changes and may skip samples (ops/accel.py). Sample
//   positions stay fmaf(delta, k, p0) of the index, so no hit moves and the
//   result is bit-equal to the raw march, which still tests the x-major
//   voxel bytes (the kernel is compiled with and without the table).
// - Warp-shaped pixel tiles from a work counter. A warp renders an 8x4 pixel
//   tile, so its rays start close together; as many blocks as stay resident
//   are launched, and each warp takes its next tile from a device counter
//   until none is left, so the frame's tail is one tile long.
// - K1's pack as the epilogue. After its pixel's last pass a thread holds
//   the final accum in registers; when the call asks for the image it also
//   stores the pixel's tonemapped ARGB word (pack_argb, rmcl_common.cuh), so
//   a frame takes no K1 launch and never reads accum back.
// - Any aoIter. The AO probes' distances and sample caps come beside the
//   pass times (one copy a frame) and are read through the read-only path.
// - Pixel ranges. A launch renders the rows of a range of global pixel ids
//   (one tile of a multi-device frame, parallel/tiling.py): its warps take
//   only the tiles of the tile rows the range touches and mask the pixels
//   outside it. A pixel keeps its global id, x and y, which seed its passes,
//   so a frame rendered range by range equals one launch bit for bit.
//
// - K2c, the reflective presets (reflectIter > 0), are instances of their
//   own (kReflect), so the bounce loop adds no code or registers to the
//   `ao` instances. A thread runs its pixel's bounces in order and stops at
//   the first that misses or hits a material with r0 < 0.001, as the plain
//   version's frozen lanes do. Lighting (the AO probes, a shadow ray a
//   light) is inlined at the primary hit and in the bounce loop: behind one
//   __noinline__ call a metal frame took 54.1 ms against 41.5-41.9.
//   Its AO, shadow and bounce sample loops run at 0.30, 0.27 and 0.31
//   active lanes, yet neither filling lanes nor overlapping loads made it
//   faster. Measured on a 512^2 metal frame and dropped (PERF.md; this loop
//   took 39.5-41.8 ms in the same calls), each bit-equal to it: a warp's
//   chains marched a lane each into a pool of shading points, their AO
//   probes and shadow rays pooled over the warp as tasks, the combine a lane
//   each in the reference's order. Lanes that take their next step or task
//   whenever half of them idle lift the AO and shadow shares to 0.60-0.81
//   and 0.40-0.53, but the shadow steps then start 17.8-26.3 M times (7.7 M
//   here) at 0.12-0.18 of the lanes: 46.8-57.9 ms (and a pool in shared
//   memory costs the L1 it shares: 96 KB a block unused took this loop to
//   44.3 ms). A step of every pooled ray at a time waits for the longest
//   step's samples: 64-71 ms. Each lane its share of the tasks with this
//   loop's own marches: 78/79 registers and three blocks an SM, yet 0.75%
//   slower over four calls (2-6% faster without the brick table), with a
//   37 MiB pool. Loading the STOP words of the next 2, 4 or 8 samples of a
//   brick at distance 0 together: 58-89 ms, the sample loops' shares down
//   to 0.22-0.25. Every try that spent instructions in divergent code, on
//   step set-ups for a few lanes or on samples not yet needed, lost more
//   than it saved: over the brick table the issued instructions of the
//   march loops, not load latency or idle lanes, look to be what bounds it.
//
// The counting build (never on the main path; `ao` and reflective) counts,
// per loop, warp iterations and the active lanes in them. Measured slower
// and left out: a 64-register cap (80 are used, 3 blocks an SM), one loop
// over sphere steps and samples (more registers, step bookkeeping at a
// fifth of the lanes), and work units of one pass of one tile (a warp that
// keeps its tile for all passes reuses the tile's bricks in L1).
#include <algorithm>
#include <atomic>
#include <climits>

#include "rmcl_common.cuh"

constexpr int kThreads = 256;
constexpr int kTileW = 8, kTileH = 4;  // one warp's pixels

// The loops the counting build counts (order of the counts array)
enum CountedLoop { kPrimarySamples, kPrimarySteps, kAoSamples, kShadowSamples, kShadowSteps,
                   kBounceSamples, kBounceSteps, kCountedLoops };

struct Counts {
  unsigned iters[kCountedLoops], lanes[kCountedLoops];
};

template <bool kB, bool kC, bool kR>
struct Build {
  static constexpr bool kBricks = kB;   // march over the brick table
  static constexpr bool kCount = kC;    // count loop iterations and lanes
  static constexpr bool kReflect = kR;  // the bounce loop (reflectIter > 0)
};

struct Scene {
  const RmclParams& P;
  const uint8_t* __restrict__ vol;
  const float4* __restrict__ table;  // this pass's MC table
  const int* __restrict__ rows;      // brick table (NB, rowWords) or null
  const float* __restrict__ aoD;     // shade.ao_step_dist per AO probe (aoIter + 1)
  const int* __restrict__ aoTrunc;   // shade.ao_trunc_steps per AO probe
  float time;                        // this pass's time
  Counts* counts;                    // the counting build's, else null
};

// One warp iteration of a counted loop: the lowest active lane adds it
template <class K>
__device__ __forceinline__ void tick(const Scene& S, int loop) {
  if constexpr (K::kCount) {
    unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
      S.counts->iters[loop] += 1u;
      S.counts->lanes[loop] += (unsigned)__popc(m);
    }
  }
}

// sampling.rand_float4
__device__ __forceinline__ float4 rand_float4(const Scene& S, uint32_t seed) {
  return __ldg(&S.table[seed & 0x3FFFu]);
}

// march.intersects_box: slab test with NaN-suppressing fminf/fmaxf
__device__ float intersects_box(const RmclParams& P, V3f p, V3f d) {
  const float pc[3] = {p.x, p.y, p.z};
  const float dc[3] = {d.x, d.y, d.z};
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o1 = (P.bmin[c] - pc[c]) / dc[c];
    float o2 = (P.bmax[c] - pc[c]) / dc[c];
    a = fmaxf(a, fminf(o1, o2));
    float hi = fmaxf(o1, o2);
    b = (c == 0) ? hi : fminf(b, hi);
  }
  return b > a ? a : -1.0f;
}

// march.voxel_fetch: byte value, -1 outside the grid
__device__ __forceinline__ int voxel_fetch(const Scene& S, int qx, int qy, int qz) {
  const RmclParams& P = S.P;
  if (qx < 0 || qx >= P.rx || qy < 0 || qy >= P.ry || qz < 0 || qz >= P.rz) return -1;
  return (int)__ldg(&S.vol[qz * P.rxy + qy * P.rx + qx]);
}

// march.occupancy_i: v >= isoVal (the march's hit test is v > isoVal)
__device__ __forceinline__ float occupancy(const Scene& S, int qx, int qy, int qz) {
  int v = voxel_fetch(S, qx, qy, qz);
  return (v >= 0 && v >= S.P.isoVal) ? 1.0f : 0.0f;
}

// march.voxel_material
__device__ __forceinline__ float voxel_material(int v) {
  return v < 84 ? 1.0f : (v < 168 ? 2.0f : 3.0f);
}

// march.voxel_normal_fast: central difference of the occupancy, normalized
// (0 -> +y)
__device__ V3f voxel_normal_fast(const Scene& S, int qx, int qy, int qz) {
  float nx = occupancy(S, qx + 1, qy, qz) - occupancy(S, qx - 1, qy, qz);
  float ny = occupancy(S, qx, qy + 1, qz) - occupancy(S, qx, qy - 1, qz);
  float nz = occupancy(S, qx, qy, qz + 1) - occupancy(S, qx, qy, qz - 1);
  return normalize3({-nx, -ny, -nz});
}

// march.voxel_normal_smooth: gradient sum over the occupied 3x3x3
// neighbourhood (integer-valued, exact in any order), normalized
__device__ V3f voxel_normal_smooth(const Scene& S, int qx, int qy, int qz) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int dz = -1; dz <= 1; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        int cx = qx + dx, cy = qy + dy, cz = qz + dz;
        if (occupancy(S, cx, cy, cz) > 0.0f) {
          sx += occupancy(S, cx + 1, cy, cz) - occupancy(S, cx - 1, cy, cz);
          sy += occupancy(S, cx, cy + 1, cz) - occupancy(S, cx, cy - 1, cz);
          sz += occupancy(S, cx, cy, cz + 1) - occupancy(S, cx, cy, cz - 1);
        }
      }
  return normalize3({-sx, -sy, -sz});
}

struct SceneDist {
  float dist, mat, gd;
  bool hit;
  int qx, qy, qz;
};

// accel.skip_samples: samples a landing in a brick at distance D proves free
__device__ __forceinline__ int skip_samples(const RmclParams& P, int dist, float inv_vps) {
  float d_equiv = (float)P.edge * (float)dist - (float)(P.edge - 1);
  float s = (d_equiv - 3.5f) * inv_vps;  // accel.SKIP_SLACK
  return __float2int_rz(fminf(fmaxf(s, 0.0f), 1073741824.0f));  // clip to [0, 2^30]
}

// distance_to_scene's tail for a volume hit at sample k: the hit voxel, its
// distance and material, and the union with the ground
__device__ __forceinline__ SceneDist finish_hit(const Scene& S, SceneDist r, V3f rpos, V3f delta,
                                               V3f p0, int k, float res_d, float res_m,
                                               bool want_material) {
  const RmclParams& P = S.P;
  const float fx = (float)P.rx, fy = (float)P.ry, fz = (float)P.rz;
  float kf = (float)k;
  V3f hp = fma3(delta, kf, p0);
  r.qx = __float2int_rz(hp.x * fx);
  r.qy = __float2int_rz(hp.y * fy);
  r.qz = __float2int_rz(hp.z * fz);
  V3f world = {hp.x * P.vb2[0] - P.vb[0], hp.y * P.vb2[1] - P.vb[1],
               hp.z * P.vb2[2] - P.vb[2]};
  float vdist = norm3(sub3(rpos, world)) - P.voxelSize;
  float vmat = want_material ? voxel_material(voxel_fetch(S, r.qx, r.qy, r.qz)) : res_m;
  bool take = vdist < res_d;  // distUnion(voxel, ground)
  r.dist = take ? vdist : res_d;
  r.mat = take ? vmat : res_m;
  r.hit = true;
  return r;
}

// march.distance_to_scene with march.march_volume: ground plane U volume.
// lim = min(steps, static cap, per-ray cap) samples of the fixed-step march;
// `loop` names the sample loop for the counting build.
template <class K>
__device__ SceneDist distance_to_scene(const Scene& S, V3f rpos, V3f rdir, float scale, int lim,
                                       bool active, float idist, bool want_material, int loop) {
  const RmclParams& P = S.P;
  SceneDist r;
  float gd = rpos.y + P.groundY;
  bool ground = gd < 1e5f;  // distUnion((gd, gd), (1e5, -1))
  float res_d = ground ? gd : 1e5f;
  float res_m = ground ? gd : -1.0f;
  r.dist = res_d;
  r.mat = res_m;
  r.gd = gd;
  r.hit = false;
  r.qx = r.qy = r.qz = 0;
  if (!(active && idist >= 0.0f && idist < res_d)) return r;

  V3f delta = {rdir.x * scale * P.invS[0], rdir.y * scale * P.invS[1],
               rdir.z * scale * P.invS[2]};
  float adv = idist > 0.0f ? idist : 0.0f;
  V3f p0 = {fmaf(rdir.x, adv, rpos.x + P.vb[0]) * P.invS[0],
            fmaf(rdir.y, adv, rpos.y + P.vb[1]) * P.invS[1],
            fmaf(rdir.z, adv, rpos.z + P.vb[2]) * P.invS[2]};
  const float fx = (float)P.rx, fy = (float)P.ry, fz = (float)P.rz;
  int k = 0;
  if constexpr (!K::kBricks) {
    // one voxel byte per sample
    int v = -1;
    for (; k < lim; ++k) {
      float kf = (float)k;
      v = voxel_fetch(S, __float2int_rz(fmaf(delta.x, kf, p0.x) * fx),
                      __float2int_rz(fmaf(delta.y, kf, p0.y) * fy),
                      __float2int_rz(fmaf(delta.z, kf, p0.z) * fz));
      if (v < 0 || v > P.isoVal) break;
    }
    if (k == lim || v < 0) return r;  // budget spent, or left the grid
  } else {
    // the brick's distance word (re-read when the brick changes) may skip
    // the sample and the ones after it; in a brick at distance 0 the sample
    // is tested against its STOP bit in the same row
    float vps = fmaxf(fabsf(delta.x) * fx, fmaxf(fabsf(delta.y) * fy, fabsf(delta.z) * fz));
    float inv_vps = vps > 0.0f ? 1.0f / fmaxf(vps, 1e-30f) : 1e30f;  // skips_per_distance
    const int sh = P.brickShift, m = P.edge - 1;
    bool hit = false;
    int bid_d = -1, dist = 0;
    while (k < lim) {
      tick<K>(S, loop);
      float kf = (float)k;
      int qx = __float2int_rz(fmaf(delta.x, kf, p0.x) * fx);
      int qy = __float2int_rz(fmaf(delta.y, kf, p0.y) * fy);
      int qz = __float2int_rz(fmaf(delta.z, kf, p0.z) * fz);
      if (qx < 0 || qx >= P.rx || qy < 0 || qy >= P.ry || qz < 0 || qz >= P.rz) break;
      int bid = ((qz >> sh) * P.nby + (qy >> sh)) * P.nbx + (qx >> sh);
      const int* row = S.rows + bid * P.rowWords;
      int lbit = ((((qz & m) << sh) + (qy & m)) << sh) + (qx & m);  // L = (lz*e + ly)*e + lx
      bool fresh = bid != bid_d;
      int word = 0;
      if (fresh) {  // both loads in flight together
        dist = __ldg(&row[P.rowWords - 2]);
        word = __ldg(&row[lbit >> 5]);
        bid_d = bid;
      } else if (dist == 0) {
        word = __ldg(&row[lbit >> 5]);
      }
      if (dist == 0) {
        if ((word >> (lbit & 31)) & 1) {
          hit = true;
          break;
        }
      } else if (dist >= 2) {  // D <= 1 never skips
        int skip = skip_samples(P, dist, inv_vps);
        if (skip > 0) {
          k += 1 + skip;
          continue;
        }
      }
      ++k;
    }
    if (!hit) return r;  // budget spent, or left the grid
  }
  return finish_hit(S, r, rpos, delta, p0, k, res_d, res_m, want_material);
}

struct Isec {
  V3f pos;
  float dist;
  int obj;
  bool hit;
  int qx, qy, qz;
  float gd;
};

// march.raymarch: sphere trace of at most max_steps steps, miss rewrite.
// truncate caps each march at the samples that can still land within
// max_dist (shadow rays, counted as such); bounce counts a reflection ray's
// loops as its own.
template <class K>
__device__ Isec raymarch(const Scene& S, V3f ray_pos, V3f ray_dir, float max_dist,
                         int max_steps, bool active, bool truncate, bool bounce = false) {
  const RmclParams& P = S.P;
  float inv_steplen = 0.0f;
  if (truncate) inv_steplen = 1.0f / (P.shadowBaseStep * fmaxf(norm3(ray_dir), 1e-20f));
  Isec r;
  float dist = P.startDist;
  r.pos = ray_pos;
  r.obj = 0;
  r.hit = false;
  r.qx = r.qy = r.qz = 0;
  r.gd = 0.0f;
  if (active) {
    for (int s = 1; s <= max_steps; ++s) {
      tick<K>(S, truncate ? kShadowSteps : (bounce ? kBounceSteps : kPrimarySteps));
      V3f p = fma3(ray_dir, dist, ray_pos);
      float idist = intersects_box(P, p, ray_dir);
      int lim = P.maxVoxelIter;
      if (truncate) {
        float cap = fmaf((max_dist - dist + P.eps) + P.voxelSize, inv_steplen, 3.0f);
        lim = min(lim, __float2int_rz(fminf(fmaxf(cap, 0.0f), (float)P.maxVoxelIter)));
      }
      SceneDist sd = distance_to_scene<K>(
          S, p, ray_dir, P.marchScale, lim, true, idist, true,
          truncate ? kShadowSamples : (bounce ? kBounceSamples : kPrimarySamples));
      bool done = fabsf(sd.dist) <= P.eps || dist >= max_dist;
      r.obj = __float2int_rz(sd.mat);
      r.pos = p;
      r.hit = sd.hit;
      r.qx = sd.qx;
      r.qy = sd.qy;
      r.qz = sd.qz;
      r.gd = sd.gd;
      if (done) break;
      dist = dist + sd.dist;
    }
  }
  bool miss = dist >= max_dist;
  if (miss) {
    r.pos = fma3(ray_dir, dist, ray_pos);
    r.obj = -1;
    r.hit = false;
  }
  r.dist = miss ? 1000.0f : dist;
  return r;
}

// shade.sky_gradient
__device__ __forceinline__ V3f sky_gradient(const RmclParams& P, V3f d) {
  float t = d.y * 0.5f + 0.5f;
  return {P.sky1[0] + (P.sky2[0] - P.sky1[0]) * t, P.sky1[1] + (P.sky2[1] - P.sky1[1]) * t,
          P.sky1[2] + (P.sky2[2] - P.sky1[2]) * t};
}

// shade.light_pos_jittered (lseed = sampling.light_seed)
__device__ __forceinline__ V3f light_pos(const Scene& S, uint32_t lseed, int i) {
  const RmclParams& P = S.P;
  float4 j = rand_float4(S, lseed);
  return {fmaf(j.x, P.lightScatter, P.lightPos[i][0]),
          fmaf(j.y, P.lightScatter, P.lightPos[i][1]),
          fmaf(j.z, P.lightScatter, P.lightPos[i][2])};
}

// shade.ambient_occlusion for one surface point
template <class K>
__device__ float ambient_occlusion(const Scene& S, V3f pos, V3f n) {
  const RmclParams& P = S.P;
  float ao = 1.0f;
  // sampling.ao_seed
  uint32_t seed0 = f2u32(fmaf(pos.z, 2945.87f, fmaf(pos.x, 3183.75f, pos.y * 1831.42f)) +
                         S.time * 2671.918f);
  for (int i = 0; i <= P.aoIter && ao > 0.01f; ++i) {
    float d = __ldg(&S.aoD[i]);
    float4 j = rand_float4(S, seed0 + 37u * (uint32_t)(i + 1));
    V3f sn = normalize3({fmaf(j.x, 0.2f, n.x), fmaf(j.y, 0.2f, n.y), fmaf(j.z, 0.2f, n.z)});
    V3f rp = fma3(sn, d, pos);
    SceneDist sd = distance_to_scene<K>(S, rp, sn, P.aoScale, __ldg(&S.aoTrunc[i]), true,
                                        intersects_box(P, rp, sn), false, kAoSamples);
    // / d as XLA:CPU compiles it: the product with 1/d
    ao = ao * (1.0f - fmaxf((d - sd.dist) * P.aoAmp * (1.0f / d), 0.0f));
  }
  return ao;
}

// shade.blinn_phong_intensity
__device__ __forceinline__ float blinn_phong(float smoothness, V3f ray_dir, V3f ldir, V3f n) {
  float nh = dot3(normalize3(sub3(ldir, ray_dir)), n);
  float spec_pow = exp2f(6.0f * smoothness + 4.0f);
  float val = powf(fmaxf(nh, 0.0f), spec_pow) * (spec_pow + 2.0f) * 0.125f;
  return nh > 0.0f ? val : 0.0f;
}

// shade.object_lighting: AO, per light light_geometry -> shadow ->
// light_combine
template <class K>
__device__ V3f object_lighting(const Scene& S, uint32_t lseed, V3f ray_dir, V3f pos, int mat,
                               V3f n, V3f reflect_col) {
  const RmclParams& P = S.P;
  V3f albedo = {P.matAlbedo[mat][0], P.matAlbedo[mat][1], P.matAlbedo[mat][2]};
  float r0 = P.matR0[mat], smoothness = P.matSmooth[mat];
  float ao = ambient_occlusion<K>(S, pos, n);
  V3f diff = mul3(sky_gradient(P, n), ao);
  V3f spec = mul3(reflect_col, ao);
  V3f fin = {0.0f, 0.0f, 0.0f};
  // shade.schlick
  float dd = fminf(fmaxf(1.0f - dot3(n, neg3(ray_dir)), 0.0f), 1.0f);
  float d2 = dd * dd;
  float fresnel = dd > 0.0f ? (1.0f - r0) * smoothness * d2 * d2 * dd + r0 : 0.0f;
  for (int i = 0; i < P.numLights; ++i) {
    // shade.light_geometry
    V3f delta = sub3(light_pos(S, lseed, i), pos);
    float dsq = dot3(delta, delta);
    float att = 1.0f / dsq;
    bool in_range = att > P.minLightAtt;
    V3f ldir = normalize3(delta);
    float lmax = fminf(sqrtf(dsq) - P.shadowBias, P.maxDist);
    bool relevant = dot3(ldir, n) > 0.0f || dot3(normalize3(sub3(ldir, ray_dir)), n) > 0.0f;
    // shade.shadow
    Isec sh = raymarch<K>(S, fma3(ldir, P.shadowBias, pos), ldir, lmax, P.shadowIter,
                          in_range && relevant, true);
    float sf = sh.dist >= lmax ? 1.0f : 0.0f;
    // shade.light_combine
    float gain = (in_range && sf > 0.0f) ? sf * att : 0.0f;
    float di = fmaxf(dot3(ldir, n), 0.0f) * gain;
    float si = blinn_phong(smoothness, ray_dir, ldir, n) * gain;
    const float* lc = P.lightColor[i];
    diff = {diff.x + lc[0] * di, diff.y + lc[1] * di, diff.z + lc[2] * di};
    spec = {spec.x + lc[0] * si, spec.y + lc[1] * si, spec.z + lc[2] * si};
    diff = mul3v(diff, albedo);  // QUIRK: per-light albedo (renderer.cl:376)
    fin = add3(fin, add3(diff, mul3(sub3(spec, diff), fresnel)));
  }
  return mul3(fin, P.invNumLights);
}

// shade.apply_atmosphere: fog toward the sky + per-light flares
__device__ V3f apply_atmosphere(const Scene& S, uint32_t lseed, V3f ray_pos, V3f ray_dir,
                                float isec_dist, V3f col) {
  const RmclParams& P = S.P;
  float fa = 1.0f - expf(isec_dist * isec_dist * -P.fogPow);
  col = add3(col, mul3(sub3(sky_gradient(P, ray_dir), col), fa));
  for (int i = 0; i < P.numLights; ++i) {
    V3f lp = light_pos(S, lseed, i);
    float d = fminf(fmaxf(dot3(sub3(lp, ray_pos), ray_dir), 0.0f), isec_dist);
    V3f closest = add3(sub3(ray_pos, lp), mul3(ray_dir, d));
    float amp = P.flareAmp / dot3(closest, closest);
    const float* lc = P.lightColor[i];
    col = {col.x + lc[0] * amp, col.y + lc[1] * amp, col.z + lc[2] * amp};
  }
  return col;
}

// shade.shade_after_march's bounce loop with shade.basic_scene_color: the
// sum of the bounces' colours from the primary hit at pos with the glossy
// normal norm_p. A bounce reflects about the last normal
// (vecmath.reflect_fused), marches from 0.0075 along it with the fast
// normal, hits where its object id is >= 0, is lit with the sky's
// reflection and fogged from its origin; the loop ends after reflectIter
// bounces, at a miss, or at a hit material with r0 < 0.001.
template <class K>
__device__ V3f bounce_sum(const Scene& S, uint32_t lseed, V3f r_dir, V3f r_pos, V3f r_norm) {
  const RmclParams& P = S.P;
  V3f acc = {0.0f, 0.0f, 0.0f};
  for (int b = 0; b < P.reflectIter; ++b) {
    r_dir = reflect_fused3(r_dir, r_norm);
    V3f origin = fma3(r_dir, 0.0075f, r_pos);  // renderer.cl:434
    Isec bi = raymarch<K>(S, origin, r_dir, P.maxDist, P.maxIter, true, false, true);
    V3f n = bi.hit ? voxel_normal_fast(S, bi.qx, bi.qy, bi.qz)
                   : (bi.gd < 1e5f ? V3f{0.0f, 1.0f, 0.0f} : neg3(r_dir));
    bool hit = bi.obj >= 0;  // not distance < maxDist (renderer.cl:395)
    int mat = min(max(bi.obj, 0), 3);
    V3f col = hit ? object_lighting<K>(S, lseed, r_dir, bi.pos, mat, n,
                                        sky_gradient(P, reflect3(r_dir, n)))
                  : sky_gradient(P, r_dir);
    acc = add3(acc, apply_atmosphere(S, lseed, origin, r_dir, bi.dist, col));
    if (!hit || !(P.matR0[mat] >= 0.001f)) break;  // renderer.cl:436-437
    r_pos = bi.pos;
    r_norm = n;
  }
  return acc;
}

// One pass's colour of pixel (x, y), pid = y*width + x
template <class K>
__device__ V3f pass_color(const Scene& S, int pid, int x, int y) {
  const RmclParams& P = S.P;
  // sampling.init_render_state (renderer.cl:467-476)
  float pix_x = (float)x, pix_y = (float)y;
  float4 mp = rand_float4(S, (uint32_t)pid * 17u + f2u32(S.time * 3141.3862f));
  float4 mn = rand_float4(S, (uint32_t)pid * 37u + f2u32(S.time * 1859.1467f));
  V3f mc_normal = normalize3({mn.x, mn.y, mn.z});
  float px = pix_x + mp.z, py = pix_y + mp.w;
  V3f eye = {fmaf(mc_normal.z, P.dof, P.eyePos[0]), fmaf(mc_normal.x, P.dof, P.eyePos[1]),
             fmaf(mc_normal.y, P.dof, P.eyePos[2])};

  // camera.camera_ray_lookat
  V3f forward = normalize3(
      {P.targetPos[0] - eye.x, P.targetPos[1] - eye.y, P.targetPos[2] - eye.z});
  V3f right = normalize3(cross3(forward, {P.up[0], P.up[1], P.up[2]}));
  // camera.view_coords: XLA:CPU's fma(px, fov * (1/w), -fov/2), its factors
  // from the parameter block (computed in the kernel, they held registers
  // across the march and K2 over the table spilled 16 B at 80 registers)
  float vcx = fmaf(px, P.viewScale[0], -P.viewHalf);
  float vcy = fmaf(py, P.viewScale[1], -P.viewHalf) * (-P.invAspect);
  V3f upv = cross3(right, forward);
  V3f ray_dir = normalize3(add3(add3(mul3(right, vcx), mul3(upv, vcy)), forward));
  V3f ray_pos = eye;

  // shade.scene_color -> shade_after_march
  Isec isec = raymarch<K>(S, ray_pos, ray_dir, P.maxDist, P.maxIter, true, false);
  V3f normal = isec.hit ? voxel_normal_smooth(S, isec.qx, isec.qy, isec.qz)
                        : (isec.gd < 1e5f ? V3f{0.0f, 1.0f, 0.0f} : neg3(ray_dir));
  uint32_t lseed = f2u32(fmaf(px, 1957.0f, py * 2173.0f) + S.time * 4763.742f);
  V3f col = sky_gradient(P, ray_dir);
  if (isec.dist < P.maxDist) {
    int mat = min(max(isec.obj, 0), 3);
    float smoothness = P.matSmooth[mat];
    // glossy perturbation, not re-normalized (renderer.cl:420)
    V3f norm_p = fma3(mc_normal, 1.0f / (smoothness * 200.0f + 5.0f), normal);
    V3f reflect_col = sky_gradient(P, reflect3(ray_dir, norm_p));
    if constexpr (K::kReflect) {
      if (P.matR0[mat] > 0.0f) reflect_col = bounce_sum<K>(S, lseed, ray_dir, isec.pos, norm_p);
    }
    col = object_lighting<K>(S, lseed, ray_dir, isec.pos, mat, norm_p, reflect_col);
  }
  return apply_atmosphere(S, lseed, ray_pos, ray_dir, isec.dist, col);
}

// The work items of a launch over the pixel range [pixLo, pixLo + pixCount):
// the 8x4 tiles of the tile rows that the range's frame pixels touch, then
// its pad rows, 32 to an item. Row i of accum/argb is pixel pixLo + i; a row
// past the frame's last pixel (a pad row) renders that pixel again, as the
// JAX package's padded shards do (parallel/tiling.py). The whole frame is
// pixLo 0, pixCount width*height: every tile, no pad row. The launcher
// derives it and passes it as a kernel argument, which the kernel reads
// from the parameter bank: none of it holds a register over the passes.
struct RangeWork {
  int lo, hi;       // the range's frame pixels [lo, hi)
  int tiles_x;      // tiles in a tile row
  int tile_y0;      // the first tile row they touch
  int frame_tiles;  // tiles of the tile rows they touch
  int pad0;         // the first pad row (hi - lo)
  int items;        // frame_tiles, then the pad rows' items
};

static RangeWork range_work(const RmclParams& P) {
  const int n = P.width * P.height;
  RangeWork r;
  r.lo = std::min(P.pixLo, n);
  r.hi = std::min(P.pixLo + P.pixCount, n);
  r.tiles_x = (P.width + kTileW - 1) / kTileW;
  r.pad0 = r.hi - r.lo;
  r.tile_y0 = r.lo / P.width / kTileH;
  r.frame_tiles = r.pad0 > 0 ? ((r.hi - 1) / P.width / kTileH - r.tile_y0 + 1) * r.tiles_x : 0;
  r.items = r.frame_tiles + (P.pixCount - r.pad0 + 31) / 32;
  return r;
}

// Passes [0, npass) of tables (npass, tableLen) at times (npass,), AO probes
// ao_d/ao_trunc, over the rows of the pixel range (its work W). Each warp
// takes work items (8x4 pixel tiles, then 32 pad rows) from *next_tile until
// none is left; a pixel keeps its global id, x and y, which seed its passes,
// and its row in accum/argb is its id - pixLo. argb: null, or the packed
// pixels of the final accum (K1's pack as the epilogue: the thread holds its
// pixel's accum in registers); counts: the counting build's (iterations,
// lanes) per loop, else null.
template <class K>
__global__ void __launch_bounds__(kThreads)
render_passes_kernel(const __grid_constant__ RmclParams P, const RangeWork W,
                     const uint8_t* __restrict__ vol,
                     const float4* __restrict__ tables, const float* __restrict__ times,
                     const float* __restrict__ ao_d, const int* __restrict__ ao_trunc,
                     int npass, const int* __restrict__ rows, float* __restrict__ accum,
                     uint32_t* __restrict__ argb, int* __restrict__ next_tile,
                     unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  Counts c = {};
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(next_tile, 1);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= W.items) break;
    // a pad row: the frame's last pixel again
    int x = P.width - 1, y = P.height - 1;
    int row = W.pad0 + (t - W.frame_tiles) * 32 + lane;
    if (t < W.frame_tiles) {
      x = (t % W.tiles_x) * kTileW + (lane % kTileW);
      y = (W.tile_y0 + t / W.tiles_x) * kTileH + (lane / kTileW);
      const int id = y * P.width + x;
      row = x < P.width && id >= W.lo && id < W.hi ? id - W.lo : -1;
    }
    if (row >= 0 && row < P.pixCount) {
      int pid = y * P.width + x;
      float* a = accum + 3 * (size_t)row;
      float a0 = a[0], a1 = a[1], a2 = a[2];
      for (int p = 0; p < npass; ++p) {
        const Scene S{P, vol, tables + (size_t)p * P.tableLen, rows, ao_d, ao_trunc,
                      __ldg(&times[p]), K::kCount ? &c : nullptr};
        V3f col = pass_color<K>(S, pid, x, y);
        // render.render_pass blend: accum + (col*exposure - accum) * frameBlend
        a0 = fmaf(col.x * P.exposure - a0, P.frameBlend, a0);
        a1 = fmaf(col.y * P.exposure - a1, P.frameBlend, a1);
        a2 = fmaf(col.z * P.exposure - a2, P.frameBlend, a2);
      }
      a[0] = a0;
      a[1] = a1;
      a[2] = a2;
      if (argb) argb[row] = pack_argb(a0, a1, a2, P.gamma);
    }
    __syncwarp();
  }
  if constexpr (K::kCount) {
    for (int i = 0; i < kCountedLoops; ++i) {
      if (c.iters[i]) atomicAdd(&counts[2 * i], (unsigned long long)c.iters[i]);
      if (c.lanes[i]) atomicAdd(&counts[2 * i + 1], (unsigned long long)c.lanes[i]);
    }
  }
}

// An instance's residency on a device: what the launch sizes its grid from
// (blocks per SM, the SMs) and what rmcl_render_occupancy reports.
struct Occupancy {
  int per_sm, sms, regs, local_bytes;
};

constexpr int kMaxDevices = 64;

// Asked of the runtime once per instance and device, then read from the
// cache; a fill that races another writes the same values.
template <class K>
static cudaError_t occupancy(Occupancy* out) {
  static Occupancy cache[kMaxDevices];
  static std::atomic<bool> known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!known[dev].load(std::memory_order_acquire)) {
    auto kernel = render_passes_kernel<K>;
    Occupancy o{};
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel, kThreads, 0);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    o.regs = fa.numRegs;
    o.local_bytes = (int)fa.localSizeBytes;
    cache[dev] = o;
    known[dev].store(true, std::memory_order_release);
  }
  *out = cache[dev];
  return cudaSuccess;
}

template <class K>
static int launch(const RmclParams* params, const uint8_t* vol, const float* tables,
                  const float* times, int npass, const int* rows, float* accum, uint32_t* argb,
                  int* next_tile, unsigned long long* counts, cudaStream_t stream) {
  auto kernel = render_passes_kernel<K>;
  Occupancy occ;
  cudaError_t e = occupancy<K>(&occ);
  if (e != cudaSuccess) return (int)e;
  const RangeWork work = range_work(*params);
  int warps = kThreads / 32;
  int blocks = std::min(std::max(occ.per_sm, 1) * occ.sms, (work.items + warps - 1) / warps);
  // the AO probe table follows the pass times (render_pass.launch_block)
  const float* ao_d = times + npass;
  const int* ao_trunc = reinterpret_cast<const int*>(ao_d + params->aoIter + 1);
  // the work counter starts at 0 on the launch's stream, in order with it
  e = cudaMemsetAsync(next_tile, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kThreads, 0, stream>>>(*params, work, vol,
                                          reinterpret_cast<const float4*>(tables),
                                          times, ao_d, ao_trunc, npass, rows, accum, argb,
                                          next_tile, counts);
  return (int)cudaGetLastError();
}

// times: each pass's time (npass floats), then the AO probe table of
// aoIter + 1 distances (float) and aoIter + 1 sample caps (int); rows: the
// brick table, or null for the raw march; accum: pixCount rows of 3 floats,
// row i pixel min(pixLo + i, width*height - 1); argb: null, or the pixCount
// packed pixels of the final accum (with npass == 0, of accum as given); next_tile:
// one int, which the launch zeroes on its stream before the kernel; counts: null,
// or 2*kCountedLoops zeroed uint64 for the counting build (which needs the brick
// table). reflectIter > 0 selects the reflective instances.
template <bool kR>
static int dispatch(const RmclParams* params, const uint8_t* vol, const float* tables,
                    const float* times, int npass, const int* rows, float* accum,
                    uint32_t* argb, int* next_tile, unsigned long long* counts,
                    cudaStream_t stream) {
  if (counts)
    return launch<Build<true, true, kR>>(params, vol, tables, times, npass, rows, accum, argb,
                                         next_tile, counts, stream);
  if (rows)
    return launch<Build<true, false, kR>>(params, vol, tables, times, npass, rows, accum, argb,
                                          next_tile, nullptr, stream);
  return launch<Build<false, false, kR>>(params, vol, tables, times, npass, rows, accum, argb,
                                         next_tile, nullptr, stream);
}

extern "C" int rmcl_render_passes(const RmclParams* params, const uint8_t* vol,
                                  const float* tables, const float* times, int npass,
                                  const int* rows, float* accum, uint32_t* argb, int* next_tile,
                                  unsigned long long* counts, cudaStream_t stream) {
  if (npass < 0 || params->aoIter < 0 || params->pixLo < 0 || params->pixCount < 0 ||
      params->pixLo > INT_MAX - params->pixCount)
    return (int)cudaErrorInvalidValue;
  if ((npass == 0 && !argb) || params->width <= 0 || params->height <= 0 ||
      params->pixCount == 0)
    return 0;
  if (counts && !rows) return (int)cudaErrorInvalidValue;
  if (params->reflectIter > 0)
    return dispatch<true>(params, vol, tables, times, npass, rows, accum, argb, next_tile,
                          counts, stream);
  return dispatch<false>(params, vol, tables, times, npass, rows, accum, argb, next_tile,
                         counts, stream);
}

// The residency on the current device of the brick-table instance, K2c's
// with reflective != 0 else K2's, in out[0..3]: blocks per SM, threads per
// block, registers per thread, local (spill) bytes per thread
// (render_pass.occupancy).
extern "C" int rmcl_render_occupancy(int reflective, int* out) {
  Occupancy o;
  cudaError_t e = reflective ? occupancy<Build<true, false, true>>(&o)
                             : occupancy<Build<true, false, false>>(&o);
  if (e != cudaSuccess) return (int)e;
  out[0] = o.per_sm;
  out[1] = kThreads;
  out[2] = o.regs;
  out[3] = o.local_bytes;
  return 0;
}

// sizeof(RmclParams), which the loader holds to its ctypes mirror
// (ops/kernels/build.library)
extern "C" int rmcl_params_size() { return (int)sizeof(RmclParams); }
