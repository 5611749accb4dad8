// Shared device code of the raymarchcl_tpu_torch kernels.
//
// Every function mirrors, op for op, its plain PyTorch counterpart in
// raymarchcl_tpu_torch/ops (named beside each). The library is built with
// --fmad=false, so a multiply-add is fused exactly where the code says
// fmaf(), as ops/vecmath.py's fma() does on the plain side; division and
// sqrt are IEEE-rounded (no fast math).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Options of one frame's passes, filled by ops/kernels/render_pass.py
// (RmclParams there lists the same fields in the same order); each pass's
// time and the AO probe table (aoIter + 1 entries) go to the kernel beside
// it (render_pass.launch_block). Derived constants are computed on the host
// in float32 exactly as the plain version computes them.
struct RmclParams {
  int width, height;
  int rx, ry, rz, rxy;
  int maxIter, maxVoxelIter, shadowIter, aoIter, numLights, isoVal;
  int reflectIter;           // bounces a pass; > 0 selects the reflective instance
  int tableLen;              // MC table entries (float4) of one pass
  int edge, brickShift, nbx, nby, rowWords;  // brick table (ops/accel.py); 0 without
  int aoSteps;               // maxVoxelIter / 2
  int pixLo, pixCount;       // the rows of accum/argb: row i is pixel min(pixLo + i, width*height - 1)
  float marchScale;          // 1 / (maxVoxelIter * 0.5)
  float aoScale;             // 1 / (aoSteps * 0.5)
  float shadowBaseStep;      // (2 / maxVoxelIter) * min(invVoxelScale * voxelBounds2)
  float invNumLights;        // 1 / numLights
  float voxelSize;
  float bmin[3], bmax[3], vb[3], vb2[3], invS[3];
  float eyePos[3], targetPos[3], up[3], sky1[3], sky2[3];
  float invAspect, fov, maxDist, startDist, eps, aoAmp, groundY;
  float shadowBias, lightScatter, minLightAtt, exposure, dof, frameBlend;
  float fogPow, flareAmp, gamma;
  float viewScale[2], viewHalf;  // camera.view_scales: fov * (1/width), fov * (1/height), fov / 2
  float lightPos[4][4], lightColor[4][4], matAlbedo[4][4], matR0[4], matSmooth[4];
};

struct V3f {
  float x, y, z;
};

__device__ __forceinline__ V3f add3(V3f a, V3f b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3f sub3(V3f a, V3f b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3f mul3(V3f a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3f mul3v(V3f a, V3f b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3f neg3(V3f a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3f sel3(bool m, V3f a, V3f b) { return m ? a : b; }

// vecmath.fma3: fma(a, s, c) per component
__device__ __forceinline__ V3f fma3(V3f a, float s, V3f c) {
  return {fmaf(a.x, s, c.x), fmaf(a.y, s, c.y), fmaf(a.z, s, c.z)};
}

// vecmath.dot: XLA:CPU's contraction of a.x*b.x + a.y*b.y + a.z*b.z
__device__ __forceinline__ float dot3(V3f a, V3f b) {
  return fmaf(a.z, b.z, fmaf(a.x, b.x, a.y * b.y));
}

__device__ __forceinline__ V3f cross3(V3f a, V3f b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float norm3(V3f a) { return sqrtf(dot3(a, a)); }

// vecmath.normalize: 1/sqrt (not the approximate rsqrtf); 0 -> +y
__device__ __forceinline__ V3f normalize3(V3f a) {
  float n2 = dot3(a, a);
  if (n2 > 1e-24f) {
    float inv = 1.0f / sqrtf(n2);
    return {a.x * inv, a.y * inv, a.z * inv};
  }
  return {0.0f, 1.0f, 0.0f};
}

// vecmath.reflect
__device__ __forceinline__ V3f reflect3(V3f v, V3f n) {
  return sub3(v, mul3(n, 2.0f * dot3(v, n)));
}

// vecmath.reflect_fused: the bounce direction as XLA:CPU contracts it, each
// component fma(-n, 2*dot, v), the x component's dot in its own order
__device__ __forceinline__ V3f reflect_fused3(V3f v, V3f n) {
  float s = 2.0f * dot3(v, n);
  float sx = 2.0f * fmaf(v.z, n.z, fmaf(v.y, n.y, v.x * n.x));
  return {fmaf(-n.x, sx, v.x), fmaf(-n.y, s, v.y), fmaf(-n.z, s, v.z)};
}

// sampling.f2u32: cvt.rzi.s32.f32 truncates, saturates and maps NaN to 0,
// as XLA's float->int32 convert does
__device__ __forceinline__ uint32_t f2u32(float x) { return (uint32_t)__float2int_rz(x); }

// tonemap.tonemap_pack_plain for one channel: (c/(g+c))^2 * 255, clamped
// before the cast as the Pallas body does; fmaxf(NaN, 0) = 0
__device__ __forceinline__ uint32_t tonemap_channel(float c, float g) {
  float t = c / (g + c);
  t = t * t * 255.0f;
  t = fminf(fmaxf(t, 0.0f), 255.0f);
  return (uint32_t)__float2int_rz(t);
}

// tonemap.tonemap_pack_plain: one pixel's 0xAARRGGBB
__device__ __forceinline__ uint32_t pack_argb(float r, float g, float b, float gamma) {
  return 0xFF000000u | (tonemap_channel(r, gamma) << 16) | (tonemap_channel(g, gamma) << 8) |
         tonemap_channel(b, gamma);
}
