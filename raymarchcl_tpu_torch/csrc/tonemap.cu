// K1: tonemap + ARGB pack, one thread per pixel.
//
// Replaces the TPU kernel raymarchcl_tpu/ops/kernels/tonemap_pallas.py
// (tonemap_pack_pallas, body _kernel) and the jnp pack of
// ops/render.py:pack_argb (reference: renderer.cl:496-508). Plain version:
// ops/kernels/tonemap.py:tonemap_pack_plain, bit-equal.
//
// Bound on the H100: memory. It reads 12 bytes and writes 4 per pixel with a
// dozen flops, so at 512^2 it moves 4 MB and is launch-latency bound. The
// TPU kernel's SoA (64,128) tiles served the VPU lanes; here each thread
// reads its pixel's three AoS floats, which neighbouring threads cover as
// one contiguous span (coalesced), so no transpose or padding is needed.
#include "rmcl_common.cuh"

__device__ __forceinline__ uint32_t tonemap_channel(float c, float g) {
  float t = c / (g + c);
  t = t * t * 255.0f;
  // clamp before the cast, as the Pallas body does; fmaxf(NaN, 0) = 0
  t = fminf(fmaxf(t, 0.0f), 255.0f);
  return (uint32_t)__float2int_rz(t);
}

__global__ void __launch_bounds__(256)
tonemap_pack_kernel(const float* __restrict__ accum, uint32_t* __restrict__ out,
                    float gamma, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = accum + 3 * (size_t)i;
  uint32_t r = tonemap_channel(c[0], gamma);
  uint32_t g = tonemap_channel(c[1], gamma);
  uint32_t b = tonemap_channel(c[2], gamma);
  out[i] = 0xFF000000u | (r << 16) | (g << 8) | b;
}

extern "C" const char* rmcl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int rmcl_tonemap_pack(const float* accum, uint32_t* out, float gamma, int n,
                                 cudaStream_t stream) {
  if (n > 0) {
    tonemap_pack_kernel<<<(n + 255) / 256, 256, 0, stream>>>(accum, out, gamma, n);
  }
  return (int)cudaGetLastError();
}
