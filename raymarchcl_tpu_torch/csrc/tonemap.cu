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
// On the main path the pack is not this kernel but the epilogue of K2's
// last pass (csrc/render_pass.cu), which holds the final accum in registers:
// no launch and no read of accum. This kernel packs an accum on its own
// (render.pack_argb); both use pack_argb of rmcl_common.cuh.
#include "rmcl_common.cuh"

__global__ void __launch_bounds__(256)
tonemap_pack_kernel(const float* __restrict__ accum, uint32_t* __restrict__ out,
                    float gamma, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = accum + 3 * (size_t)i;
  out[i] = pack_argb(c[0], c[1], c[2], gamma);
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
