// E1-E5: the primitive probes of a brick march, as Hopper kernels.
//
// Replace the five Pallas kernels of scripts/bench_pallas_prims.py (E1
// e1_row_fetch :71, E2 e2_sublane_gather :107, E3 e3_probe :136, E4
// e4_transpose :174, E5 e5_while :199), which measured whether Mosaic could
// stage brick rows, gather, probe bits, transpose and loop inside a kernel.
// Each kernel here computes what its Pallas body computes, at the script's
// shapes; plain versions: ops/kernels/prims.py, exactly equal. All of them
// are far below the card's rates: their inputs fit in L2, so they are bound
// by load latency and launch cost, not by bytes or operations.
//
// Integer sums wrap as int32 does in XLA: they are taken in uint32 (signed
// overflow is undefined in C++). Index arithmetic `(a + j) % m` follows
// Python's floor modulo, as jnp's % does.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int mod_floor(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// E1: reps rounds of out[k, :] = table[(sidx[k] + j) mod S, :]; out holds
// the last round. One warp per row k, 16 bytes a lane. The loads and stores
// are volatile, so every round really moves its row (a compiler would keep
// only the last round of plain code).
__global__ void __launch_bounds__(256)
e1_row_fetch_kernel(const uint4* __restrict__ table, const int* __restrict__ sidx,
                    uint4* __restrict__ out, int K, int S, int W4, int reps) {
  int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (k >= K) return;
  int s0 = sidx[k];
  for (int j = 0; j < reps; ++j) {
    int s = mod_floor(add_wrap(s0, j), S);
    for (int c = lane; c < W4; c += 32) {
      const uint4* src = table + (size_t)s * W4 + c;
      uint4* dst = out + (size_t)k * W4 + c;
      uint4 v;
      asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(src));
      asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "l"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
    }
  }
}

// E2: out[r, c] = sum_{j<reps} table[(idx[r, c] + j) mod depth, c], the
// take_along_axis of axis 0 (the TPU's sublane gather). One thread per
// output element; the table, at every depth, is read through L1/L2.
__global__ void __launch_bounds__(128)
e2_gather_kernel(const int* __restrict__ table, const int* __restrict__ idx,
                 int* __restrict__ out, int n, int cols, int depth, int reps) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int c = e % cols, i0 = idx[e];
  uint32_t acc = 0;
  for (int j = 0; j < reps; ++j)
    acc += (uint32_t)__ldg(&table[mod_floor(add_wrap(i0, j), depth) * cols + c]);
  out[e] = (int)acc;
}

// E3: hits[k] = sum_{j<rounds} sum_{i<u} (rows[k, (w[k]+j+i) mod W] >>
// ((b[k]+i) mod 32)) & 1. On the TPU the word select is a lane mask and a
// lane max over the staged row; here a thread indexes its ray's row.
__global__ void __launch_bounds__(256)
e3_probe_kernel(const uint32_t* __restrict__ rows, const int* __restrict__ w,
                const int* __restrict__ b, int* __restrict__ out, int K, int W, int rounds,
                int u) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const uint32_t* row = rows + (size_t)k * W;
  int wk = w[k], bk = b[k];
  uint32_t hits = 0;
  for (int j = 0; j < rounds; ++j)
    for (int i = 0; i < u; ++i) {
      uint32_t word = __ldg(&row[mod_floor(add_wrap(add_wrap(wk, j), i), W)]);
      hits += (word >> mod_floor(add_wrap(bk, i), 32)) & 1u;
    }
  out[k] = (int)hits;
}

// E4: out = sum_{j<reps} x^T, (R, C) -> (C, R). 32x32 tiles through padded
// shared memory (coalesced reads and writes, no bank conflicts); each of the
// reps re-reads the transposed element from shared memory (volatile, so the
// sum is not folded into one multiply).
__global__ void __launch_bounds__(256)
e4_transpose_kernel(const int* __restrict__ x, int* __restrict__ out, int R, int C, int reps) {
  __shared__ int tile[32][33];
  int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    int r = r0 + i, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[i][threadIdx.x] = x[(size_t)r * C + c];
  }
  __syncthreads();
  const volatile int* t = &tile[0][0];
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    int c = c0 + i, r = r0 + threadIdx.x;
    if (r < R && c < C) {
      uint32_t acc = 0;
      for (int j = 0; j < reps; ++j) acc += (uint32_t)t[threadIdx.x * 33 + i];
      out[(size_t)c * R + r] = (int)acc;
    }
  }
}

// E5: while max(v[:, 0]) > 0 { i += 1; v -= 1 }, then out = v + i. One
// block holds the (R, C) tile in registers, one element a thread; the loop
// condition is a block-wide OR over column 0 (__syncthreads_or), so the
// trip count is the data's. trips gets i.
__global__ void e5_while_kernel(const int* __restrict__ x, int* __restrict__ out,
                                int* __restrict__ trips, int R, int C) {
  int e = threadIdx.x;
  bool in = e < R * C;
  uint32_t v = in ? (uint32_t)x[e] : 0u;
  bool col0 = in && e % C == 0;
  uint32_t i = 0;
  while (__syncthreads_or(col0 && (int)v > 0)) {
    ++i;
    v -= 1u;
  }
  if (in) out[e] = (int)(v + i);
  if (e == 0) *trips = (int)i;
}

extern "C" int rmcl_e1_row_fetch(const int* table, const int* sidx, int* out, int K, int S,
                                 int W, int reps, cudaStream_t stream) {
  if (K > 0) {
    e1_row_fetch_kernel<<<(K * 32 + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const uint4*>(table), sidx, reinterpret_cast<uint4*>(out), K, S, W / 4,
        reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e2_gather(const int* table, const int* idx, int* out, int n, int cols,
                              int depth, int reps, cudaStream_t stream) {
  if (n > 0) {
    e2_gather_kernel<<<(n + 127) / 128, 128, 0, stream>>>(table, idx, out, n, cols, depth, reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e3_probe(const int* rows, const int* w, const int* b, int* out, int K,
                             int W, int rounds, int u, cudaStream_t stream) {
  if (K > 0) {
    e3_probe_kernel<<<(K + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(rows), w, b, out, K, W, rounds, u);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e4_transpose(const int* x, int* out, int R, int C, int reps,
                                 cudaStream_t stream) {
  if (R > 0 && C > 0) {
    dim3 grid((C + 31) / 32, (R + 31) / 32), block(32, 8);
    e4_transpose_kernel<<<grid, block, 0, stream>>>(x, out, R, C, reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e5_while(const int* x, int* out, int* trips, int R, int C,
                             cudaStream_t stream) {
  // one block of R*C <= 1024 threads (checked by the wrapper), whole warps
  e5_while_kernel<<<1, ((R * C + 31) / 32) * 32, 0, stream>>>(x, out, trips, R, C);
  return (int)cudaGetLastError();
}
