// E1-E5: the primitive probes of a brick march, as Hopper kernels.
//
// Replace the five Pallas kernels of scripts/bench_pallas_prims.py (E1
// e1_row_fetch :71, E2 e2_sublane_gather :107, E3 e3_probe :136, E4
// e4_transpose :174, E5 e5_while :199), which measured whether Mosaic could
// stage brick rows, gather, probe bits, transpose and loop inside a kernel.
// Each kernel here computes what its Pallas body computes, at the script's
// shapes and at any shape its wrapper accepts; plain versions:
// ops/kernels/prims.py, exactly equal. Their inputs fit in L2, so none is
// bound by device-memory bytes: E2 and E3 by load latency and the launch, E5
// by its trips' dependent chain (decrement, compare, vote), E1 by the rate at
// which L2 delivers rows to shared memory, E4 by shared-memory reads and the
// launch (notes at each kernel; times in PERF.md).
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// E1: reps rounds of out[k, :] = table[(sidx[k] + j) mod S, :]; out holds the
// last round. What bounds it: the rounds' row reads (K x reps x 4W bytes,
// 33.6 MB at the script's sizes) all come from L2, where the 2 MB table
// stays, so the L2's rate into the SMs and the rows in flight, not device
// memory. So many rounds are kept in flight: a block of kE1Split warps takes
// row k, warp w the rounds w, w + kE1Split, ..., each a cp.async copy of the
// row (16 bytes a lane, one commit group a round) into the next slot of the
// warp's ring of kE1Ring slots in shared memory: the TPU's row into VMEM, a
// copy the compiler cannot drop. Before a round reuses a slot the warp waits
// until at most kE1Ring - 1 of its groups are pending, i.e. until the round
// that held the slot has landed; so kE1Ring rounds are in flight a warp, 32 a
// row, ~250 an SM. The warp that took round reps - 1 writes out[k] once from
// its slot (16-byte stores), as the TPU writes its VMEM out_ref back once.
// TMA bulk copies into the same rings, completing on mbarriers, measured
// slower on the H100 (PERF.md). The schedule is mirrored in
// tests/test_torch_prims.py.
constexpr int kE1Split = 4, kE1Ring = 8;

__global__ void __launch_bounds__(32 * kE1Split)
e1_row_fetch_kernel(const uint4* __restrict__ table, const int* __restrict__ sidx,
                    uint4* __restrict__ out, int S, int W4, int reps) {
  extern __shared__ uint4 e1_ring[];  // kE1Split rings of kE1Ring rows
  int w = threadIdx.x >> 5, lane = threadIdx.x & 31, k = blockIdx.x, n = 0;
  uint4* ring = e1_ring + (size_t)w * kE1Ring * W4;
  int s0 = sidx[k];
  for (int j = w; j < reps; j += kE1Split, ++n) {
    if (n >= kE1Ring) asm volatile("cp.async.wait_group %0;" ::"n"(kE1Ring - 1) : "memory");
    const uint4* src = table + (size_t)mod_floor(add_wrap(s0, j), S) * W4;
    uint4* dst = ring + (size_t)(n % kE1Ring) * W4;
    for (int c = lane; c < W4; c += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst + c)),
                   "l"(src + c)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (n == 0 || (reps - 1) % kE1Split != w) return;
  const uint4* last = ring + (size_t)((n - 1) % kE1Ring) * W4;
  for (int c = lane; c < W4; c += 32) out[(size_t)k * W4 + c] = last[c];
}

// E2: out[r, c] = sum_{j<reps} table[(idx[r, c] + j) mod depth, c], the
// take_along_axis of axis 0 (the TPU's sublane gather). What bounds it: not
// bytes (the table, 4 KB-2 MB, is read through L1/L2) but the latency of the
// rounds' loads and the launch. One thread an output ran its 64 rounds one
// after another, each behind an integer division, on 8 SMs. So kE2Lanes
// neighbouring lanes share an output (16,384 threads at the script's sizes,
// about a block of 128 an SM), each lane a contiguous share of the rounds
// (e2_share; the last share may be shorter or empty). A lane takes one floor
// modulo for its first round, then steps the row by +1 with a wrap at depth,
// no division a round; where idx + reps - 1 overflows int32 (e2_steps false)
// each round takes the formula. A lane starts a batch of up to kE2Batch
// loads (read-only path, volatile: every round is a load) before it adds
// them; the group's partial sums meet by shuffles (uint32, so any order
// gives the same bits), threads past the last output adding 0, and the
// group's first lane stores. 4, 8 and 32 lanes an output measured no faster
// over the script's depths (PERF.md). The schedule is mirrored in
// tests/test_torch_prims.py.
constexpr int kE2Lanes = 16, kE2Batch = 16;

__device__ __forceinline__ int e2_share(int reps) {
  return (reps + kE2Lanes - 1) / kE2Lanes;
}

__device__ __forceinline__ bool e2_steps(int i0, int reps) {
  return i0 <= INT32_MAX - (reps - 1);
}

__global__ void __launch_bounds__(128)
e2_gather_kernel(const int* __restrict__ table, const int* __restrict__ idx,
                 int* __restrict__ out, int n, int cols, int depth, int reps) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x, o = t / kE2Lanes;
  int part = (int)(t % kE2Lanes), share = e2_share(reps);
  uint32_t acc = 0u;
  if (o < n) {
    int i0 = idx[o], j = part * share, j1 = min(reps, j + share);
    bool steps = e2_steps(i0, reps);
    const int* col = table + o % cols;
    int r = mod_floor(add_wrap(i0, j), depth);
    for (; j < j1; j += kE2Batch) {
      uint32_t v[kE2Batch];
#pragma unroll
      for (int b = 0; b < kE2Batch; ++b) {
        v[b] = 0u;
        if (j + b < j1) {
          if (!steps) r = mod_floor(add_wrap(i0, j + b), depth);
          asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v[b]) : "l"(col + (size_t)r * cols));
          r = r + 1 == depth ? 0 : r + 1;
        }
      }
#pragma unroll
      for (int b = 0; b < kE2Batch; ++b) acc += v[b];
    }
  }
#pragma unroll
  for (int m = 1; m < kE2Lanes; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0 && o < n) out[o] = (int)acc;
}

// E3: hits[k] = sum_{j<rounds} sum_{i<u} (rows[k, (w[k]+j+i) mod W] >>
// ((b[k]+i) mod 32)) & 1; on the TPU the word select is a lane mask and a
// lane max over the staged row. What bounds it: not bytes (a ray reaches
// rounds + u - 1 words of its row, 22 ns at the script's sizes) but the
// launch and the latency of the probes' loads. One thread a ray ran its 64
// probes one after another, each behind an integer division, on 4 SMs. So
// kE3Lanes neighbouring lanes share a ray (16,384 threads at the script's
// sizes, a block of 128 on every SM), and the ray's (round j, column i) probes
// are dealt out as e3_cols(u) column slots by kE3Lanes / e3_cols(u) round
// shares: lane `part` takes columns i = part mod cols, i + cols, ... < u and,
// of each, the rounds of share part / cols (e3_share; the last share may be
// shorter or empty). A column keeps its bit (b + i) mod 32 and takes one
// floor modulo for its first word, then steps the word by +1 a round with a
// wrap at W; where w + i + j would overflow int32 (e3_steps false) each
// probe takes the formula. Loads go out in batches of kE3Batch (read-only
// path, volatile) before their bits are added: every probe stays a load and
// a bit test, none is folded into a popc over merged probes. The group's
// sums meet by shuffles (uint32), threads past the last ray adding 0, and
// the group's first lane stores. 32 lanes a ray measured the same; 8 lanes,
// and the ray's words staged in shared memory first (as the TPU stages the
// row in VMEM), slower (PERF.md). The schedule is mirrored in
// tests/test_torch_prims.py.
constexpr int kE3Lanes = 16, kE3Batch = 8;

__device__ __forceinline__ int e3_cols(int u) {
  return min(u, kE3Lanes);
}

__device__ __forceinline__ int e3_share(int rounds, int u) {
  return (rounds + kE3Lanes / e3_cols(u) - 1) / (kE3Lanes / e3_cols(u));
}

__device__ __forceinline__ bool e3_steps(int v0, int n) {
  return v0 <= INT32_MAX - (n - 1);
}

__global__ void __launch_bounds__(128)
e3_probe_kernel(const uint32_t* __restrict__ rows, const int* __restrict__ w,
                const int* __restrict__ b, int* __restrict__ out, int K, int W, int rounds,
                int u) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x, k = t / kE3Lanes;
  int part = (int)(t % kE3Lanes), cols = e3_cols(u), h = part / cols;
  int share = e3_share(rounds, u), j0 = h * share;
  uint32_t acc = 0u;
  if (k < K && h < kE3Lanes / cols && j0 < rounds) {
    const uint32_t* row = rows + (size_t)k * W;
    int wk = w[k], bk = b[k], j1 = j0 + min(share, rounds - j0);
    for (int i = part % cols; i < u; i += cols) {
      uint32_t bit = (uint32_t)add_wrap(bk, i) & 31u;
      int v0 = add_wrap(add_wrap(wk, j0), i);
      bool steps = e3_steps(v0, j1 - j0);
      int r = mod_floor(v0, W);
      for (int j = j0; j < j1; j += kE3Batch) {
        uint32_t v[kE3Batch];
#pragma unroll
        for (int q = 0; q < kE3Batch; ++q) {
          v[q] = 0u;
          if (j + q < j1) {
            if (!steps) r = mod_floor(add_wrap(add_wrap(wk, j + q), i), W);
            asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v[q]) : "l"(row + r));
            r = r + 1 == W ? 0 : r + 1;
          }
        }
#pragma unroll
        for (int q = 0; q < kE3Batch; ++q) acc += (v[q] >> bit) & 1u;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kE3Lanes; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0 && k < K) out[k] = (int)acc;
}

// E4: out = sum_{j<reps} x^T, (R, C) -> (C, R). What bounds it: the reps'
// shared-memory reads (R x C x 4 x reps bytes, 33.6 MB at the script's sizes,
// ~1 us at 128 bytes a clock an SM) and the launch; device memory sees 1 MB.
// So the reads are 16 bytes wide and spread over many warps: a block
// transposes a tile of kE4TileR input rows by kE4TileC input columns (512
// blocks of 128 threads at the script's shape, 16 warps an SM), stored
// column-major (a column of the tile is a row of out) under an XOR swizzle of
// its 16-byte chunks: element (i, c) of the tile is word e4_word(i, c).
// Loads: a thread takes 4 neighbouring elements of an input row (16 bytes
// where the row is aligned and whole, else element by element) and stores
// them as 4 words; a warp's stores hit 32 banks. Reads: a chunk of out (4
// neighbouring elements of an out row) is one 16-byte LDS, 4x fewer load
// instructions; each of the reps is read again (volatile), split over
// kE4Split neighbouring lanes that sum by shuffles; the 8 lanes of a quarter
// warp read distinct chunks (or the same one), so no bank conflict. Sums are
// uint32 (wrap); the first lane of a chunk stores it, 16 bytes where out's
// row is aligned and whole. Splits of 1 and 4 lanes measured slower
// (PERF.md). The index map is mirrored in tests/test_torch_prims.py.
constexpr int kE4TileR = 32, kE4TileC = 8, kE4Split = 2;
constexpr int kE4Threads = kE4TileR * kE4TileC / 4 * kE4Split;

__device__ __forceinline__ int e4_word(int i, int c) {
  return c * kE4TileR + ((((i >> 2) ^ (c & 4)) & 7) << 2) + (i & 3);
}

__global__ void __launch_bounds__(kE4Threads)
e4_transpose_kernel(const int* __restrict__ x, int* __restrict__ out, int R, int C, int reps,
                    int tiles_c, bool vec_in, bool vec_out) {
  __shared__ __align__(16) uint32_t tile[kE4TileR * kE4TileC];
  int r0 = (blockIdx.x / tiles_c) * kE4TileR, c0 = (blockIdx.x % tiles_c) * kE4TileC;
  int t = threadIdx.x;
  if (t < kE4TileR * kE4TileC / 4) {
    int i = t / (kE4TileC / 4), g = t % (kE4TileC / 4) * 4, r = r0 + i, c = c0 + g;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (r < R) {
      const int* src = x + (size_t)r * C + c;
      if (vec_in && c + 3 < C) {
        asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "l"(src));
      } else {
        for (int q = 0; q < 4; ++q)
          if (c + q < C) v[q] = (uint32_t)src[q];
      }
    }
    for (int q = 0; q < 4; ++q) tile[e4_word(i, g + q)] = v[q];
  }
  __syncthreads();
  int o = t / kE4Split, part = t % kE4Split, cl = o / (kE4TileR / 4), h = o % (kE4TileR / 4);
  uint32_t at = smem_u32(&tile[e4_word(4 * h, cl)]);
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
#pragma unroll 4
  for (int j = part; j < reps; j += kE4Split) {
    uint32_t v0, v1, v2, v3;
    asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                 : "r"(at)
                 : "memory");
    a0 += v0, a1 += v1, a2 += v2, a3 += v3;
  }
#pragma unroll
  for (int m = 1; m < kE4Split; m <<= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, m);
    a1 += __shfl_xor_sync(0xffffffffu, a1, m);
    a2 += __shfl_xor_sync(0xffffffffu, a2, m);
    a3 += __shfl_xor_sync(0xffffffffu, a3, m);
  }
  int c = c0 + cl, r = r0 + 4 * h;
  if (part != 0 || c >= C || r >= R) return;
  int* dst = out + (size_t)c * R + r;
  if (vec_out && r + 3 < R) {
    asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "r"(a0), "r"(a1), "r"(a2),
                 "r"(a3)
                 : "memory");
  } else {
    uint32_t a[4] = {a0, a1, a2, a3};
    for (int q = 0; q < 4 && r + q < R; ++q) dst[q] = (int)a[q];
  }
}

// E5: while max(v[:, 0]) > 0 { i += 1; v -= 1 }, then out = v + i; trips
// gets i. What bounds it: the trips, each a dependent chain (decrement,
// compare, OR over column 0, branch) on a 4 KB tile; a block of one element a
// thread ended each trip in a barrier of 32 warps (~82 ns a trip). So one
// warp holds the tile in registers, element e = lane + 32 q in slot q, and
// column 0 apart: row r = lane + 32 k in column slot k, for the warp-uniform
// e5_rows(R) slots (a lane past the last row holds row 0's value, whose
// trips are row 0's, so the OR needs no mask). A trip decrements the column
// slots, ORs (int)v > 0 over them in the lane and decides by __any_sync: no
// barrier, no shared memory. The loop reads only column 0, so the other
// elements are not decremented in it: their v after i trips is x - i, taken
// after the loop. Values are uint32 (wrap), compared as int. Arrays are
// indexed by constants only (unrolled), so they stay in registers. Testing
// the tile's own slots under a per-lane mask of column 0 (all 8 in lane 0
// at C = 128), or 4 warps meeting at a named barrier, measured 4-9x slower
// a trip (PERF.md). The slot layout is mirrored in tests/test_torch_prims.py.
constexpr int kE5Slots = 32;  // 1024 elements over 32 lanes

__device__ __forceinline__ int e5_rows(int R) {
  return (R + 31) / 32;
}

__global__ void __launch_bounds__(32)
e5_while_kernel(const int* __restrict__ x, int* __restrict__ out, int* __restrict__ trips,
                int R, int C) {
  int lane = threadIdx.x, n = R * C, rows = e5_rows(R);
  uint32_t v[kE5Slots], c0[kE5Slots];
  bool p = false;
#pragma unroll
  for (int q = 0; q < kE5Slots; ++q) {
    int s = lane + 32 * q;  // element s of the tile, row s of column 0
    v[q] = s < n ? (uint32_t)x[s] : 0u;
    c0[q] = q < rows ? (uint32_t)x[(size_t)(s < R ? s : 0) * C] : 0u;
    p |= q < rows && (int)c0[q] > 0;
  }
  uint32_t i = 0u;
  while (__any_sync(0xffffffffu, p)) {
    ++i;
    p = false;
#pragma unroll
    for (int k = 0; k < kE5Slots; ++k) {
      if (k >= rows) break;
      c0[k] -= 1u;
      p |= (int)c0[k] > 0;
    }
  }
#pragma unroll
  for (int q = 0; q < kE5Slots; ++q)
    if (lane + 32 * q < n) out[lane + 32 * q] = (int)(v[q] - i + i);
  if (lane == 0) *trips = (int)i;
}

extern "C" int rmcl_e1_row_fetch(const int* table, const int* sidx, int* out, int K, int S,
                                 int W, int reps, cudaStream_t stream) {
  if (reps < 1 || W % 4) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    size_t smem = (size_t)kE1Split * kE1Ring * W * 4;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(e1_row_fetch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    e1_row_fetch_kernel<<<K, 32 * kE1Split, smem, stream>>>(
        reinterpret_cast<const uint4*>(table), sidx, reinterpret_cast<uint4*>(out), S, W / 4,
        reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e2_gather(const int* table, const int* idx, int* out, int n, int cols,
                              int depth, int reps, cudaStream_t stream) {
  if (reps < 1 || depth < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long threads = (long long)n * kE2Lanes;
    e2_gather_kernel<<<(unsigned)((threads + 127) / 128), 128, 0, stream>>>(table, idx, out, n,
                                                                              cols, depth, reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e3_probe(const int* rows, const int* w, const int* b, int* out, int K,
                             int W, int rounds, int u, cudaStream_t stream) {
  if (W < 1 || u < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    long long threads = (long long)K * kE3Lanes;
    e3_probe_kernel<<<(unsigned)((threads + 127) / 128), 128, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(rows), w, b, out, K, W, rounds, u);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e4_transpose(const int* x, int* out, int R, int C, int reps,
                                 cudaStream_t stream) {
  if (R > 0 && C > 0) {
    int tiles_c = (C + kE4TileC - 1) / kE4TileC, tiles = tiles_c * ((R + kE4TileR - 1) / kE4TileR);
    bool vec_in = C % 4 == 0 && (uintptr_t)x % 16 == 0;
    bool vec_out = R % 4 == 0 && (uintptr_t)out % 16 == 0;
    e4_transpose_kernel<<<tiles, kE4Threads, 0, stream>>>(x, out, R, C, reps, tiles_c, vec_in,
                                                          vec_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmcl_e5_while(const int* x, int* out, int* trips, int R, int C,
                             cudaStream_t stream) {
  if (R < 1 || C < 1 || R * C > 32 * kE5Slots) return (int)cudaErrorInvalidValue;
  e5_while_kernel<<<1, 32, 0, stream>>>(x, out, trips, R, C);
  return (int)cudaGetLastError();
}
