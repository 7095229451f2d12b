// Batched Ising energy E_r = h . s_r + s_r^T J s_r on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ising_energy.py::ising_energy_pallas
// (_energy_kernel, _energy_core) and, through the batch index, its stacked
// twin ising_energy_batched_pallas.
//
// What bounds it on an H100: at the sizes the port calls it, neither bytes
// nor operations but latency.  The main path scores 8 reads of a 20-spin
// instance: ~2 KB of operands and ~7 kFLOP, nanoseconds at the card's
// rates, so the call is a launch, one round trip to memory, a 20-term FMA
// chain and a 20-term row sum.  At the farm's stack (B jobs x 8 reads x 128
// lanes) each block still moves J once (64 KB) for 0.26 MFLOP.
//
// Design: the live extent, read in place.  The kernel takes the instance's
// own n lanes (1 to 1024, no tile alignment), any r rows, int8 or float32
// spins (a template on the type) and row strides for the spins and J, so
// the wrapper hands it its operands as the caller holds them: no padding
// copy, no cast of int8 spins.  Grid (ceil(r / 8), B), one thread a lane
// (n rounded up to a warp), 8 rows a block, so a thread keeps 8 partial
// sums.  A block stages J's live corner (n <= 128; above, k-tiles of at
// most 32 KB in two buffers, prefetched one tile ahead), h and its rows'
// spins in shared memory before the first FMA: J with cp.async (16-byte
// copies where J's rows are one aligned span), the spins as plain loads
// converted to float.  One barrier, then each thread runs its k chain from
// shared memory over k < n only, reading four k of a row's spins as one
// broadcast float4.  The row sums run over the live lanes, one thread a row.
// The tiling is worked out on the host (no integer division on the card),
// and the kernel fits the 1024-thread bound's 64 registers without a spill
// (chip_smoke.py prints ptxas's count).
//
// The arithmetic is the parent kernel's and the COBI epilogues'
// (ising_energy.cuh) exactly: per (row, lane) an in-order fmaf chain over k
// ascending, then repro::density, then repro::row_sum, lanes in order from
// lane 0.  The parent ran the same chains over zero-padded lanes and k, whose
// terms are exact +-0 products, so every energy is the same float on any
// finite input.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ising_energy.cuh"

namespace {

constexpr int kRows = 8;             // replica rows a block
constexpr int kMaxLanes = 1024;      // one thread a lane
constexpr int kWholeJ = 128;         // up to this n, J's live corner is one tile
constexpr int kTileFloats = 8192;    // above it, a k-tile holds at most 32 KB
constexpr int kSmemDefault = 48 * 1024;  // above this a launch must opt in
constexpr int kMaxSmem = 128 * 1024;     // the most any n needs (n = 1024)

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Rows of J a k-tile holds: all n up to kWholeJ, else a multiple of 4 so
// every tile starts 16-byte aligned in the spins' rows.
inline int tile_rows(int n) {
  return n <= kWholeJ ? n : (kTileFloats / n) & ~3;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Start copying `rows` rows of J (row stride j_row floats) into dst (row
// stride n).  Rows that are one span (j_row == n) go as 16-byte copies
// when the span is 16-byte aligned, its last 0-3 floats one by one.
__device__ __forceinline__ void stage_j(float* dst, const float* src,
                                        long long j_row, int rows, int n) {
  const int count = rows * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (j_row == n) {
    int q0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      q0 = count & ~3;
      for (int q = 4 * tid; q < q0; q += 4 * nt) cp_async16(dst + q, src + q);
    }
    for (int q = q0 + tid; q < count; q += nt) cp_async4(dst + q, src + q);
  } else {
    for (int q = tid; q < count; q += nt) {
      const int k = q / n;
      cp_async4(dst + q, src + k * j_row + (q - k * n));
    }
  }
}

// acc[rr] += s[rr][k] * J[k][i] for the kn rows k of one tile, in order.
// jc is column i of the tile (stride n), sk the rows' spins at the tile's
// first k (stride n4, 16-byte aligned).
__device__ __forceinline__ void chain(const float* __restrict__ jc,
                                      const float* __restrict__ sk, int n,
                                      int n4, int kn, float (&acc)[kRows]) {
  int k = 0;
  for (; k + 4 <= kn; k += 4) {
    const float j0 = jc[(k + 0) * n];
    const float j1 = jc[(k + 1) * n];
    const float j2 = jc[(k + 2) * n];
    const float j3 = jc[(k + 3) * n];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 v = *reinterpret_cast<const float4*>(sk + rr * n4 + k);
      acc[rr] = fmaf(v.x, j0, acc[rr]);
      acc[rr] = fmaf(v.y, j1, acc[rr]);
      acc[rr] = fmaf(v.z, j2, acc[rr]);
      acc[rr] = fmaf(v.w, j3, acc[rr]);
    }
  }
  for (; k < kn; ++k) {
    const float jk = jc[k * n];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] = fmaf(sk[rr * n4 + k], jk, acc[rr]);
  }
}

template <typename ST>
__global__ void __launch_bounds__(kMaxLanes)
    energy_kernel(const ST* __restrict__ spins, const float* __restrict__ h,
                  const float* __restrict__ j, float* __restrict__ out, int r,
                  int n, int kt, int ntiles, long long s_batch, long long s_row,
                  long long h_batch, long long j_batch, long long j_row) {
  extern __shared__ __align__(16) float smem[];
  const int jbuf = round4(kt * n);
  const int n4 = round4(n);
  float* jt = smem;                                 // one or two k-tiles of J
  float* sp = smem + (ntiles > 1 ? 2 : 1) * jbuf;  // kRows x n4 spins
  float* el = sp + kRows * n4;                      // kRows x n4 densities
  const int b = blockIdx.y, row0 = blockIdx.x * kRows, i = threadIdx.x;
  const int rows = min(kRows, r - row0);
  h += b * h_batch;
  j += b * j_batch;

  // Everything the block reads is requested before the first FMA: J's
  // first tile asynchronously, then h and the spins.
  stage_j(jt, j, j_row, min(kt, n), n);
  cp_async_commit();
  float h_i = 0.0f;
  if (i < n) {
    h_i = h[i];
    const ST* col = spins + b * s_batch + row0 * s_row + i;
    float v[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr, col += s_row)
      v[rr] = rr < rows ? static_cast<float>(*col) : 0.0f;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sp[rr * n4 + i] = v[rr];
  }

  float acc[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kt;
    if (t + 1 < ntiles) {  // the next tile streams in while this one is used
      stage_j(jt + ((t + 1) & 1) * jbuf, j + (k0 + kt) * j_row, j_row,
              min(kt, n - k0 - kt), n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i < n) chain(jt + (t & 1) * jbuf + i, sp + k0, n, n4, min(kt, n - k0), acc);
    if (t + 1 < ntiles) __syncthreads();  // the buffer is refilled next
  }

  // The rows' spins are read before any density is stored: the compiler
  // cannot tell el from sp, and interleaved it waits out each load in turn.
  if (i < n) {
    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = sp[rr * n4 + i];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      el[rr * n4 + i] = repro::density(s[rr], acc[rr], h_i);
  }
  __syncthreads();
  if (i < rows) out[(long long)b * r + row0 + i] = repro::row_sum(el + i * n4, n);
}

template <typename ST>
int launch(const void* spins, const void* h, const void* j, void* out, int b,
           int r, int n, long long s_batch, long long s_row, long long h_batch,
           long long j_batch, long long j_row, cudaStream_t stream) {
  const int kt = tile_rows(n);
  const int ntiles = (n + kt - 1) / kt;
  const size_t floats = (size_t)(ntiles > 1 ? 2 : 1) * round4(kt * n) +
                        (size_t)2 * kRows * round4(n);
  const size_t smem = floats * sizeof(float);
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        energy_kernel<ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((r + kRows - 1) / kRows, b);
  energy_kernel<ST><<<grid, (n + 31) & ~31, smem, stream>>>(
      static_cast<const ST*>(spins), static_cast<const float*>(h),
      static_cast<const float*>(j), static_cast<float*>(out), r, n, kt, ntiles,
      s_batch, s_row, h_batch, j_batch, j_row);
  return (int)cudaGetLastError();
}

}  // namespace

// spins (B, R, n) int8 (spins_int8 != 0) or float32, h (B, n), j (B, n, n)
// float32 -> out (B, R) float32, contiguous.  Strides in elements; the
// last dimension of each operand has stride 1.  1 <= n <= 1024, R >= 1,
// 1 <= B <= 65535.
extern "C" int ising_energy(const void* spins, int spins_int8, const void* h,
                            const void* j, void* out, int b, int r, int n,
                            long long s_batch, long long s_row,
                            long long h_batch, long long j_batch,
                            long long j_row, void* stream) {
  if (b < 1 || b > 65535 || r < 1 || n < 1 || n > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return spins_int8
             ? launch<int8_t>(spins, h, j, out, b, r, n, s_batch, s_row,
                              h_batch, j_batch, j_row, st)
             : launch<float>(spins, h, j, out, b, r, n, s_batch, s_row,
                             h_batch, j_batch, j_row, st);
}
