// COBI coupled-oscillator anneal kernels on Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/cobi_dynamics.py:
//   cobi_trajectory_pallas  (_cobi_kernel)               -> cobi_trajectory
//   cobi_readout_pallas     (_cobi_readout_kernel)       -> cobi_readout
//   cobi_fused_best_pallas  (_cobi_fused_best_kernel,
//                            _block_best, _carry_best)   -> cobi_fused_best
//   cobi_trajectory_batched_pallas  (_cobi_batched_kernel)   -> cobi_trajectory, B > 1
//   cobi_fused_best_batched_pallas  (_cobi_fused_best_batched_kernel)
//                                                            -> cobi_fused_best, B > 1
// Every entry takes a batch index B: grid (R / BR, B), one packed chip bin
// (or solo instance) per blockIdx.y.  The chip farm's drains launch B bins
// at once; a bin packs several jobs block-diagonally, one slot per job.
//
// Packed == solo, bit for bit: the Euler loop keeps one accumulator per row
// and adds the lanes in order (cobi_anneal.cuh), so a job's lanes in a bin
// see the other slots' lanes only as exact zero products (their couplings
// to the job are 0), and a job's packed anneal equals its solo anneal.
//
// What bounds it on an H100: operations, and at the main path's sizes the
// latency of one block.  Each of `steps` Euler steps does a (2R x n) @ (n x n)
// float32 product (4*R*n*n FLOP) plus 2*R*n sin/cos; the bytes are J once and
// the phases once.  At R = 8, n = 128, steps = 400 that is 2.1e8 FLOP against
// ~80 KB: a 3 us job at the card's float32 peak, but one instance with 8
// reads is a single thread block whose 400 steps run one after another.
//
// Design: grid (R / BR, B), BR = 8 replica rows per block, one thread per
// lane (n = 128 -> 128 threads).  J stays resident in shared memory for the
// whole trajectory (64 KB at n = 128, dynamic shared memory); each step
// writes the rows' [cos; sin] to shared memory, and each thread takes its
// 2*BR dot products against its column of J from broadcast float4 reads,
// keeping the phases in registers.  Phases never leave the block in the
// readout and fused kernels: the sign readout and the energy epilogue
// (ising_energy.cuh) run on the block's shared spins.
//
// Ties in the fused best-of: Pallas carries the best over replica blocks in
// grid order with a strict <, so the earliest replica wins.  Thread blocks
// here run in no order, so cobi_fused_best is two launches: pass 1 writes
// each block's per-slot (first-argmin energy, row spins); pass 2 scans the
// blocks in index order with a strict <.  No atomic decides a tie.
#include <cuda_runtime.h>
#include <math.h>

#include "cobi_anneal.cuh"
#include "ising_energy.cuh"

using repro::BR;

namespace {

constexpr size_t kMaxSmem = 200 * 1024;  // of the 227 KB a block may use

// Shared memory of an anneal block: J (if it fits) + [cos; sin] rows + extra.
struct Layout {
  bool j_shared;
  size_t bytes;
};

Layout layout(int n, size_t extra_floats) {
  const size_t base = (size_t)2 * BR * n + extra_floats;
  const size_t with_j = ((size_t)n * n + base) * sizeof(float);
  if (with_j <= kMaxSmem) return {true, with_j};
  return {false, base * sizeof(float)};
}

// Stage J into shared memory when it fits; returns the pointer the anneal
// reads J through and the [cos; sin] buffer that follows it.
__device__ __forceinline__ const float* stage_j(const float* __restrict__ j,
                                                float* smem, int n,
                                                bool j_shared, float** cs) {
  if (!j_shared) {
    *cs = smem;
    return j;
  }
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) smem[q] = j[q];
  *cs = smem + (size_t)n * n;
  return smem;
}

__device__ __forceinline__ void load_phases(const float* __restrict__ phi0,
                                            int n, int i, float (&phi)[BR]) {
#pragma unroll
  for (int r = 0; r < BR; ++r) phi[r] = phi0[r * n + i];
}

// Sign readout (cos phi >= 0 -> +1) of the block's rows into sp (BR x n).
__device__ __forceinline__ void sign_rows(const float (&phi)[BR], float* sp,
                                          int n, int i) {
#pragma unroll
  for (int r = 0; r < BR; ++r) sp[r * n + i] = cosf(phi[r]) >= 0.0f ? 1.0f : -1.0f;
}

__global__ void trajectory_kernel(const float* __restrict__ j,
                                  const float* __restrict__ h,
                                  const float* __restrict__ phi0,
                                  float* __restrict__ out, int r, int n,
                                  int steps, float dt, float ks_max,
                                  bool j_shared) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, i = threadIdx.x;
  const size_t rows = (size_t)b * r * n + (size_t)blockIdx.x * BR * n;
  float* cs;
  const float* jr = stage_j(j + (size_t)b * n * n, smem, n, j_shared, &cs);
  float phi[BR];
  load_phases(phi0 + rows, n, i, phi);
  __syncthreads();
  repro::anneal(phi, jr, h[(size_t)b * n + i], cs, n, i, steps, dt, ks_max);
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) out[rows + rr * n + i] = phi[rr];
}

__global__ void readout_kernel(const float* __restrict__ j,
                               const float* __restrict__ h,
                               const float* __restrict__ ju,
                               const float* __restrict__ hu,
                               const float* __restrict__ phi0,
                               float* __restrict__ spins,
                               float* __restrict__ energies, int r, int n,
                               int steps, float dt, float ks_max,
                               bool j_shared) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, i = threadIdx.x;
  const size_t rows = (size_t)b * r * n + (size_t)blockIdx.x * BR * n;
  float* cs;
  const float* jr = stage_j(j + (size_t)b * n * n, smem, n, j_shared, &cs);
  float phi[BR];
  load_phases(phi0 + rows, n, i, phi);
  __syncthreads();
  repro::anneal(phi, jr, h[(size_t)b * n + i], cs, n, i, steps, dt, ks_max);
  float* sp = cs;           // BR x n spins (the anneal is done with cs)
  float* el = cs + BR * n;  // BR x n energy densities
  sign_rows(phi, sp, n, i);
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) spins[rows + rr * n + i] = sp[rr * n + i];
  __syncthreads();
  float e[BR];
  repro::lane_energies(sp, ju + (size_t)b * n * n, hu[(size_t)b * n + i], n, i, e);
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) el[rr * n + i] = e[rr];
  __syncthreads();
  if (i < BR)
    energies[(size_t)b * r + blockIdx.x * BR + i] = repro::row_sum(el + i * n, n);
}

// Pass 1 of the fused best-of: anneal, sign, per-slot energies through the
// lane->slot mask (reads past a slot's budget -> +inf), and each slot's
// first-argmin row within the block.  blk_e (B, nblk, S), blk_rows
// (B, nblk, S, n).
__global__ void fused_best_blocks_kernel(
    const float* __restrict__ j, const float* __restrict__ h,
    const float* __restrict__ ju, const float* __restrict__ hu,
    const float* __restrict__ mask, const float* __restrict__ reads,
    const float* __restrict__ phi0, float* __restrict__ blk_e,
    float* __restrict__ blk_rows, int r, int n, int s_slots, int steps,
    float dt, float ks_max, bool j_shared) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, blk = blockIdx.x, i = threadIdx.x;
  const int nblk = gridDim.x;
  const size_t rows = (size_t)b * r * n + (size_t)blk * BR * n;
  float* cs;
  const float* jr = stage_j(j + (size_t)b * n * n, smem, n, j_shared, &cs);
  float phi[BR];
  load_phases(phi0 + rows, n, i, phi);
  __syncthreads();
  repro::anneal(phi, jr, h[(size_t)b * n + i], cs, n, i, steps, dt, ks_max);
  float* sp = cs;
  float* el = cs + BR * n;
  float* es = cs + 2 * BR * n;                             // BR x S
  int* first = reinterpret_cast<int*>(es + BR * s_slots);  // S
  sign_rows(phi, sp, n, i);
  __syncthreads();
  float e[BR];
  repro::lane_energies(sp, ju + (size_t)b * n * n, hu[(size_t)b * n + i], n, i, e);
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) el[rr * n + i] = e[rr];
  __syncthreads();
  mask += (size_t)b * n * s_slots;
  reads += (size_t)b * s_slots;
  // Slot energies: the lane densities folded through the 0/1 lane->slot
  // mask, lanes in order.  Exact only because chip instances are integers
  // (h, J in [-14, 14], spins +-1): every density and partial sum is an
  // integer far below 2^24, so no float32 sum rounds and this order, the
  // readout's row_sum and the plain version's einsum all agree.
  for (int t = i; t < BR * s_slots; t += blockDim.x) {
    const int rr = t / s_slots, sl = t % s_slots;
    float acc = 0.0f;
    for (int q = 0; q < n; ++q) acc = fmaf(el[rr * n + q], mask[q * s_slots + sl], acc);
    es[t] = (float)(blk * BR + rr) < reads[sl] ? acc : INFINITY;
  }
  __syncthreads();
  for (int sl = i; sl < s_slots; sl += blockDim.x) {
    float best = es[sl];
    int f = 0;
    for (int rr = 1; rr < BR; ++rr) {
      const float v = es[rr * s_slots + sl];
      if (v < best) {  // strict: the earliest row wins ties
        best = v;
        f = rr;
      }
    }
    blk_e[((size_t)b * nblk + blk) * s_slots + sl] = best;
    first[sl] = f;
  }
  __syncthreads();
  for (int sl = 0; sl < s_slots; ++sl)
    blk_rows[(((size_t)b * nblk + blk) * s_slots + sl) * n + i] = sp[first[sl] * n + i];
}

// Pass 2: per instance and slot, scan the blocks in index order with a strict
// < (the Pallas carry across replica blocks) and copy out the winner.
// Grid (B,), one thread per lane.  e_out (B, S), s_out (B, S, n).
__global__ void fused_best_reduce_kernel(const float* __restrict__ blk_e,
                                         const float* __restrict__ blk_rows,
                                         float* __restrict__ e_out,
                                         float* __restrict__ s_out, int nblk,
                                         int s_slots, int n) {
  const int b = blockIdx.x, i = threadIdx.x;
  for (int sl = 0; sl < s_slots; ++sl) {
    float best = blk_e[(size_t)b * nblk * s_slots + sl];
    int bi = 0;
    for (int q = 1; q < nblk; ++q) {
      const float v = blk_e[((size_t)b * nblk + q) * s_slots + sl];
      if (v < best) {
        best = v;
        bi = q;
      }
    }
    s_out[((size_t)b * s_slots + sl) * n + i] =
        blk_rows[(((size_t)b * nblk + bi) * s_slots + sl) * n + i];
    if (i == 0) e_out[(size_t)b * s_slots + sl] = best;
  }
}

bool bad_shape(int b, int r, int n) {
  return b < 1 || b > 65535 || r < BR || r % BR != 0 || n % 4 != 0 || n < BR ||
         n > 1024;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// All arrays float32 and contiguous; J (B, N, N), h (B, N), phases (B, R, N)
// with R % 8 == 0, N % 4 == 0, 8 <= N <= 1024.  Each entry returns the CUDA
// error of its launches (0 on success).

extern "C" int cobi_trajectory(const void* j, const void* h, const void* phi0,
                               void* out, int b, int r, int n, int steps,
                               float dt, float ks_max, void* stream) {
  if (bad_shape(b, r, n) || steps < 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, 0);
  cudaError_t err = allow_smem(trajectory_kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  trajectory_kernel<<<dim3(r / BR, b), n, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)j, (const float*)h, (const float*)phi0, (float*)out, r, n,
      steps, dt, ks_max, lay.j_shared);
  return (int)cudaGetLastError();
}

extern "C" int cobi_readout(const void* j, const void* h, const void* ju,
                            const void* hu, const void* phi0, void* spins,
                            void* energies, int b, int r, int n, int steps,
                            float dt, float ks_max, void* stream) {
  if (bad_shape(b, r, n) || steps < 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, 0);
  cudaError_t err = allow_smem(readout_kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  readout_kernel<<<dim3(r / BR, b), n, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)j, (const float*)h, (const float*)ju, (const float*)hu,
      (const float*)phi0, (float*)spins, (float*)energies, r, n, steps, dt,
      ks_max, lay.j_shared);
  return (int)cudaGetLastError();
}

// mask (B, N, S), reads (B, S); scratch blk_e (B, R/8, S) and blk_rows
// (B, R/8, S, N) are the caller's; outputs e_out (B, S), s_out (B, S, N).
// 1 <= S <= N: a bin holds at most one job per lane; the slot scratch
// (BR*S + S floats) grows the block's shared memory with S.
extern "C" int cobi_fused_best(const void* j, const void* h, const void* ju,
                               const void* hu, const void* mask,
                               const void* reads, const void* phi0,
                               void* blk_e, void* blk_rows, void* e_out,
                               void* s_out, int b, int r, int n, int s_slots,
                               int steps, float dt, float ks_max,
                               void* stream) {
  if (bad_shape(b, r, n) || steps < 0 || s_slots < 1 || s_slots > n)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, (size_t)BR * s_slots + s_slots);
  cudaError_t err = allow_smem(fused_best_blocks_kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nblk = r / BR;
  fused_best_blocks_kernel<<<dim3(nblk, b), n, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)j, (const float*)h, (const float*)ju, (const float*)hu,
      (const float*)mask, (const float*)reads, (const float*)phi0,
      (float*)blk_e, (float*)blk_rows, r, n, s_slots, steps, dt, ks_max,
      lay.j_shared);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_best_reduce_kernel<<<b, n, 0, (cudaStream_t)stream>>>(
      (const float*)blk_e, (const float*)blk_rows, (float*)e_out,
      (float*)s_out, nblk, s_slots, n);
  return (int)cudaGetLastError();
}
