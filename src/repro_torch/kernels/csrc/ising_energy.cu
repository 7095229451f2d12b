// Batched Ising energy E_r = h . s_r + s_r^T J s_r on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ising_energy.py::ising_energy_pallas
// (_energy_kernel, _energy_core) and, through the batch index, its stacked
// twin ising_energy_batched_pallas.
//
// What bounds it on an H100: bytes.  Per instance it reads J (n*n floats)
// and R*n spins once and does 2*R*n*n multiply-adds; at the main path's
// R = 8, n = 128 that is ~70 KB against ~0.5 MFLOP, far below the ~20 FLOP
// per byte where float32 FMA would take over, and the whole call is a few
// microseconds of launch latency.
//
// Design: grid (R / BR, B), one thread per lane, BR = 8 replica rows per
// block.  The block's spins are staged in shared memory and read back as
// broadcast float4s; each thread streams its column of J from global memory
// (coalesced across the warp, L2-resident after the first block) and keeps
// BR partial sums in registers.  The row sum is a fixed-order pass over the
// densities, shared with the COBI readout epilogues (ising_energy.cuh).
#include <cuda_runtime.h>

#include "ising_energy.cuh"

using repro::BR;

__global__ void ising_energy_kernel(const float* __restrict__ spins,
                                    const float* __restrict__ h,
                                    const float* __restrict__ j,
                                    float* __restrict__ out, int r, int n) {
  extern __shared__ float smem[];
  float* sp = smem;           // BR x n spins
  float* el = smem + BR * n;  // BR x n energy densities
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int i = threadIdx.x;
  spins += (size_t)b * r * n + (size_t)row0 * n;
  h += (size_t)b * n;
  j += (size_t)b * n * n;
  out += (size_t)b * r + row0;

#pragma unroll
  for (int rr = 0; rr < BR; ++rr) sp[rr * n + i] = spins[rr * n + i];
  __syncthreads();
  float e[BR];
  repro::lane_energies(sp, j, h[i], n, i, e);
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) el[rr * n + i] = e[rr];
  __syncthreads();
  if (i < BR) out[i] = repro::row_sum(el + i * n, n);
}

// spins (B, R, N), h (B, N), j (B, N, N) -> out (B, R); all float32,
// contiguous, R % 8 == 0, N % 4 == 0, 8 <= N <= 1024.
extern "C" int ising_energy(const void* spins, const void* h, const void* j,
                            void* out, int b, int r, int n, void* stream) {
  if (b < 1 || r % BR != 0 || n % 4 != 0 || n < BR || n > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * BR * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ising_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ising_energy_kernel<<<dim3(r / BR, b), n, smem, (cudaStream_t)stream>>>(
      (const float*)spins, (const float*)h, (const float*)j, (float*)out, r,
      n);
  return (int)cudaGetLastError();
}
