// Shared device code: Ising energy densities of a block of replica rows.
//
// E_r = h . s_r + s_r^T J s_r is computed as the row sum of the per-lane
// density e_ri = s_ri * (s_r J)_i + h_i * s_ri, the same decomposition the
// Pallas kernels use (kernels/cobi_dynamics.py:_slot_energies).  Every
// kernel of the port that scores spins (ising_energy, cobi_readout,
// cobi_fused_best) goes through these functions, so their energies agree bit
// for bit on any instance, and on chip-range integer instances every partial
// sum is an integer and the float32 result is exact.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int BR = 8;  // replica rows per thread block

// Per-lane energy densities of BR rows.  One thread per lane i (blockDim.x ==
// n); `sp` holds the rows' spins in shared memory (BR x n, row-major); `j` is
// the (n x n) scoring matrix in global memory, read coalesced along i.
__device__ __forceinline__ void lane_energies(
    const float* __restrict__ sp, const float* __restrict__ j, float h_i,
    int n, int i, float (&e)[BR]) {
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  for (int k = 0; k < n; k += 4) {
    const float j0 = j[(k + 0) * n + i];
    const float j1 = j[(k + 1) * n + i];
    const float j2 = j[(k + 2) * n + i];
    const float j3 = j[(k + 3) * n + i];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(sp + r * n + k);
      acc[r] = fmaf(v.x, j0, acc[r]);
      acc[r] = fmaf(v.y, j1, acc[r]);
      acc[r] = fmaf(v.z, j2, acc[r]);
      acc[r] = fmaf(v.w, j3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const float s = sp[r * n + i];
    e[r] = __fadd_rn(__fmul_rn(s, acc[r]), __fmul_rn(h_i, s));
  }
}

// Row sum of one row of densities, lane 0 first (a fixed order, so every
// kernel that sums the same densities gets the same float).
__device__ __forceinline__ float row_sum(const float* __restrict__ el, int n) {
  float acc = 0.0f;
  for (int q = 0; q < n; ++q) acc = __fadd_rn(acc, el[q]);
  return acc;
}

}  // namespace repro
