// Shared device code: Ising energy densities of a block of replica rows.
//
// E_r = h . s_r + s_r^T J s_r is computed as the row sum of the per-lane
// density e_ri = s_ri * (s_r J)_i + h_i * s_ri, the same decomposition the
// Pallas kernels use (kernels/cobi_dynamics.py:_slot_energies).  Every
// kernel of the port that scores spins (ising_energy, cobi_readout,
// cobi_fused_best) runs the same arithmetic: (s_r J)_i as an fmaf chain over
// k ascending, then density() and row_sum() below; the COBI epilogues through
// lane_energies(), the energy kernel through its own staging
// (ising_energy.cu).  So their energies agree bit for bit on any instance,
// and on chip-range integer instances every partial sum is an integer and the
// float32 result is exact.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int BR = 8;  // the COBI entries take R in multiples of this

// A lane's energy density from its spin s, its (s J)_i and h_i.
__device__ __forceinline__ float density(float s, float sj, float h_i) {
  return __fadd_rn(__fmul_rn(s, sj), __fmul_rn(h_i, s));
}

// Per-lane energy densities of ROWS rows (an anneal block's rows in the COBI
// epilogues).  One thread per lane i; `sp` holds the rows' spins in shared
// memory (ROWS x n, row-major); `j` is the (n x n) scoring matrix in global
// memory, read coalesced along i.  A row's density does not depend on how
// many rows share the call.
template <int ROWS>
__device__ __forceinline__ void lane_energies(
    const float* __restrict__ sp, const float* __restrict__ j, float h_i,
    int n, int i, float (&e)[ROWS]) {
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < n; k += 4) {
    const float j0 = j[(k + 0) * n + i];
    const float j1 = j[(k + 1) * n + i];
    const float j2 = j[(k + 2) * n + i];
    const float j3 = j[(k + 3) * n + i];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(sp + r * n + k);
      acc[r] = fmaf(v.x, j0, acc[r]);
      acc[r] = fmaf(v.y, j1, acc[r]);
      acc[r] = fmaf(v.z, j2, acc[r]);
      acc[r] = fmaf(v.w, j3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    e[r] = density(sp[r * n + i], acc[r], h_i);
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
