// Shared device code: the Euler loop of the COBI oscillator phase ODE.
//
// Twin of src/repro/kernels/cobi_dynamics.py::_anneal_loop, used by all
// three COBI kernels (trajectory, readout, fused best), so their phases are
// bitwise identical for the same inputs.  Per step and replica row r, lane i:
//
//   s = sin phi, c = cos phi
//   mj = [c; s] @ (J + J)                  (one stacked product, float32 FMA)
//   grad = (s * mj_c - c * mj_s) + h * s
//   ks = ks_max * (t + 1) / steps          (float32 ramp)
//   phi += dt * (grad - ks * (2 * (s * c)))
//
// Every operation outside the dot products is an explicitly rounded
// intrinsic, so no kernel's inlining can contract it into a different FMA.
// sincosf is the accurate library routine: the phases are never wrapped and
// leave [-pi, pi], where the fast __sinf/__cosf lose accuracy.
#pragma once

#include <cuda_runtime.h>

#include "ising_energy.cuh"

namespace repro {

// One thread per lane i (blockDim.x == n); the thread keeps the phases of the
// block's BR rows of its lane in `phi`.  `j` is the (n x n) coupling matrix,
// in shared memory when it fits, else in global memory; `cs` is a shared
// buffer of 2*BR*n floats that holds the stacked [cos; sin] rows of a step.
__device__ __forceinline__ void anneal(float (&phi)[BR],
                                       const float* __restrict__ j, float h_i,
                                       float* __restrict__ cs, int n, int i,
                                       int steps, float dt, float ks_max) {
  for (int t = 0; t < steps; ++t) {
    float s[BR], c[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      sincosf(phi[r], &s[r], &c[r]);
      cs[r * n + i] = c[r];
      cs[(BR + r) * n + i] = s[r];
    }
    __syncthreads();
    float acc[2 * BR];
#pragma unroll
    for (int q = 0; q < 2 * BR; ++q) acc[q] = 0.0f;
    for (int k = 0; k < n; k += 4) {
      float j0 = j[(k + 0) * n + i];
      float j1 = j[(k + 1) * n + i];
      float j2 = j[(k + 2) * n + i];
      float j3 = j[(k + 3) * n + i];
      j0 = __fadd_rn(j0, j0);  // 2J: exact
      j1 = __fadd_rn(j1, j1);
      j2 = __fadd_rn(j2, j2);
      j3 = __fadd_rn(j3, j3);
#pragma unroll
      for (int q = 0; q < 2 * BR; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(cs + q * n + k);
        acc[q] = fmaf(v.x, j0, acc[q]);
        acc[q] = fmaf(v.y, j1, acc[q]);
        acc[q] = fmaf(v.z, j2, acc[q]);
        acc[q] = fmaf(v.w, j3, acc[q]);
      }
    }
    __syncthreads();  // every thread has read cs before the next step writes it
    const float ks =
        __fdiv_rn(__fmul_rn(ks_max, __fadd_rn((float)t, 1.0f)), (float)steps);
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float grad =
          __fadd_rn(__fsub_rn(__fmul_rn(s[r], acc[r]), __fmul_rn(c[r], acc[BR + r])),
                    __fmul_rn(h_i, s[r]));
      const float shil = __fmul_rn(ks, __fmul_rn(2.0f, __fmul_rn(s[r], c[r])));
      phi[r] = __fadd_rn(phi[r], __fmul_rn(dt, __fsub_rn(grad, shil)));
    }
  }
}

}  // namespace repro
