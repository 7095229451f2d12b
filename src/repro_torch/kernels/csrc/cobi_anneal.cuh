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
//
// Design (a block of kThreads = 256 threads anneals AR = 2 replica rows of
// one instance of n lanes, so an instance's R rows run on R / 2 SMs):
//
//  * Live extent.  While J is staged, the block finds E = 1 + max{k, i :
//    J[k][i] != 0}, rounded up to a multiple of 4 (0 for J == 0).  The dot
//    products run over k < E, and only lanes i < E compute them; lanes past
//    E take acc = +0.  Bit-identical to summing all n lanes, for any J: every
//    skipped term is an exact +-0 product, and an FMA chain that starts at +0
//    is never changed by adding +-0.  A packed bin gets the cut of its own
//    occupied lanes, the direct path's 20 spins on 128 lanes (128/20)^2.
//  * One (row, lane) a thread, one in-order chain per output.  A thread keeps
//    its phase in a register and computes its two dot products (the cos and
//    the sin row), each one accumulator adding k = 0, 1, ..., E - 1 in order.
//    k is never split, so a job's sums do not depend on where it sits in its
//    bin (packed == solo, fused == readout + first argmin).  A warp holds 32
//    consecutive lanes of one row: its [cos; sin] reads are broadcasts and
//    its float4 reads of 2J fall in distinct banks.  At the shapes the main
//    path runs, the shared-memory wavefronts of these reads, not the FMAs,
//    bound a step; fewer rows a block means fewer of them on each SM.
//  * 2J is staged once, transposed (jt[i][k] = 2 J[k][i], exact), so a
//    thread reads its lane's couplings as float4 along k; rows are padded to
//    n + 4 floats.  When J does not fit in shared memory it is read from
//    global memory and doubled per load.
//  * [cos; sin] is double-buffered: step t writes buffer t & 1, so one
//    barrier a step suffices (a thread writing buffer t & 1 at step t + 2 has
//    passed step t + 1's barrier, which every reader of step t reached after
//    its reads).  Every thread keeps every barrier, idle or not.
#pragma once

#include <cuda_runtime.h>

#include "ising_energy.cuh"

namespace repro {

constexpr int AR = 2;          // replica rows of an anneal block
constexpr int kThreads = 256;  // threads of an anneal block (8 warps)

// Floats of one padded row of [cos; sin] or of the transposed 2J.
__host__ __device__ inline int row_stride(int n) { return n + 4; }
// Floats of the [cos; sin] double buffer: 2 x (2 AR rows).
__host__ __device__ inline size_t cs_floats(int n) { return (size_t)4 * AR * row_stride(n); }
// Floats of the transposed 2J when it is staged.
__host__ __device__ inline size_t jt_floats(int n) { return (size_t)n * row_stride(n); }
// (row, lane) pairs a thread owns at n lanes, as a power of two (the kernels
// are instantiated for 1, 2, 4 and 8).
inline int tiles_per_thread(int n) {
  const int t = (AR * n + kThreads - 1) / kThreads;
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : 8;
}

// A thread's (row, lane) pairs: pair q = m * kThreads + threadIdx.x belongs
// to warp w = q / 32, which holds row w % AR and lanes 32 (w / AR) .. + 31.
template <int TPT>
struct Tiles {
  int row[TPT];
  int lane[TPT];

  __device__ __forceinline__ Tiles() {
#pragma unroll
    for (int m = 0; m < TPT; ++m) {
      const int q = m * kThreads + threadIdx.x, w = q >> 5;
      row[m] = w % AR;
      lane[m] = 32 * (w / AR) + (q & 31);
    }
  }
};

// Stage 2J transposed into shared memory (if j_shared) and return the live
// extent rounded up to a multiple of 4.  Ends with a barrier.
__device__ __forceinline__ int stage_j(const float* __restrict__ j,
                                       float* __restrict__ jt, int n,
                                       bool j_shared) {
  __shared__ int extent;
  if (threadIdx.x == 0) extent = 0;
  __syncthreads();
  const int stride = row_stride(n);
  int e = 0;
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
    const int k = q / n, i = q - k * n;
    const float v = j[q];
    if (j_shared) jt[i * stride + k] = __fadd_rn(v, v);  // 2J: exact
    if (v != 0.0f) e = max(e, max(k, i) + 1);
  }
  e = __reduce_max_sync(0xffffffffu, e);
  if ((threadIdx.x & 31) == 0) atomicMax(&extent, e);
  __syncthreads();
  return (extent + 3) & ~3;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2J[k..k+3][lane] from the staged transpose or from J in global memory.
template <bool JS>
__device__ __forceinline__ float4 j2_at(const float* __restrict__ j, int n,
                                        int lane, int k) {
  if (JS) return ld4(j + lane * row_stride(n) + k);
  const float* col = j + lane;
  return make_float4(__fadd_rn(col[(k + 0) * n], col[(k + 0) * n]),
                     __fadd_rn(col[(k + 1) * n], col[(k + 1) * n]),
                     __fadd_rn(col[(k + 2) * n], col[(k + 2) * n]),
                     __fadd_rn(col[(k + 3) * n], col[(k + 3) * n]));
}

// The Euler loop over the thread's (row, lane) pairs.  `j` is the
// transposed 2J in shared memory (JS) or J in global memory; `cs` the
// [cos; sin] double buffer; `ext` the live extent (a multiple of 4).  Lanes
// >= n hold phase 0 and are never stored.  Ends with a barrier, so the
// caller may reuse cs.
template <int TPT, bool JS>
__device__ __forceinline__ void anneal_loop(float (&phi)[TPT], const Tiles<TPT>& tl,
                                            const float (&h)[TPT],
                                            const float* __restrict__ j,
                                            float* __restrict__ cs, int n,
                                            int ext, int steps, float dt,
                                            float ks_max) {
  const int stride = row_stride(n);
  for (int t = 0; t < steps; ++t) {
    float* buf = cs + (t & 1) * (2 * AR * stride);
    float s[TPT], c[TPT];
    // sincos of the thread's phases; the live lanes' [cos; sin] into buf
#pragma unroll
    for (int m = 0; m < TPT; ++m) {
      sincosf(phi[m], &s[m], &c[m]);
      if (tl.lane[m] < ext) {
        buf[tl.row[m] * stride + tl.lane[m]] = c[m];
        buf[(AR + tl.row[m]) * stride + tl.lane[m]] = s[m];
      }
    }
    __syncthreads();  // buf is complete
    const float ks =
        __fdiv_rn(__fmul_rn(ks_max, __fadd_rn((float)t, 1.0f)), (float)steps);
#pragma unroll
    for (int m = 0; m < TPT; ++m) {
      float mc = 0.0f, ms = 0.0f;  // [c; s] @ 2J at this (row, lane)
      if (tl.lane[m] < ext) {
        const float* cr = buf + tl.row[m] * stride;
        const float* sr = cr + AR * stride;
#pragma unroll 2
        for (int k = 0; k < ext; k += 4) {  // k in order, 4 at a time
          const float4 cv = ld4(cr + k), sv = ld4(sr + k);
          const float4 w = j2_at<JS>(j, n, tl.lane[m], k);
          mc = fmaf(cv.x, w.x, mc);
          ms = fmaf(sv.x, w.x, ms);
          mc = fmaf(cv.y, w.y, mc);
          ms = fmaf(sv.y, w.y, ms);
          mc = fmaf(cv.z, w.z, mc);
          ms = fmaf(sv.z, w.z, ms);
          mc = fmaf(cv.w, w.w, mc);
          ms = fmaf(sv.w, w.w, ms);
        }
      }
      // the update of this phase
      const float grad = __fadd_rn(__fsub_rn(__fmul_rn(s[m], mc), __fmul_rn(c[m], ms)),
                                   __fmul_rn(h[m], s[m]));
      const float shil = __fmul_rn(ks, __fmul_rn(2.0f, __fmul_rn(s[m], c[m])));
      phi[m] = __fadd_rn(phi[m], __fmul_rn(dt, __fsub_rn(grad, shil)));
    }
  }
  __syncthreads();  // every thread is done with cs: the epilogue may reuse it
}

// The whole anneal of one block: load its AR rows' phases (phi0 points at
// the block's first row, row stride n) and h, stage J (in `smem` when
// j_shared, else read from global memory), run the loop.  Returns the
// [cos; sin] region, free for the epilogue, of cs_floats(n) floats.
template <int TPT>
__device__ __forceinline__ float* anneal(float (&phi)[TPT], const Tiles<TPT>& tl,
                                         const float* __restrict__ j,
                                         const float* __restrict__ h,
                                         const float* __restrict__ phi0,
                                         float* smem, int n, int steps,
                                         float dt, float ks_max,
                                         bool j_shared) {
  float hv[TPT];
#pragma unroll
  for (int m = 0; m < TPT; ++m) {
    const int i = tl.lane[m];
    hv[m] = i < n ? h[i] : 0.0f;
    phi[m] = i < n ? phi0[tl.row[m] * n + i] : 0.0f;
  }
  float* cs = j_shared ? smem + jt_floats(n) : smem;
  const int ext = stage_j(j, smem, n, j_shared);
  if (j_shared)
    anneal_loop<TPT, true>(phi, tl, hv, smem, cs, n, ext, steps, dt, ks_max);
  else
    anneal_loop<TPT, false>(phi, tl, hv, j, cs, n, ext, steps, dt, ks_max);
  return cs;
}

// Apply f(row, lane, phase) to every valid (row, lane) of the thread.
template <int TPT, typename F>
__device__ __forceinline__ void for_each_phase(const float (&phi)[TPT],
                                               const Tiles<TPT>& tl, int n, F f) {
#pragma unroll
  for (int m = 0; m < TPT; ++m)
    if (tl.lane[m] < n) f(tl.row[m], tl.lane[m], phi[m]);
}

}  // namespace repro
