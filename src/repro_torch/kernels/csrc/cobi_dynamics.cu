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
// Every entry takes a batch index B: grid (R / AR, B), AR = 2 replica rows
// of one packed chip bin (or solo instance) per block.  The chip farm's
// drains launch B bins at once; a bin packs several jobs block-diagonally,
// one slot per job.
//
// Packed == solo, bit for bit: the Euler loop keeps one accumulator per
// output and adds the lanes in order (cobi_anneal.cuh), so a job's lanes in
// a bin see the other slots' lanes only as exact zero products (their
// couplings to the job are 0), and a job's packed anneal equals its solo
// anneal.
//
// What bounds it on an H100: at the main path's sizes, not the card's
// float32 rate.  Each of `steps` Euler steps does a (2R x E) @ (E x E)
// float32 product over the instance's live extent E (4*R*E*E FLOP) plus
// 2*R*n sin/cos; the bytes are J once and the phases once.  At R = 8, E =
// 128, steps = 400 that is 2.1e8 FLOP against ~80 KB: a 3 us job at the
// card's float32 peak.  But the steps run one after another, and a step's
// product is small: at the direct document's E = 20 a step is a chain of
// latencies (sincosf, one barrier, a 20-term dot chain, the update); at a
// farm bin's E ~ 120 it is the shared-memory wavefronts that feed the FMAs.
//
// Design: grid (R / AR, B), 256 threads a block, one (row, lane) a thread
// (cobi_anneal.cuh): an instance's 8 reads anneal on 4 SMs, the farm's 20
// bins on 80.  J stays resident in shared memory for the whole trajectory,
// doubled and transposed (68 KB at n = 128); each step writes the live
// lanes' [cos; sin] into one of two buffers, and each thread takes its dot
// products over the live extent from float4 reads.  Phases never leave the
// block in the readout and fused kernels: the sign readout and the energy
// epilogue (ising_energy.cuh, one thread per lane) run on the block's shared
// spins.
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

using repro::AR;
using repro::kThreads;
using repro::Tiles;

namespace {

constexpr size_t kMaxSmem = 200 * 1024;  // of the 227 KB a block may use

// Shared memory of an anneal block: the transposed 2J (if it fits), then the
// [cos; sin] double buffer, which the epilogue reuses for its AR x n spins,
// AR x n energy densities and `extra` floats (AR x S slot energies and S
// first rows).
struct Layout {
  bool j_shared;
  size_t bytes;
};

Layout layout(int n, size_t extra_floats) {
  const size_t cs = repro::cs_floats(n);
  const size_t epilogue = (size_t)2 * AR * n + extra_floats;
  const size_t base = cs > epilogue ? cs : epilogue;
  const size_t with_j = (repro::jt_floats(n) + base) * sizeof(float);
  if (with_j <= kMaxSmem) return {true, with_j};
  return {false, base * sizeof(float)};
}

// Sign readout (cos phi >= 0 -> +1) of the block's rows into sp (AR x n).
template <int TPT>
__device__ __forceinline__ void sign_rows(const float (&phi)[TPT],
                                          const Tiles<TPT>& tl, float* sp, int n) {
  repro::for_each_phase(phi, tl, n, [&](int r, int i, float p) {
    sp[r * n + i] = cosf(p) >= 0.0f ? 1.0f : -1.0f;
  });
}

// Per-lane energy densities of the block's spins into el (AR x n), one
// thread per lane.
__device__ __forceinline__ void lane_densities(const float* sp, float* el,
                                               const float* __restrict__ ju,
                                               const float* __restrict__ hu,
                                               int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float e[AR];
    repro::lane_energies(sp, ju, hu[i], n, i, e);
#pragma unroll
    for (int rr = 0; rr < AR; ++rr) el[rr * n + i] = e[rr];
  }
}

template <int TPT>
__global__ void __launch_bounds__(kThreads)
    trajectory_kernel(const float* __restrict__ j, const float* __restrict__ h,
                      const float* __restrict__ phi0, float* __restrict__ out,
                      int r, int n, int steps, float dt, float ks_max,
                      bool j_shared) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const size_t rows = (size_t)b * r * n + (size_t)blockIdx.x * AR * n;
  const Tiles<TPT> tl;
  float phi[TPT];
  repro::anneal(phi, tl, j + (size_t)b * n * n, h + (size_t)b * n, phi0 + rows,
                smem, n, steps, dt, ks_max, j_shared);
  repro::for_each_phase(phi, tl, n,
                        [&](int rr, int i, float p) { out[rows + rr * n + i] = p; });
}

template <int TPT>
__global__ void __launch_bounds__(kThreads)
    readout_kernel(const float* __restrict__ j, const float* __restrict__ h,
                   const float* __restrict__ ju, const float* __restrict__ hu,
                   const float* __restrict__ phi0, float* __restrict__ spins,
                   float* __restrict__ energies, int r, int n, int steps,
                   float dt, float ks_max, bool j_shared) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const size_t rows = (size_t)b * r * n + (size_t)blockIdx.x * AR * n;
  const Tiles<TPT> tl;
  float phi[TPT];
  float* cs = repro::anneal(phi, tl, j + (size_t)b * n * n, h + (size_t)b * n,
                            phi0 + rows, smem, n, steps, dt, ks_max, j_shared);
  float* sp = cs;           // AR x n spins (the anneal is done with cs)
  float* el = cs + AR * n;  // AR x n energy densities
  sign_rows(phi, tl, sp, n);
  __syncthreads();
  for (int q = threadIdx.x; q < AR * n; q += blockDim.x) spins[rows + q] = sp[q];
  lane_densities(sp, el, ju + (size_t)b * n * n, hu + (size_t)b * n, n);
  __syncthreads();
  if (threadIdx.x < AR)
    energies[(size_t)b * r + blockIdx.x * AR + threadIdx.x] =
        repro::row_sum(el + threadIdx.x * n, n);
}

// Pass 1 of the fused best-of: anneal, sign, per-slot energies through the
// lane->slot mask (reads past a slot's budget -> +inf), and each slot's
// first-argmin row within the block.  blk_e (B, nblk, S), blk_rows
// (B, nblk, S, n).
template <int TPT>
__global__ void __launch_bounds__(kThreads) fused_best_blocks_kernel(
    const float* __restrict__ j, const float* __restrict__ h,
    const float* __restrict__ ju, const float* __restrict__ hu,
    const float* __restrict__ mask, const float* __restrict__ reads,
    const float* __restrict__ phi0, float* __restrict__ blk_e,
    float* __restrict__ blk_rows, int r, int n, int s_slots, int steps,
    float dt, float ks_max, bool j_shared) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, blk = blockIdx.x;
  const int nblk = gridDim.x;
  const size_t rows = (size_t)b * r * n + (size_t)blk * AR * n;
  const Tiles<TPT> tl;
  float phi[TPT];
  float* cs = repro::anneal(phi, tl, j + (size_t)b * n * n, h + (size_t)b * n,
                            phi0 + rows, smem, n, steps, dt, ks_max, j_shared);
  float* sp = cs;
  float* el = cs + AR * n;
  float* es = cs + 2 * AR * n;                             // AR x S
  int* first = reinterpret_cast<int*>(es + AR * s_slots);  // S
  sign_rows(phi, tl, sp, n);
  __syncthreads();
  lane_densities(sp, el, ju + (size_t)b * n * n, hu + (size_t)b * n, n);
  __syncthreads();
  mask += (size_t)b * n * s_slots;
  reads += (size_t)b * s_slots;
  // Slot energies: the lane densities folded through the 0/1 lane->slot
  // mask, lanes in order.  Exact only because chip instances are integers
  // (h, J in [-14, 14], spins +-1): every density and partial sum is an
  // integer far below 2^24, so no float32 sum rounds and this order, the
  // readout's row_sum and the plain version's einsum all agree.
  for (int t = threadIdx.x; t < AR * s_slots; t += blockDim.x) {
    const int rr = t / s_slots, sl = t % s_slots;
    float acc = 0.0f;
    for (int q = 0; q < n; ++q) acc = fmaf(el[rr * n + q], mask[q * s_slots + sl], acc);
    es[t] = (float)(blk * AR + rr) < reads[sl] ? acc : INFINITY;
  }
  __syncthreads();
  for (int sl = threadIdx.x; sl < s_slots; sl += blockDim.x) {
    float best = es[sl];
    int f = 0;
    for (int rr = 1; rr < AR; ++rr) {
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
  for (int q = threadIdx.x; q < s_slots * n; q += blockDim.x) {
    const int sl = q / n, i = q - sl * n;
    blk_rows[(((size_t)b * nblk + blk) * s_slots + sl) * n + i] = sp[first[sl] * n + i];
  }
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
  return b < 1 || b > 65535 || r < repro::BR || r % repro::BR != 0 || n % 4 != 0 ||
         n < repro::BR ||
         n > 1024;
}

// Launch `kernel` (one instantiation per tiles-per-thread count) on grid
// (R / AR, B) with the layout's dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int b, int r, const Layout& lay, void* stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(r / AR, b), kThreads, lay.bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

// The instantiation of `kernel_template` for n lanes' tiles per thread.
#define BY_TILES(n, kernel_template, ...)                                   \
  [&]() {                                                                   \
    switch (repro::tiles_per_thread(n)) {                                   \
      case 1: return launch(kernel_template<1>, __VA_ARGS__);               \
      case 2: return launch(kernel_template<2>, __VA_ARGS__);               \
      case 4: return launch(kernel_template<4>, __VA_ARGS__);               \
      default: return launch(kernel_template<8>, __VA_ARGS__);              \
    }                                                                       \
  }()

}  // namespace

// All arrays float32 and contiguous; J (B, N, N), h (B, N), phases (B, R, N)
// with R % 8 == 0, N % 4 == 0, 8 <= N <= 1024.  Each entry returns the CUDA
// error of its launches (0 on success).

extern "C" int cobi_trajectory(const void* j, const void* h, const void* phi0,
                               void* out, int b, int r, int n, int steps,
                               float dt, float ks_max, void* stream) {
  if (bad_shape(b, r, n) || steps < 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, 0);
  return (int)BY_TILES(n, trajectory_kernel, b, r, lay, stream, (const float*)j,
                       (const float*)h, (const float*)phi0, (float*)out, r, n, steps,
                       dt, ks_max, lay.j_shared);
}

extern "C" int cobi_readout(const void* j, const void* h, const void* ju,
                            const void* hu, const void* phi0, void* spins,
                            void* energies, int b, int r, int n, int steps,
                            float dt, float ks_max, void* stream) {
  if (bad_shape(b, r, n) || steps < 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, 0);
  return (int)BY_TILES(n, readout_kernel, b, r, lay, stream, (const float*)j,
                       (const float*)h, (const float*)ju, (const float*)hu,
                       (const float*)phi0, (float*)spins, (float*)energies, r, n,
                       steps, dt, ks_max, lay.j_shared);
}

// The replica rows of an anneal block (AR): the fused best's scratch has
// one entry per block, R / AR of them, and its caller sizes it from this.
extern "C" int cobi_anneal_rows() { return AR; }

// mask (B, N, S), reads (B, S); scratch blk_e (B, R/AR, S) and blk_rows
// (B, R/AR, S, N) are the caller's (one entry per anneal block, see
// cobi_anneal_rows); outputs e_out (B, S), s_out (B, S, N).  1 <= S <= N: a bin holds at
// most one job per lane; the slot scratch (AR*S + S floats) lives in the
// [cos; sin] region after the anneal.
extern "C" int cobi_fused_best(const void* j, const void* h, const void* ju,
                               const void* hu, const void* mask,
                               const void* reads, const void* phi0,
                               void* blk_e, void* blk_rows, void* e_out,
                               void* s_out, int b, int r, int n, int s_slots,
                               int steps, float dt, float ks_max,
                               void* stream) {
  if (bad_shape(b, r, n) || steps < 0 || s_slots < 1 || s_slots > n)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(n, (size_t)AR * s_slots + s_slots);
  const int nblk = r / AR;
  cudaError_t err = BY_TILES(
      n, fused_best_blocks_kernel, b, r, lay, stream, (const float*)j,
      (const float*)h, (const float*)ju, (const float*)hu, (const float*)mask,
      (const float*)reads, (const float*)phi0, (float*)blk_e, (float*)blk_rows,
      r, n, s_slots, steps, dt, ks_max, lay.j_shared);
  if (err != cudaSuccess) return (int)err;
  fused_best_reduce_kernel<<<b, n, 0, (cudaStream_t)stream>>>(
      (const float*)blk_e, (const float*)blk_rows, (float*)e_out,
      (float*)s_out, nblk, s_slots, n);
  return (int)cudaGetLastError();
}
