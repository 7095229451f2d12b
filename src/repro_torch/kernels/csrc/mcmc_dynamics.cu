// MCMC asynchronous-sweep Metropolis annealer on Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/mcmc_dynamics.py:
//   mcmc_sweep_batched_pallas      (_mcmc_sweep_kernel, _mcmc_loop)  -> mcmc_sweep
//   mcmc_fused_best_batched_pallas (_mcmc_fused_best_kernel)         -> mcmc_fused_best
// Both take B instances: grid (R / W, B), W replicas per block.
//
// What they compute: R independent replicas anneal down a per-sweep
// temperature ladder; each sweep makes one proposal per live position, in
// order (mode 0) or drawn uniformly (mode 1); dE = -2 s_k (h_k + 2 f_k) with
// the local field f = s J kept by rank-1 updates f -= 2 s_k J[k, :]; the
// Metropolis rule u < exp(min(-dE / T, 0)); each replica keeps the best
// state it visited (strict <).  The fused entry also picks, per instance,
// the first replica attaining the minimum among the first `reads`.
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of the proposal chain.  A replica's proposals depend on each other (each
// reads the f that the previous one updated), so a replica is one warp that
// walks sweeps x n_real proposals in order; an accepted one costs 2n FLOP.
// At the main path's sizes (8 replicas, 128 lanes, 20 live spins, 50
// sweeps) the card's bound is well under a microsecond while one warp's
// 1000 dependent proposals take tens of microseconds.
//
// Design: one warp per replica, W = 8..32 warps per block, no block-wide
// barrier inside the anneal (replicas are independent).  J (64 KB at 128
// lanes) and h stay in shared memory for the whole anneal, as in the COBI
// kernels; each warp keeps its s, f and best-visited rows in shared memory,
// lane q % 32 owning position q.  The Pallas body's one-hot products
// (onehot * s summed, onehot @ J) are indexed reads here: a sum of zeros
// and one value is that value, so the bits are the same.  Proposals at
// t >= n_real are skipped: the reference runs them with a flip factor of 0,
// which changes no value.
//
// Bitwise agreement with the plain version (kernels/ref.py):
//   * randomness is counter-based (mcmc_u01): a hash of (seed, replica,
//     sweep, proposal), plain uint32 arithmetic, the same under any split
//     of replicas over blocks;
//   * the ladder T(t) comes from the host (mcmc_ladder), so the device's
//     powf never enters; expf and the division are the IEEE ones (no fast
//     math), as PyTorch's exp and division on the card;
//   * every product in an update is exact (factors +-1, +-2, 0), so FMA
//     contraction cannot change a bit;
//   * f0 = s0 J adds the rows in order; e0 sums s0 h + s0 f0 as the
//     reference's XLA does on the CPU (formulation.row_sum): windows of 32
//     lanes in order, then the window sums in order.
//
// Ties in the fused best-of: blocks run in no order, so it is two launches:
// pass 1 writes each block's first-argmin (energy, row); pass 2 scans the
// blocks in index order with a strict <.  No atomic decides a tie.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kCtrRep = 0x9E3779B1u;
constexpr uint32_t kCtrSweep = 0x85EBCA77u;
constexpr uint32_t kCtrPos = 0xC2B2AE3Du;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSmem = 200 * 1024;  // of the 227 KB a block may use

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// mcmc_u01: 24 mantissa bits, exact in float32.
__device__ __forceinline__ float u01(uint32_t seed, uint32_t rep, uint32_t sweep,
                                     uint32_t pos) {
  const uint32_t x = seed + rep * kCtrRep + sweep * kCtrSweep + pos * kCtrPos;
  return (float)(mix32(x) >> 8) * (1.0f / 16777216.0f);
}

// Shared memory of a block of W replicas: J (if it fits), h, and per warp
// the s, f and best rows, then W floats of block energies.
struct Layout {
  bool j_shared;
  size_t bytes;
};

Layout layout(int n, int w) {
  const size_t state = (size_t)n + (size_t)3 * w * n + w;
  const size_t with_j = ((size_t)n * n + state) * sizeof(float);
  if (with_j <= kMaxSmem) return {true, with_j};
  return {false, state * sizeof(float)};
}

// Warps per block: the largest of 32, 16, 8 that divides replica_block and
// whose state fits shared memory.
int block_rows(int n, int replica_block) {
  int w = 32;
  while (w > 8 && (replica_block % w != 0 || layout(n, w).bytes > kMaxSmem)) w /= 2;
  return w;
}

struct Instance {
  const float* j;  // J: shared memory or global
  const float* h;  // shared
  const float* temps;
  uint32_t seed_pick, seed_acc;
  int n_real;
  float reads;
};

// Stage one instance's J and h and read its seeds and params.
__device__ Instance stage(const float* __restrict__ j, const float* __restrict__ h,
                          const long long* __restrict__ seeds,
                          const float* __restrict__ params,
                          const float* __restrict__ temps, float* smem, int n,
                          int sweeps, bool j_shared, float** rest) {
  const int b = blockIdx.y;
  const float* jb = j + (size_t)b * n * n;
  float* hs = smem;
  float* after = smem + n;
  if (j_shared) {
    float* js = after;
    for (int q = threadIdx.x; q < n * n; q += blockDim.x) js[q] = jb[q];
    jb = js;
    after += (size_t)n * n;
  }
  for (int q = threadIdx.x; q < n; q += blockDim.x) hs[q] = h[(size_t)b * n + q];
  *rest = after;
  Instance in;
  in.j = jb;
  in.h = hs;
  in.temps = temps + (size_t)b * sweeps;
  in.seed_pick = (uint32_t)seeds[b * 4 + 1];
  in.seed_acc = (uint32_t)seeds[b * 4 + 2];
  in.n_real = (int)params[b * 4 + 2];
  in.reads = params[b * 4 + 3];
  return in;
}

// One warp anneals replica `rep` from s0_row; returns its best energy and
// leaves its best state in `best` (shared, n floats).
__device__ float anneal_warp(const Instance& in, const float* __restrict__ s0_row,
                             float* s, float* f, float* best, int n, int sweeps,
                             int chunk, int mode, uint32_t rep) {
  const int lane = threadIdx.x & 31;
  for (int q = lane; q < n; q += 32) s[q] = s0_row[q];
  __syncwarp();
  for (int q = lane; q < n; q += 32) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc += s[i] * in.j[(size_t)i * n + q];
    f[q] = acc;
    best[q] = s[q];
  }
  __syncwarp();
  // e0 in row_sum order: lane c sums window c in order, then every lane
  // adds the window sums in order.
  float wsum = 0.0f;
  if (lane < n / 32) {
    for (int i = 0; i < 32; ++i) {
      const int q = lane * 32 + i;
      wsum += s[q] * in.h[q] + s[q] * f[q];
    }
  }
  float e = 0.0f;
  for (int c = 0; c < n / 32; ++c) e += __shfl_sync(kFull, wsum, c);
  float best_e = e;

  const float n_live = (float)in.n_real;
  for (int ts = 0; ts < sweeps; ++ts) {
    const float t_div = fmaxf(in.temps[ts], 1e-9f);
    for (int c0 = 0; c0 < in.n_real; c0 += chunk) {
      const int c1 = min(c0 + chunk, in.n_real);
      for (int t = c0; t < c1; ++t) {
        const float u_acc = u01(in.seed_acc, rep, (uint32_t)ts, (uint32_t)t);
        int k = t;
        if (mode == 1) k = (int)floorf(u01(in.seed_pick, rep, (uint32_t)ts, (uint32_t)t) * n_live);
        const float s_k = s[k], f_k = f[k], h_k = in.h[k];
        __syncwarp();  // every lane has read s[k], f[k] before any writes
        const float de = (-2.0f * s_k) * (h_k + 2.0f * f_k);
        if (u_acc < expf(fminf(-de / t_div, 0.0f))) {  // warp-uniform
          const float coef = 2.0f * s_k;
          const float* jk = in.j + (size_t)k * n;
          for (int q = lane; q < n; q += 32) f[q] = f[q] - coef * jk[q];
          if (lane == (k & 31)) s[k] = -s_k;
          e = e + de;
          __syncwarp();
          if (e < best_e) {
            best_e = e;
            for (int q = lane; q < n; q += 32) best[q] = s[q];
          }
          __syncwarp();
        }
      }
    }
  }
  return best_e;
}

__global__ void sweep_kernel(const float* __restrict__ j, const float* __restrict__ h,
                             const float* __restrict__ s0,
                             const long long* __restrict__ seeds,
                             const float* __restrict__ params,
                             const float* __restrict__ temps, float* __restrict__ e_out,
                             float* __restrict__ s_out, int r, int n, int sweeps,
                             int chunk, int mode, bool j_shared) {
  extern __shared__ float smem[];
  float* rest;
  const Instance in = stage(j, h, seeds, params, temps, smem, n, sweeps, j_shared, &rest);
  __syncthreads();
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  float* s = rest + (size_t)w * 3 * n;
  const uint32_t rep = blockIdx.x * nw + w;
  const size_t row = (size_t)blockIdx.y * r + rep;
  const float best_e = anneal_warp(in, s0 + row * n, s, s + n, s + 2 * n, n, sweeps,
                                   chunk, mode, rep);
  for (int q = lane; q < n; q += 32) s_out[row * n + q] = s[2 * n + q];
  if (lane == 0) e_out[row] = best_e;
}

// Pass 1 of the fused best-of: anneal, then the block's first-argmin over
// its replicas (replicas at index >= reads count as +inf).  blk_e (B, nblk),
// blk_rows (B, nblk, n).
__global__ void fused_blocks_kernel(const float* __restrict__ j, const float* __restrict__ h,
                                    const float* __restrict__ s0,
                                    const long long* __restrict__ seeds,
                                    const float* __restrict__ params,
                                    const float* __restrict__ temps,
                                    float* __restrict__ blk_e, float* __restrict__ blk_rows,
                                    int r, int n, int sweeps, int chunk, int mode,
                                    bool j_shared) {
  extern __shared__ float smem[];
  float* rest;
  const Instance in = stage(j, h, seeds, params, temps, smem, n, sweeps, j_shared, &rest);
  __syncthreads();
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  float* s = rest + (size_t)w * 3 * n;
  float* es = rest + (size_t)nw * 3 * n;  // nw block energies
  const uint32_t rep = blockIdx.x * nw + w;
  const size_t row = (size_t)blockIdx.y * r + rep;
  const float best_e = anneal_warp(in, s0 + row * n, s, s + n, s + 2 * n, n, sweeps,
                                   chunk, mode, rep);
  if (lane == 0) es[w] = (float)rep < in.reads ? best_e : INFINITY;
  __syncthreads();
  int first = 0;
  float lo = es[0];
  for (int q = 1; q < nw; ++q) {
    if (es[q] < lo) {  // strict: the earliest replica wins ties
      lo = es[q];
      first = q;
    }
  }
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* win = rest + (size_t)first * 3 * n + 2 * n;
  for (int q = threadIdx.x; q < n; q += blockDim.x) blk_rows[blk * n + q] = win[q];
  if (threadIdx.x == 0) blk_e[blk] = lo;
}

// Pass 2: per instance, scan the blocks in index order with a strict <.
// Grid (B,), threads over lanes.  e_out (B,), s_out (B, n).
__global__ void fused_reduce_kernel(const float* __restrict__ blk_e,
                                    const float* __restrict__ blk_rows,
                                    float* __restrict__ e_out, float* __restrict__ s_out,
                                    int nblk, int n) {
  const int b = blockIdx.x;
  float lo = blk_e[(size_t)b * nblk];
  int first = 0;
  for (int q = 1; q < nblk; ++q) {
    const float v = blk_e[(size_t)b * nblk + q];
    if (v < lo) {
      lo = v;
      first = q;
    }
  }
  for (int q = threadIdx.x; q < n; q += blockDim.x)
    s_out[(size_t)b * n + q] = blk_rows[((size_t)b * nblk + first) * n + q];
  if (threadIdx.x == 0) e_out[b] = lo;
}

bool bad_args(int b, int r, int n, int sweeps, int chunk, int mode, int replica_block) {
  return b < 1 || b > 65535 || n < 32 || n > 1024 || n % 32 != 0 || sweeps < 0 ||
         chunk < 1 || n % chunk != 0 || (mode != 0 && mode != 1) || replica_block < 8 ||
         replica_block % 8 != 0 || r < replica_block || r % replica_block != 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// All float arrays float32 and contiguous: J (B, N, N), h (B, N), s0 (B, R, N)
// +-1, params (B, 4) [t_hi, t_lo, n_real, reads], temps (B, sweeps); seeds
// (B, 4) int64 words [init, pick, accept, spare], each < 2^32.  N % 32 == 0,
// 32 <= N <= 1024, N % chunk == 0, R % replica_block == 0, replica_block %
// 8 == 0; mode 0 = in-order sweep, 1 = random proposals.  Each entry
// returns the CUDA error of its launches (0 on success).

// e_out (B, R), s_out (B, R, N): each replica's best-visited state.
extern "C" int mcmc_sweep(const void* j, const void* h, const void* s0, const void* seeds,
                          const void* params, const void* temps, void* e_out, void* s_out,
                          int b, int r, int n, int sweeps, int chunk, int mode,
                          int replica_block, void* stream) {
  if (bad_args(b, r, n, sweeps, chunk, mode, replica_block)) return (int)cudaErrorInvalidValue;
  const int w = block_rows(n, replica_block);
  const Layout lay = layout(n, w);
  cudaError_t err = allow_smem(sweep_kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<dim3(r / w, b), 32 * w, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)j, (const float*)h, (const float*)s0, (const long long*)seeds,
      (const float*)params, (const float*)temps, (float*)e_out, (float*)s_out, r, n,
      sweeps, chunk, mode, lay.j_shared);
  return (int)cudaGetLastError();
}

// Scratch blk_e (B, R / 8) and blk_rows (B, R / 8, N) are the caller's
// (a block holds at least 8 replicas); outputs e_out (B,), s_out (B, N).
extern "C" int mcmc_fused_best(const void* j, const void* h, const void* s0,
                               const void* seeds, const void* params, const void* temps,
                               void* blk_e, void* blk_rows, void* e_out, void* s_out,
                               int b, int r, int n, int sweeps, int chunk, int mode,
                               int replica_block, void* stream) {
  if (bad_args(b, r, n, sweeps, chunk, mode, replica_block)) return (int)cudaErrorInvalidValue;
  const int w = block_rows(n, replica_block);
  const Layout lay = layout(n, w);
  cudaError_t err = allow_smem(fused_blocks_kernel, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nblk = r / w;
  fused_blocks_kernel<<<dim3(nblk, b), 32 * w, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)j, (const float*)h, (const float*)s0, (const long long*)seeds,
      (const float*)params, (const float*)temps, (float*)blk_e, (float*)blk_rows, r, n,
      sweeps, chunk, mode, lay.j_shared);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_reduce_kernel<<<b, n, 0, (cudaStream_t)stream>>>(
      (const float*)blk_e, (const float*)blk_rows, (float*)e_out, (float*)s_out, nblk, n);
  return (int)cudaGetLastError();
}
