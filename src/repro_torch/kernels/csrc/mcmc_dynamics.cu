// MCMC asynchronous-sweep Metropolis annealer on Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/mcmc_dynamics.py:
//   mcmc_sweep_batched_pallas      (_mcmc_sweep_kernel, _mcmc_loop)  -> mcmc_sweep
//   mcmc_fused_best_batched_pallas (_mcmc_fused_best_kernel)         -> mcmc_fused_best
// Both take B instances: grid (R / 4, B), 4 replicas (one warp each) a block.
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
// reads the f that the previous one updated): at the main path's sizes (8
// replicas, 20 live spins, 50 sweeps) a replica is 1000 dependent
// proposals, while the card's bound is well under a microsecond.  The
// longest link is the test: an IEEE division and expf, ~110 cycles.
//
// Design: one warp per replica, one warp per scheduler (4 a block: two warps
// sharing a scheduler cost ~35% at R 8), its state in registers over the
// live extent only.  Lane q % 32 holds f at positions q, q + 32, ... up to
// E = 32 NW, the least power-of-two word count NW (1..32) with E >= n_real;
// the spins and the best-visited state are NW bit masks every lane holds
// (bit set where s = -1), so a spin is a shift and a new best a register
// move.  Each block stages h and the live n_real x n_real corner of J (rows
// of stride E, zero-filled) in shared memory; where that does not fit, J is
// read from global memory.  Per round of 32 proposals, lane i hashes
// proposal i's uniform and position and gathers h_k into a table, off the
// chain.  The chain then runs in groups of kDepth = 5 proposals, speculated
// across the lanes: lane L < 31 is node L of the group's decision tree,
// proposal `level` under a hypothesis on the outcomes of the ones before
// it; it applies those outcomes' updates to its own proposal's f and s (the
// same fmaf, in the same order, as the owner lane's sequential update) and
// computes its dE.  One warp-wide test decides all 31 nodes; a ballot
// finds the one path of nodes that agrees with itself, and the warp applies
// its updates to f, the spins, the energy and the best-of in order.  So a
// group pays for one test, not five.
//
// Bitwise agreement with the plain version (kernels/ref.py):
//   * randomness is counter-based (u01): a hash of (seed, replica, sweep,
//     proposal), plain uint32 arithmetic, the same under any split of
//     replicas over blocks;
//   * the ladder T(t) comes from the host (mcmc_ladder), so the device's
//     powf never enters; expf and the division are the IEEE ones (no fast
//     math), as PyTorch's exp and division on the card, evaluated for every
//     node as the plain version does (exp(min(+-0, 0)) = 1 > u where dE <= 0);
//   * every product in an update is exact (factors +-1, +-2), so FMA
//     contraction cannot change a bit;
//   * f0 = s0 J adds the live rows in order; e0 sums s0 h + s0 f0 as the
//     reference's XLA does on the CPU (formulation.row_sum): windows of 32
//     lanes in order, then the window sums in order;
//   * what is skipped is exact: rows and lanes past n_real add s J = +-0 to
//     sums that start at +0 and can never be -0 (x + y is -0 only if both
//     are), and a rejected proposal's flip factor of 0 changes no value, so
//     the code applies it instead of branching.  J and h must be zero
//     outside the live n_real x n_real block, as the callers pad them; lanes
//     at or past n_real keep s0 (never read).
//
// Ties in the fused best-of: where an instance's blocks fit one thread
// block cluster (R <= 32) they find the winner together through
// distributed shared memory, scanning replicas in order with a strict <:
// one launch.  Beyond that it is two launches: pass 1 writes each block's
// first-argmin (energy, row); pass 2 scans the blocks in index order with a
// strict <.  No atomic decides a tie.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kCtrRep = 0x9E3779B1u;
constexpr uint32_t kCtrSweep = 0x85EBCA77u;
constexpr uint32_t kCtrPos = 0xC2B2AE3Du;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 4;                 // replicas (warps) a block: one a scheduler
constexpr int kMaxCluster = 8;           // blocks a portable thread block cluster holds
constexpr int kTab = 32;                 // proposals a table round holds
constexpr int kDepth = 5;                // proposals a group decides at once (31 nodes)
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

__device__ __forceinline__ int pick(uint32_t seed, uint32_t rep, uint32_t sweep, uint32_t pos,
                                    float n_live) {
  return (int)floorf(u01(seed, rep, sweep, pos) * n_live);
}

// Words a lane holds for n_real live spins: the least power of two NW with
// 32 NW >= n_real.
__host__ __device__ inline int words_for(int n_real) {
  int w = 1;
  while (32 * w < n_real) w *= 2;
  return w;
}

// Shared memory of a block, in floats: per warp a scratch of max(E, 4 kTab)
// (the e0 terms, then the proposal table), h (E), the block's kRows
// energies; then J's live rows (n_real x E) where they fit.
__host__ __device__ inline size_t scratch_floats(int e) { return e > 4 * kTab ? e : 4 * kTab; }
__host__ __device__ inline size_t base_floats(int e) {
  return kRows * scratch_floats(e) + e + kRows;
}

// The dynamic shared memory a launch on n lanes gets: enough for J at the
// largest extent, capped (the kernel then reads J from global memory where
// the instance's live rows do not fit).
size_t smem_bytes(int n) {
  const int e = 32 * words_for(n);
  const size_t full = (base_floats(e) + (size_t)n * e) * sizeof(float);
  return full < kMaxSmem ? full : kMaxSmem;
}

struct Args {
  const float* j;  // (B, N, N)
  const float* h;  // (B, N)
  const float* s0;  // (B, R, N)
  const long long* seeds;  // (B, 4)
  const float* params;  // (B, 4)
  const float* temps;  // (B, sweeps)
  float* e_out;
  float* s_out;
  float* blk_e;  // fused, more than one block an instance
  float* blk_rows;
  int r, n, sweeps, mode;
  size_t smem;
  bool clustered;  // fused: an instance's blocks form one cluster
};

// J[i][q] of the live block: staged in shared memory at stride E (JS), or
// read from global memory at stride n, zero at or past n_real.
template <int NW, bool JS>
struct JRows {
  const float* __restrict__ p;
  int n, n_real;
  __device__ __forceinline__ float at(int i, int q) const {
    if (JS) return p[i * (32 * NW) + q];
    return q < n_real ? __ldg(p + (size_t)i * n + q) : 0.0f;
  }
  __device__ __forceinline__ void row(int k, int lane, float (&r)[NW]) const {
#pragma unroll
    for (int w = 0; w < NW; ++w) r[w] = at(k, 32 * w + lane);
  }
};

struct Instance {
  const float* h;  // shared, E floats, zero past n_real
  const float* temps;
  uint32_t seed_pick, seed_acc;
  int n_real;
};

// c ? a : b, opaque to the optimiser: a chain of selects between the words
// of a register array otherwise becomes a load at a computed index, which
// moves the array to local memory.
__device__ __forceinline__ uint32_t sel(bool c, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{ .reg .pred p; setp.ne.u32 p, %1, 0; selp.b32 %0, %2, %3, p; }"
      : "=r"(r) : "r"((uint32_t)c), "r"(a), "r"(b));
  return r;
}

// Bit p of a spin mask held as NW words (bit q of word w is position 32 w + q).
template <int NW>
__device__ __forceinline__ uint32_t bit(const uint32_t (&m)[NW], int p) {
  uint32_t v = m[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) v = sel(p >> 5 == w, m[w], v);
  return (v >> (p & 31)) & 1u;
}

__device__ __forceinline__ float spin(uint32_t b) { return b ? -1.0f : 1.0f; }

// The spin at p in a hypothesis: its spin before the group, flipped once by
// each earlier accepted proposal at the same position (`flips`, those
// proposals' bits).
template <int NW>
__device__ __forceinline__ float spin_in(const uint32_t (&sw)[NW], int p, uint32_t flips) {
  return spin(bit(sw, p) ^ (__popc(flips) & 1u));
}

// One warp anneals replica `rep` from s0_row; returns its best energy and
// leaves its best-visited spins in best (bit set where s = -1; the same in
// every lane).  kRandom: proposals at uniform positions (mode 1), else in
// order (mode 0).
template <int NW, bool JS, bool kRandom>
__device__ float anneal(const Instance& in, const JRows<NW, JS> jr,
                        const float* __restrict__ s0_row, int sweeps, uint32_t rep,
                        float* scratch, uint32_t (&best)[NW]) {
  const int lane = threadIdx.x & 31;
  const int n_real = in.n_real;
  uint32_t sw[NW];  // the spins, as masks every lane holds
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int q = 32 * w + lane;
    sw[w] = __ballot_sync(kFull, q < n_real && s0_row[q] < 0.0f);
  }
  float f[NW];  // lane's words of f: f[w] at position 32 w + lane
#pragma unroll
  for (int w = 0; w < NW; ++w) f[w] = 0.0f;
  for (int i = 0; i < n_real; ++i) {  // f0 = s0 J over the live rows, in order
    const float si = s0_row[i];
#pragma unroll
    for (int w = 0; w < NW; ++w) f[w] = fmaf(si, jr.at(i, 32 * w + lane), f[w]);
  }
  // e0 in row_sum order: lane c sums window c in order, then every lane
  // adds the window sums in order.
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int q = 32 * w + lane;
    const float s = spin((sw[w] >> lane) & 1u);
    scratch[q] = s * in.h[q] + s * f[w];
  }
  __syncwarp();
  float wsum = 0.0f;
  if (lane < NW)
    for (int i = 0; i < 32; ++i) wsum += scratch[32 * lane + i];
  float e = 0.0f;
#pragma unroll
  for (int c = 0; c < NW; ++c) e += __shfl_sync(kFull, wsum, c);
  float best_e = e;
#pragma unroll
  for (int w = 0; w < NW; ++w) best[w] = sw[w];
  if (n_real == 0) return best_e;

  // The chain, a group of up to kDepth proposals at a time.  Lane L < 31
  // is node L of the group's decision tree: proposal `level` of the group
  // under the hypothesis `hyp` on the outcomes of the ones before it (bit j
  // = proposal j accepted).  Every lane applies its hypothesis's updates to
  // its own proposal's f and s (the owner lane's operations, in order), and
  // one warp-wide test decides all 31 nodes; the outcome path is the one
  // chain of nodes that agrees with the ballot.
  const int level = 31 - __clz(lane + 1);
  const uint32_t hyp = (uint32_t)(lane + 1 - (1 << level));
  const float n_live = (float)n_real;
  float2* tab = reinterpret_cast<float2*>(scratch);  // per proposal {u, h_k}
  int* tab_k = reinterpret_cast<int*>(scratch + 2 * kTab);  // and its position (kRandom)
  for (int ts = 0; ts < sweeps; ++ts) {
    const float t_div = fmaxf(in.temps[ts], 1e-9f);
    for (int t0 = 0; t0 < n_real; t0 += kTab) {
      const int cnt = min(kTab, n_real - t0);
      __syncwarp();  // every lane is done with the previous table
      // hash and pick: lane i tabulates proposal t0 + i
      if (lane < cnt) {
        const int t = t0 + lane;
        const int kt = kRandom ? pick(in.seed_pick, rep, ts, t, n_live) : t;
        tab[lane] = make_float2(u01(in.seed_acc, rep, ts, t), in.h[kt]);
        if (kRandom) tab_k[lane] = kt;
      }
      __syncwarp();
      for (int g0 = 0; g0 < cnt; g0 += kDepth) {
        // read: the group's positions, this node's proposal and spins, and
        // this node's f as they stand before the group; J's rows and pairs
        const int g = min(kDepth, cnt - g0);
        const int li = min(level, g - 1);  // nodes past the group repeat its last
        int pos[kDepth];
#pragma unroll
        for (int j = 0; j < kDepth; ++j)
          pos[j] = kRandom ? tab_k[g0 + min(j, g - 1)] : t0 + g0 + min(j, g - 1);
        const int pi = kRandom ? tab_k[g0 + li] : t0 + g0 + li;
        const float2 uh = tab[g0 + li];
        float fi = 0.0f;  // f at pi, from its owner lane: every word, then pi's
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float v = __shfl_sync(kFull, f[w], pi & 31);
          fi = w == pi >> 5 ? v : fi;
        }
        constexpr bool kPrefetch = NW <= 4;  // the group's J rows in registers
        float jrows[kPrefetch ? kDepth : 1][NW];
        if constexpr (kPrefetch) {
#pragma unroll
          for (int j = 0; j < kDepth; ++j) jr.row(pos[j], lane, jrows[j]);
        }
        // Repeated positions (random mode; in a sweep the group's differ).
        uint32_t same[kDepth];  // bit j' < j: proposal j' has proposal j's position
        uint32_t same_i = 0;
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          same[j] = 0;
          if constexpr (kRandom) {
#pragma unroll
            for (int jj = 0; jj < j; ++jj) same[j] |= (uint32_t)(pos[jj] == pos[j]) << jj;
            same_i |= (uint32_t)((j < li) & (pos[j] == pi)) << j;
          }
        }
        // this node's f and s under its hypothesis (straight-line code: a
        // proposal the node does not assume accepted, or one past its
        // level, gets the flip factor 0, an exact no-op)
        float fn = fi;
#pragma unroll
        for (int j = 0; j < kDepth - 1; ++j) {
          const bool assumed = (j < li) & (hyp >> j);
          const float c = assumed ? 2.0f * spin_in(sw, pos[j], hyp & same[j]) : 0.0f;
          fn = fmaf(-c, jr.at(pos[j], pi), fn);
        }
        const float si = spin_in(sw, pi, hyp & same_i);
        // test
        const float de = (-2.0f * si) * (uh.y + 2.0f * fn);
        const bool acc = uh.x < expf(fminf(-de / t_div, 0.0f));
        // resolve: the one node of the last level whose hypothesis every
        // decision above it agrees with
        const uint32_t mask = __ballot_sync(kFull, acc);
        bool agrees = level == g - 1;
#pragma unroll
        for (int j = 0; j < kDepth - 1; ++j) {
          const uint32_t node = (1u << j) - 1 + (hyp & ((1u << j) - 1));
          agrees &= (j >= level) | (((mask >> node) ^ (hyp >> j)) & 1u) == 0u;
        }
        const int last = __ffs(__ballot_sync(kFull, agrees)) - 1;
        const uint32_t path =
            (uint32_t)(last + 1 - (1 << (g - 1))) | (((mask >> last) & 1u) << (g - 1));
        // update: f along the path, in order (path bits past the group are 0)
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          const float c = (path >> j) & 1u ? 2.0f * spin_in(sw, pos[j], path & same[j]) : 0.0f;
          float row[NW];
          if constexpr (kPrefetch) {
#pragma unroll
            for (int w = 0; w < NW; ++w) row[w] = jrows[j][w];
          } else {
            jr.row(pos[j], lane, row);
          }
#pragma unroll
          for (int w = 0; w < NW; ++w) f[w] = fmaf(-c, row[w], f[w]);
        }
        // best-of: the spins, the energy and the best state along the path
        float de_path[kDepth];
#pragma unroll
        for (int j = 0; j < kDepth; ++j)
          de_path[j] = __shfl_sync(kFull, de, (1 << j) - 1 + (path & ((1u << j) - 1)));
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          const uint32_t a = (path >> j) & 1u;
#pragma unroll
          for (int w = 0; w < NW; ++w) sw[w] ^= (a & (pos[j] >> 5 == w)) << (pos[j] & 31);
          e = e + (a ? de_path[j] : 0.0f);
          const bool better = e < best_e;
          best_e = better ? e : best_e;
#pragma unroll
          for (int w = 0; w < NW; ++w) best[w] = better ? sw[w] : best[w];
        }
      }  // the group
    }
  }
  return best_e;
}

// A replica's best-visited spins: the live lanes from its masks, the rest s0.
template <int NW>
__device__ void write_row(float* __restrict__ out, const uint32_t (&best)[NW],
                          const float* __restrict__ s0_row, int n, int n_real) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int q = 32 * w + lane;
    if (q < n_real) out[q] = spin((best[w] >> lane) & 1u);
  }
  for (int q = n_real + lane; q < n; q += 32) out[q] = s0_row[q];
}

// One block: kRows replicas of instance blockIdx.y at word count NW, J in
// shared memory (JS) or global.
template <int NW, bool JS, bool kRandom, bool kFused>
__device__ void run(const Args& a, float* smem, int n_real) {
  constexpr int E = 32 * NW;
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.n;
  float* scratch = smem + (size_t)w * scratch_floats(E);
  float* hs = smem + (size_t)kRows * scratch_floats(E);
  float* es = hs + E;
  float* js = es + kRows;
  const float* jb = a.j + (size_t)b * n * n;
  for (int q = threadIdx.x; q < E; q += blockDim.x) hs[q] = q < n_real ? a.h[(size_t)b * n + q] : 0.0f;
  if (JS) {
    for (int x = threadIdx.x; x < n_real * E; x += blockDim.x) {
      const int i = x / E, q = x % E;
      js[x] = q < n_real ? jb[(size_t)i * n + q] : 0.0f;
    }
  }
  __syncthreads();
  Instance in;
  in.h = hs;
  in.temps = a.temps + (size_t)b * a.sweeps;
  in.seed_pick = (uint32_t)a.seeds[b * 4 + 1];
  in.seed_acc = (uint32_t)a.seeds[b * 4 + 2];
  in.n_real = n_real;
  const JRows<NW, JS> jr{JS ? js : jb, n, n_real};
  const uint32_t rep = blockIdx.x * kRows + w;
  const size_t row = (size_t)b * a.r + rep;
  const float* s0_row = a.s0 + row * n;
  uint32_t bits[NW];
  const float best_e = anneal<NW, JS, kRandom>(in, jr, s0_row, a.sweeps, rep, scratch, bits);
  if (!kFused) {
    write_row<NW>(a.s_out + row * n, bits, s0_row, n, n_real);
    if (lane == 0) a.e_out[row] = best_e;
    return;
  }
  // The first argmin over the replicas (those at index >= reads count as
  // +inf), scanned in replica order with a strict <: over the instance's
  // whole cluster, or over the block for pass 2 to scan.
  if (lane == 0) es[w] = (float)rep < a.params[b * 4 + 3] ? best_e : INFINITY;
  __syncthreads();
  if (a.clustered) {
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's energies are in place
    int first = 0;
    float lo = INFINITY;
    for (int c = 0; c < (int)gridDim.x; ++c) {
      const float* there = cluster.map_shared_rank(es, c);
      for (int q = 0; q < kRows; ++q) {
        const float v = there[q];
        if ((c | q) == 0 || v < lo) {  // strict: the earliest replica wins ties
          lo = v;
          first = c * kRows + q;
        }
      }
    }
    cluster.sync();  // no block leaves while another reads its energies
    if ((int)rep == first) {
      write_row<NW>(a.s_out + (size_t)b * n, bits, s0_row, n, n_real);
      if (lane == 0) a.e_out[b] = lo;
    }
    return;
  }
  int first = 0;
  float lo = es[0];
  for (int q = 1; q < kRows; ++q) {
    if (es[q] < lo) {  // strict: the earliest replica wins ties
      lo = es[q];
      first = q;
    }
  }
  if (w != first) return;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  write_row<NW>(a.blk_rows + blk * n, bits, s0_row, n, n_real);
  if (lane == 0) a.blk_e[blk] = lo;
}

// Whether J's live rows at word count nw fit the launch's shared memory.
__device__ __forceinline__ bool j_fits(int nw, int n_real, size_t smem) {
  return (base_floats(32 * nw) + (size_t)n_real * 32 * nw) * sizeof(float) <= smem;
}

template <int NW, bool JS, bool kFused>
__device__ __forceinline__ void dispatch(const Args& a, float* smem, int n_real) {
  if (a.mode == 1) run<NW, JS, true, kFused>(a, smem, n_real);
  else run<NW, JS, false, kFused>(a, smem, n_real);
}

template <bool kFused>
__global__ void __launch_bounds__(32 * kRows) anneal_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_real = min(max((int)a.params[blockIdx.y * 4 + 2], 0), a.n);
  // up to 4 words J always fits (<= 128 x 128); from 16 words it never does
  switch (words_for(n_real)) {
    case 1: dispatch<1, true, kFused>(a, smem, n_real); break;
    case 2: dispatch<2, true, kFused>(a, smem, n_real); break;
    case 4: dispatch<4, true, kFused>(a, smem, n_real); break;
    case 8:
      if (j_fits(8, n_real, a.smem)) dispatch<8, true, kFused>(a, smem, n_real);
      else dispatch<8, false, kFused>(a, smem, n_real);
      break;
    case 16: dispatch<16, false, kFused>(a, smem, n_real); break;
    default: dispatch<32, false, kFused>(a, smem, n_real); break;
  }
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

template <bool kFused>
int launch(Args a, int b, void* stream) {
  a.smem = smem_bytes(a.n);
  a.clustered = kFused && a.r / kRows <= kMaxCluster;
  cudaError_t err = cudaFuncSetAttribute(anneal_kernel<kFused>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.r / kRows, b);
  cfg.blockDim = dim3(32 * kRows);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.r / kRows;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.clustered ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, anneal_kernel<kFused>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// All float arrays float32 and contiguous: J (B, N, N) and h (B, N), zero
// outside each instance's live n_real x n_real block; s0 (B, R, N) +-1,
// params (B, 4) [t_hi, t_lo, n_real, reads], temps (B, sweeps); seeds
// (B, 4) int64 words [init, pick, accept, spare], each < 2^32.  N % 32 == 0,
// 32 <= N <= 1024, N % chunk == 0, R % replica_block == 0, replica_block %
// 8 == 0; mode 0 = in-order sweep, 1 = random proposals.  chunk and
// replica_block are checked and change nothing: a block is 8 replicas, and
// a sweep's proposals run in order.  Each entry returns the CUDA error of
// its launches (0 on success).

// Replicas a block holds: the fused entry's scratch has R / this entries.
extern "C" int mcmc_block_rows() { return kRows; }

// e_out (B, R), s_out (B, R, N): each replica's best-visited state.
extern "C" int mcmc_sweep(const void* j, const void* h, const void* s0, const void* seeds,
                          const void* params, const void* temps, void* e_out, void* s_out,
                          int b, int r, int n, int sweeps, int chunk, int mode,
                          int replica_block, void* stream) {
  if (bad_args(b, r, n, sweeps, chunk, mode, replica_block)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)j, (const float*)h, (const float*)s0, (const long long*)seeds,
               (const float*)params, (const float*)temps, (float*)e_out, (float*)s_out,
               nullptr, nullptr, r, n, sweeps, mode, 0, false};
  return launch<false>(a, b, stream);
}

// Scratch blk_e (B, R / mcmc_block_rows()) and blk_rows (B, R /
// mcmc_block_rows(), N) are the caller's, used only where R holds more than
// one block; outputs e_out (B,), s_out (B, N).
extern "C" int mcmc_fused_best(const void* j, const void* h, const void* s0,
                               const void* seeds, const void* params, const void* temps,
                               void* blk_e, void* blk_rows, void* e_out, void* s_out,
                               int b, int r, int n, int sweeps, int chunk, int mode,
                               int replica_block, void* stream) {
  if (bad_args(b, r, n, sweeps, chunk, mode, replica_block)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)j, (const float*)h, (const float*)s0, (const long long*)seeds,
               (const float*)params, (const float*)temps, (float*)e_out, (float*)s_out,
               (float*)blk_e, (float*)blk_rows, r, n, sweeps, mode, 0, false};
  int err = launch<true>(a, b, stream);
  const int nblk = r / kRows;
  if (err != 0 || nblk <= kMaxCluster) return err;  // one cluster an instance: done
  fused_reduce_kernel<<<b, n, 0, (cudaStream_t)stream>>>(
      (const float*)blk_e, (const float*)blk_rows, (float*)e_out, (float*)s_out, nblk, n);
  return (int)cudaGetLastError();
}
