// The sLSTM recurrence of xlstm's slstm_apply as one scan on Hopper (sm_90a):
// a forward kernel and its reverse-scan (backward) kernel, each one
// cooperative launch a call.
//
// Replaces: no pallas_call.  src/repro/models/xlstm.py:158-172, the
// jax.lax.scan of slstm_apply's step (and, for the backward, what jax.grad
// makes of it), which the port ran as a Python loop over the sequence: ~20
// torch ops a position, ~250k launches in xlstm-1.3b's pass at B 2 x S 2048,
// and ~80k ops a layer for the dry run to walk on fake tensors.
//
// What it computes, in float32, for the whole sequence (the reference's
// layout, not the xLSTM paper's): rec = per-head h_{t-1} @ r reshaped to
// (B, NH 4dh) and split into four gates of D, so gate g of unit j reads flat
// column q = g D + j, which belongs to head q / 4dh, column q % 4dh; at NH 4
// gate g of every unit reads head g's slice of h.  The recurrence is dense
// across heads.  pre = (wx_t + rec) + bias; z = tanh, log_f = logsigmoid(f),
// m' = max(log_f + m, i), i_g = exp(i - m'), f_g = exp(log_f + m - m'),
// c' = f_g c + i_g z, n' = f_g n + i_g, h' = sigmoid(o) c' / max(n', 1e-6).
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain.  At xlstm-1.3b's call (B 2, S 2048, D 2048, NH 4) the products are
// 34.4 GFLOP (0.51 ms at 67 TFLOP/s) and the bytes 184 MB (0.055 ms), but
// each of the 2,048 steps needs every unit's h of the step before: a step
// is an exchange of h (B x D) between all blocks through L2, 2 B D 4dh / 132
// FMAs an SM, and the gates.
//
// Design: a persistent cooperative grid (cudaLaunchCooperativeKernel, for
// its co-residency guarantee; the entry checks with the occupancy API that
// every block fits and fails rather than split the grid) of 256-thread
// blocks.  Block x owns U = ceil(D / SMs) units j, all four gates of each.
// Its slice of r (128 KB at xlstm-1.3b: 16 units) lives in registers for
// the whole scan: a warp holds kLines lines of r (the forward's columns, the
// backward's rows) over a segment of their length, each lane kSeg words at
// k = lane + 32 m, so its operand (h, or d pre) is read from shared memory
// once a lane, without bank conflicts, and reused across the warp's 8 lines
// from registers (128 words of r a thread, up to 255 registers; r is never
// read from shared memory).  A warp's kRows x kLines sums are reduced
// across lanes by halving (16 shuffles), and a line's segments (the
// backward's 4) summed in order.
//
// No grid barrier in the step loop.  Each block publishes its step's values
// (the forward's h_t, the backward's d pre_t) as 64-bit words (tag << 32 |
// float bits), each written with one 8-byte store, into a two-slot
// exchange buffer in device memory; a reader polls the words it needs with
// relaxed loads until each tag reads the step's: the barrier and the
// exchange are one trip through L2.  A block polls only after it has
// published its own values (a block barrier after the gates): the polls of
// warps idle during the gates would only load L2.  Two slots are enough: a
// block writes step t + 1's values only after it has read all of step t's,
// which every block wrote only after reading step t - 1's.  Each block
// first marks its own words invalid (tag 0) and one grid.sync() runs before
// the loop, so the buffer needs no memset.  A reader that polls 2^26 times
// for one word traps: a word that never comes would otherwise hold the card.
//
// The forward step: gather h_{t-1} (B x D) into shared memory, the products
// from registers, one warp's gates (U x B pairs; the bias in registers),
// h_t published.  wx_t is copied into shared memory with cp.async a step
// ahead by the next warp, off the gate warp's chain.  The backward is its
// mirror: the cell's gradient for its own pairs (pre, c, n, m and d hs
// copied a step ahead the same way), its d pre_t (B x 4U) published, the d
// pre columns of the heads its units read gathered (at NH 4, one gate of
// every unit: B x 4dh words), and its own units' d h_{t-1} from the rows of
// r that belong to them, in registers: no partials across blocks and no
// fold, so the result is deterministic from run to run.
//
// The arithmetic follows slstm_scan_plain / slstm_scan_backward_plain
// (kernels/slstm_scan.py) term for term; only the order of the products'
// sums (and FMA contraction) differs.
//
// Timed instances (template kTimed) stamp the SM clock at each phase
// boundary of every step in thread 0 of every block (32-bit cycle counts:
// a phase is far shorter than 2^32 cycles) and take an arrival ticket once
// a block has published; slstm_forward_split / slstm_backward_split launch
// them (chip_smoke.py, phase 4k).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// 256 threads a block: a thread holds kLines x kSeg = 128 words of r, and
// __launch_bounds__(256, 1) leaves up to 255 registers for them and the
// rest.  At 512 threads (tools/slstm_trace.py's t512 build), 64 words of r
// leave 64 registers for the rest, and ptxas spills.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLines = 8;  // lines of r a warp holds
constexpr int kSeg = 16;   // words of a line a lane holds (k = lane + 32 m)
constexpr int kRows = 2;   // rows of the operand a product pass takes
constexpr int kPoll = 8;   // a gather's loads in flight a row a thread
constexpr int kMaxPolls = 1 << 26;
constexpr float kNormFloor = 1e-6f;

typedef unsigned long long u64;

// How a block's lines of r spread over its warps: line groups of kLines
// lines, each line cut in `segs` segments of `seg` words (a multiple of 32).
struct Tiling {
  int lines, len;    // lines and their length
  int groups, segs;  // line groups, segments a line: groups x segs warps
  int seg, kl;       // words a segment, words a lane (seg / 32)
};

__host__ __device__ inline Tiling tiling(int lines, int len) {
  Tiling t;
  t.lines = lines;
  t.len = len;
  t.groups = (lines + kLines - 1) / kLines;
  t.segs = t.groups > kWarps ? 1 : kWarps / t.groups;
  const int per = (len + t.segs - 1) / t.segs;
  t.seg = (per + 31) / 32 * 32;
  t.kl = t.seg / 32;
  return t;
}

struct Plan {
  int units;    // U: units a block owns (all four gates of each)
  int grid;     // blocks, every one co-resident
  Tiling tile;  // r's lines over the warps
  int heads;    // the most heads a block's d pre gather spans (backward)
  bool exact;   // every warp takes the unguarded products (exact_tiling)
  int smem;     // dynamic shared memory bytes a block
  int per_sm;   // blocks an SM holds
  int sms;
  long long xch_words;  // the exchange buffer: 2 slots x B x (D or 4D) words
};

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as torch's CPU kernel.
__device__ __forceinline__ float log_sigmoid_(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// ---------------------------------------------------------------------------
// The timed instances' clocks and buffer
// ---------------------------------------------------------------------------

// clock_after(v) reads the SM's cycle counter once v is computed (an operand
// of the read), so a phase that ends in a computed value is not stamped
// before it ends.
__device__ __forceinline__ unsigned clock_after(float v) {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c) : "f"(v) : "memory");
  return c;
}

__device__ __forceinline__ unsigned clock_now() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c)::"memory");
  return c;
}

__device__ __forceinline__ long long clock_long() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
  return c;
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

// A timed launch's buffer (u64 words, zeroed by the caller): [S] arrival
// counters, [grid][S] each block's arrival ticket (0 first), [grid][S]
// [kPhases] each step's phase cycles (thread 0), [grid][4] clock and global
// ns at the loop's start and end (thread 0), to turn cycles into ns.
// Steps are indexed in the order the kernel runs them.
constexpr int kPhases = 8;

struct SplitOut {
  u64* base;
  int S, G;
  __device__ u64* counter(int t) const { return base + t; }
  __device__ u64* ticket(int t) const { return base + S + (size_t)blockIdx.x * S + t; }
  __device__ u64* phases(int t) const {
    return base + S + (size_t)G * S + ((size_t)blockIdx.x * S + t) * kPhases;
  }
  __device__ u64* clocks() const {
    return base + S + (size_t)G * S * (1 + kPhases) + (size_t)blockIdx.x * 4;
  }
  __device__ void start() const {
    clocks()[0] = clock_long();
    clocks()[1] = global_ns();
  }
  __device__ void stop() const {
    clocks()[2] = clock_long();
    clocks()[3] = global_ns();
  }
};

// ---------------------------------------------------------------------------
// The exchange
// ---------------------------------------------------------------------------

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_u32(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void publish(u64* p, float v, unsigned tag) {
  st_relaxed(p, (u64)tag << 32 | __float_as_uint(v));
}

// Words [lo, hi) of rows b0 .. b0 + bt - 1 (bt <= kRows) of a slot of rows
// of W words, into dst (bt x (hi - lo) floats), once each word's tag reads
// `tag`.  Every thread of the block takes part, kRows x kPoll loads in
// flight each; a round polls again only the words not yet there.
__device__ __forceinline__ void gather(const u64* slot, int W, int b0, int bt, int lo, int hi,
                                       unsigned tag, float* dst) {
  static_assert(kRows == 2, "a gather takes two rows");
  constexpr int n = kThreads;
  const int wl = hi - lo;
  for (int c0 = threadIdx.x; c0 < wl; c0 += n * kPoll) {
    const u64* src[kRows] = {slot + (size_t)b0 * W + lo + c0, slot + (size_t)(b0 + 1) * W + lo + c0};
    float* out[kRows] = {dst + c0, dst + wl + c0};
    unsigned pending = 0;
#pragma unroll
    for (int bb = 0; bb < kRows; ++bb)
#pragma unroll
      for (int q = 0; q < kPoll; ++q)
        if (bb < bt && c0 + q * n < wl) pending |= 1u << (bb * kPoll + q);
    for (int polls = 0; pending; ++polls) {
      if (polls == kMaxPolls) __trap();
      u64 v[kRows][kPoll];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb)
#pragma unroll
        for (int q = 0; q < kPoll; ++q)
          if (pending >> (bb * kPoll + q) & 1) v[bb][q] = ld_relaxed(src[bb] + q * n);
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb)
#pragma unroll
        for (int q = 0; q < kPoll; ++q)
          if ((pending >> (bb * kPoll + q) & 1) && (unsigned)(v[bb][q] >> 32) == tag) {
            out[bb][q * n] = __uint_as_float((unsigned)v[bb][q]);
            pending &= ~(1u << (bb * kPoll + q));
          }
    }
  }
}

// ---------------------------------------------------------------------------
// The products: r's lines in registers against an operand in shared memory
// ---------------------------------------------------------------------------

// A warp's share: its line group, its segment, and whether its lines all
// sit at one offset `off` into an operand row (line_off: each line's, -1
// for none, in shared memory).
struct WarpLines {
  bool active, one_offset;
  int group, seg, off;
  const int* line_off;
};

__device__ __forceinline__ WarpLines warp_lines(const Tiling& t, const int* line_off) {
  WarpLines w;
  const int warp = threadIdx.x >> 5;
  w.active = warp < t.groups * t.segs;
  w.group = warp % t.groups;
  w.seg = warp / t.groups;
  w.line_off = line_off;
  w.off = w.active && w.group * kLines < t.lines ? line_off[w.group * kLines] : -1;
  w.one_offset = w.active && w.off >= 0;
#pragma unroll
  for (int ci = 1; ci < kLines; ++ci) {
    const int line = w.group * kLines + ci;
    w.one_offset = w.one_offset && line < t.lines && line_off[line] == w.off;
  }
  return w;
}

// A line's offset into an operand row, or -1.
__device__ __forceinline__ int line_offset(const WarpLines& w, const Tiling& t, int ci) {
  const int line = w.group * kLines + ci;
  return w.active && line < t.lines ? w.line_off[line] : -1;
}

// Sums of the kSums = kRows x kLines values of every lane over the warp, by
// halving: each step keeps half of the values and adds the other lane's
// copy of them; lane l ends with the sum of value l / kSpread = row * kLines
// + line (kSums - 1 + log2 kSpread shuffles, where a butterfly a value takes
// 5 kSums).
constexpr int kSums = kRows * kLines;
constexpr int kSpread = 32 / kSums;  // lanes left holding one sum
static_assert(kSums <= 32 && (kSums & (kSums - 1)) == 0, "a power of two of sums, at most 32");

// One halving step: lanes with bit kHalf * kSpread set keep the upper kHalf
// values, the others the lower, each adding its partner's copy; then the
// next step (a template, so every index is a constant and x stays in
// registers).
template <int kHalf>
__device__ __forceinline__ void halve(float (&x)[kSums], int lane) {
  if constexpr (kHalf >= 1) {
    const bool up = lane & (kHalf * kSpread);
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      x[i] = (up ? x[i + kHalf] : x[i]) +
             __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + kHalf], kHalf * kSpread);
    halve<kHalf / 2>(x, lane);
  }
}

__device__ __forceinline__ float warp_reduce(float (&v)[kRows][kLines]) {
  const int lane = threadIdx.x & 31;
  float x[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) x[i] = v[i / kLines][i % kLines];
  halve<kSums / 2>(x, lane);
#pragma unroll
  for (int off = kSpread / 2; off >= 1; off /= 2) x[0] += __shfl_xor_sync(0xffffffffu, x[0], off);
  return x[0];
}

// The warp's partial sums of rows b0 .. b0 + bt - 1 over its segment into
// part[(seg * B + b) * lines + line].  op: bt rows of `ow` floats.  kFull:
// every line has the same offset, the segments tile the line exactly and
// bt = kRows, so nothing is guarded.  kTimed: marks the clock after the
// products and after the reduction.
template <bool kFull, bool kTimed>
__device__ __forceinline__ void warp_products(const float (&R)[kLines][kSeg], const WarpLines& w,
                                              const Tiling& t, const float* op, int ow, int bt,
                                              int b0, int B, float* part, unsigned (&marks)[2]) {
  const int lane = threadIdx.x & 31;
  float acc[kRows][kLines];
#pragma unroll
  for (int bb = 0; bb < kRows; ++bb)
#pragma unroll
    for (int ci = 0; ci < kLines; ++ci) acc[bb][ci] = 0.f;
  const int k0 = w.seg * t.seg + lane;
  if (kFull) {
    const float* o = op + w.off + k0;
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      const float x0 = o[32 * m], x1 = o[ow + 32 * m];
#pragma unroll
      for (int ci = 0; ci < kLines; ++ci) {
        acc[0][ci] = fmaf(R[ci][m], x0, acc[0][ci]);
        acc[1][ci] = fmaf(R[ci][m], x1, acc[1][ci]);
      }
    }
  } else {
#pragma unroll
    for (int ci = 0; ci < kLines; ++ci) {
      const int off = line_offset(w, t, ci);
      if (off < 0) continue;
#pragma unroll
      for (int m = 0; m < kSeg; ++m) {
        const int k = k0 + 32 * m;
        if (m < t.kl && k < t.len) {
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb)
            if (bb < bt) acc[bb][ci] = fmaf(R[ci][m], op[bb * ow + off + k], acc[bb][ci]);
        }
      }
    }
  }
  if (kTimed) marks[0] = clock_after(acc[0][0] + acc[kRows - 1][kLines - 1]);
  const float s = warp_reduce(acc);
  const int v = lane / kSpread, bb = v / kLines, line = w.group * kLines + v % kLines;
  if (lane % kSpread == 0 && bb < bt && line < t.lines)
    part[((size_t)w.seg * B + b0 + bb) * t.lines + line] = s;
  if (kTimed) marks[1] = clock_after(s);
}

// kExact: the launch's tiling is exact (exact_tiling), so only the
// unguarded products are compiled: the smaller loop body runs a step
// faster than one that carries the guarded version beside it
// (tools/slstm_trace.py's guarded build).
template <bool kTimed, bool kExact>
__device__ __forceinline__ void products(const float (&R)[kLines][kSeg], const WarpLines& w,
                                         const Tiling& t, const float* op, int ow, int bt, int b0,
                                         int B, float* part, unsigned (&marks)[2]) {
  if (!w.active) return;
  if (kExact || (w.one_offset && bt == kRows && t.kl == kSeg && t.segs * t.seg == t.len))
    warp_products<true, kTimed>(R, w, t, op, ow, bt, b0, B, part, marks);
  else if constexpr (!kExact)
    warp_products<false, kTimed>(R, w, t, op, ow, bt, b0, B, part, marks);
}

// Whether every warp of every block takes the unguarded products at
// (B, D, dh): rows in pairs, segments of exactly kSeg words a lane that
// tile a line, no padded unit (U divides D), and each warp's kLines lines
// at one offset: kLines consecutive units (U a multiple of kLines) of one
// gate, which lie in one head when the forward's 4dh or the backward's dh
// is a multiple of kLines.  The kernels check it once (a trap if not).
__host__ inline bool exact_tiling(int B, int D, int dh, int U, const Tiling& t, bool backward) {
  return B % kRows == 0 && t.kl == kSeg && t.segs * t.seg == t.len && U % kLines == 0 &&
         D % U == 0 && (backward ? dh : 4 * dh) % kLines == 0;
}

// A line's sum over its segments, in order.
__device__ __forceinline__ float line_sum(const float* part, const Tiling& t, int B, int b,
                                          int line) {
  float s = part[(size_t)b * t.lines + line];
  for (int sg = 1; sg < t.segs; ++sg) s += part[((size_t)sg * B + b) * t.lines + line];
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* wx;    // (B, S, 4D)
  const float* r;     // (NH, dh, 4dh)
  const float* bias;  // (4D,)
  const float* c0;    // (B, D) each
  const float* n0;
  const float* h0;
  const float* m0;
  float* hs;   // (B, S, D)
  float* c;    // (B, D) each: the final state
  float* n;
  float* h;
  float* m;
  float* pre;  // (B, S, 4D) pre-activations, or null
  float* cnm;  // (3, B, S, D) c, n, m after each step, or null
  u64* xch;    // (2, B, D) exchange words
  u64* split;  // the timed instance's buffer
  int B, S, D, NH, U;
  Tiling tile;  // lines: the 4U columns, c = g U + u
};

__host__ __device__ inline int forward_words(int B, int U, const Tiling& t, int D) {
  // rows of h, partial sums, wx of two steps, c, n, m, h, columns' offsets
  return kRows * D + t.segs * B * 4 * U + 2 * 4 * B * U + 4 * B * U + 4 * U;
}

template <bool kTimed, bool kExact>
__global__ void __launch_bounds__(kThreads, 1) slstm_forward_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, S = a.S, D = a.D, U = a.U, BU = B * U, C = 4 * U;
  const int dh = D / a.NH, e4 = 4 * dh, j0 = blockIdx.x * U, tid = threadIdx.x;
  const Tiling tc = a.tile;
  float* h_s = smem;                       // kRows x D: rows of h_{t-1}
  float* part_s = h_s + kRows * D;         // segs x B x C
  float* wx_s = part_s + tc.segs * B * C;  // 2 x 4 x (B x U): a step's wx, gate-major
  float* st_s = wx_s + 2 * 4 * BU;         // c, n, m, h: 4 x (B x U)
  int* off_s = reinterpret_cast<int*>(st_s + 4 * BU);  // C: a column's head offset in h
  const SplitOut so{a.split, S, (int)gridDim.x};

  for (int p = tid; p < 2 * BU; p += kThreads) {  // own words of both slots invalid
    const int b = p / U % B, j = j0 + p % U;
    if (j < D) a.xch[((size_t)(p / BU) * B + b) * D + j] = 0ull;
  }
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      st_s[p] = a.c0[o];
      st_s[BU + p] = a.n0[o];
      st_s[2 * BU + p] = a.m0[o];
      st_s[3 * BU + p] = a.h0[o];
    }
  }
  for (int c = tid; c < C; c += kThreads) {
    const int j = j0 + c % U;
    off_s[c] = j < D ? (c / U * D + j) / e4 * dh : -1;
  }
  __syncthreads();

  // r's columns into registers: column c = g U + u is r[hd, :, e] for flat
  // column q = g D + j0 + u (hd = q / 4dh, e = q % 4dh).
  const WarpLines wl = warp_lines(tc, off_s);
  if (kExact && wl.active && !wl.one_offset) __trap();  // the host's exact_tiling was wrong
  float R[kLines][kSeg];
#pragma unroll
  for (int ci = 0; ci < kLines; ++ci) {
    const int c = wl.group * kLines + ci, q = c / U * D + j0 + c % U;
    const bool live = line_offset(wl, tc, ci) >= 0;
    const float* col = a.r + (size_t)(q / e4) * dh * e4 + q % e4;
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      const int k = wl.seg * tc.seg + (tid & 31) + 32 * m;
      R[ci][m] = live && m < tc.kl && k < dh ? col[(size_t)k * e4] : 0.f;
    }
  }
  // The gate threads: unit u = tid % U, rows tid / U, + kThreads / U, ...
  const int rows_at_once = kThreads / U, gu = tid % U, gj = j0 + gu;
  const bool gate = tid < rows_at_once * U && tid / U < B && gj < D;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = gate ? a.bias[g * D + gj] : 0.f;
  // wx_t into wx_s[t & 1] a step ahead (cp.async; pair p by thread
  // (p + 32) mod kThreads, so the copies stay off the gate warp's chain),
  // waited for before the barrier that precedes step t's gates.
  const int fp = (tid + kThreads - 32) % kThreads;
  auto fetch_wx = [&](int t) {
    for (int p = fp; p < BU; p += kThreads) {
      const int b = p / U, j = j0 + p % U;
      if (j < D) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async4(wx_s + ((t & 1) * 4 + q) * BU + p, a.wx + ((size_t)b * S + t) * 4 * D + q * D + j);
      }
    }
    cp_async_commit();
  };
  fetch_wx(0);
  grid.sync();  // every block's words invalid
  if (kTimed && tid == 0) so.start();

  const size_t bsd = (size_t)B * S * D;
  unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0, marks[2] = {0, 0};
  u64 ticket = 0;
  for (int t = 0; t < S; ++t) {
    if (kTimed) s0 = clock_now();
    if (t + 1 < S) fetch_wx(t + 1);  // its buffer's last reader, step t - 1's gates, is done
    else cp_async_commit();
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int bt = min(kRows, B - b0);
      if (t == 0) {
        for (int i = tid; i < bt * D; i += kThreads) h_s[i] = a.h0[(size_t)b0 * D + i];
      } else {
        gather(a.xch + (size_t)((t - 1) & 1) * B * D, D, b0, bt, 0, D, t, h_s);
      }
      __syncthreads();
      if (kTimed && b0 == 0) {
        s1 = clock_now();
        if (tid == 0 && t > 0) *so.ticket(t - 1) = ticket;
      }
      products<kTimed, kExact>(R, wl, tc, h_s, D, bt, b0, B, part_s, marks);
      cp_async_wait<1>();  // wx_t
      __syncthreads();
    }
    if (kTimed) s2 = clock_now();
    // The gates of own pairs; h_t published.
    if (gate) {
      const float* w = wx_s + (t & 1) * 4 * BU;
      u64* slot = a.xch + (size_t)(t & 1) * B * D;
      for (int b = tid / U; b < B; b += rows_at_once) {
        const int s = b * U + gu;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g[q] = (w[q * BU + s] + line_sum(part_s, tc, B, b, q * U + gu)) + bias[q];
        const float c = st_s[s], n = st_s[BU + s], m = st_s[2 * BU + s];
        const float z = tanhf(g[0]);
        const float lf = log_sigmoid_(g[2]) + m;
        const float mn = fmaxf(lf, g[1]);
        const float ig = expf(g[1] - mn), fg = expf(lf - mn);
        const float c1 = fg * c + ig * z;
        const float n1 = fg * n + ig;
        const float h1 = sigmoid_(g[3]) * c1 / fmaxf(n1, kNormFloor);
        if (kTimed && tid == 0) s3 = clock_after(h1);
        publish(slot + (size_t)b * D + gj, h1, t + 1);
        const size_t row = (size_t)b * S + t;
        a.hs[row * D + gj] = h1;
        if (a.pre != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a.pre[row * 4 * D + q * D + gj] = g[q];
        }
        if (a.cnm != nullptr) {
          a.cnm[row * D + gj] = c1;
          a.cnm[bsd + row * D + gj] = n1;
          a.cnm[2 * bsd + row * D + gj] = mn;
        }
        st_s[s] = c1;
        st_s[BU + s] = n1;
        st_s[2 * BU + s] = mn;
        st_s[3 * BU + s] = h1;
      }
    }
    // No thread polls for h_t before this block has published its own (the
    // polls of the warps idle during the gates would only load L2), and
    // the next step's fetch_wx may overwrite the wx the gates just read.
    __syncthreads();
    if (kTimed && tid == 0) {
      // exchange wait, products, reduction, barrier, gates, publish
      const unsigned s4 = clock_now();
      ticket = atomicAdd(so.counter(t), 1ull);
      u64* ph = so.phases(t);
      ph[0] = s1 - s0;
      ph[1] = marks[0] - s1;
      ph[2] = marks[1] - marks[0];
      ph[3] = s2 - marks[1];
      ph[4] = s3 - s2;
      ph[5] = s4 - s3;
    }
  }
  if (kTimed && tid == 0) {
    *so.ticket(S - 1) = ticket;
    so.stop();
  }
  __syncthreads();
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      a.c[o] = st_s[p];
      a.n[o] = st_s[BU + p];
      a.m[o] = st_s[2 * BU + p];
      a.h[o] = st_s[3 * BU + p];
    }
  }
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* d_hs;  // (B, S, D)
  const float* d_c;   // (B, D) each: gradients of the final state
  const float* d_n;
  const float* d_h;
  const float* d_m;
  const float* r;     // (NH, dh, 4dh)
  const float* pre;   // (B, S, 4D), saved by the forward
  const float* cnm;   // (3, B, S, D), saved by the forward
  const float* c0;    // (B, D) each: the starting state
  const float* n0;
  const float* m0;
  float* d_pre;       // (B, S, 4D)
  float* d_c0;        // (B, D) each
  float* d_n0;
  float* d_h0;
  float* d_m0;
  u64* xch;           // (2, B, 4D) exchange words
  u64* split;         // the timed instance's buffer
  int B, S, D, NH, U;
  Tiling tile;        // lines: the U units' rows of r, over 4dh
};

// A step's inputs of a pair, copied a step ahead: pre (4), the c, n, m
// before the step, d hs.
constexpr int kCellIn = 8;

__host__ __device__ inline int backward_words(int B, int U, const Tiling& t, int heads,
                                              int dh) {
  // rows of d pre, partial sums, two steps' cell inputs, dc, dn, dm,
  // units' offsets
  return kRows * heads * 4 * dh + t.segs * B * U + 2 * kCellIn * B * U + 3 * B * U + U;
}

// The cell's gradient at one (row, unit): from the step's pre-activations g
// and the state before it (c, n, m), the gradient dh of h_t and the carried
// gradients (dc, dn, dm) of c_t, n_t, m_t, it writes d pre into dg and
// leaves the gradients of c_{t-1}, n_{t-1}, m_{t-1} in dc, dn, dm.  As
// autograd of the plain loop: clamp(n, min) passes the gradient where
// n >= min, and maximum splits it in half at a tie.
__device__ __forceinline__ void cell_backward(const float* g, float c, float n, float m,
                                              float dh, float& dc, float& dn, float& dm,
                                              float* dg) {
  const float z = tanhf(g[0]);
  const float lf = log_sigmoid_(g[2]) + m;
  const float mn = fmaxf(lf, g[1]);
  const float ig = expf(g[1] - mn), fg = expf(lf - mn);
  const float c1 = fg * c + ig * z;
  const float n1 = fg * n + ig;
  const float o = sigmoid_(g[3]);
  const float nc = fmaxf(n1, kNormFloor);
  const float q = dh / nc;  // gradient of o c1
  dg[3] = q * c1 * (o * (1.f - o));
  const float dc1 = dc + q * o;
  const float dn1 = n1 >= kNormFloor ? dn - q * o * c1 / nc : dn;
  const float dfg = dc1 * c + dn1 * n;
  const float dig = dc1 * z + dn1;
  dg[0] = dc1 * ig * (1.f - z * z);
  const float dmn = dm - dig * ig - dfg * fg;
  const float share = lf > g[1] ? 1.f : (lf == g[1] ? 0.5f : 0.f);
  const float da = dfg * fg + dmn * share;
  dg[1] = dig * ig + dmn * (1.f - share);
  dg[2] = da * sigmoid_(-g[2]);
  dm = da;
  dc = dc1 * fg;
  dn = dn1 * fg;
}

template <bool kTimed, bool kExact>
__global__ void __launch_bounds__(kThreads, 1) slstm_backward_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, S = a.S, D = a.D, U = a.U, BU = B * U;
  const int dh = D / a.NH, e4 = 4 * dh, j0 = blockIdx.x * U, tid = threadIdx.x;
  const int W = 4 * D;  // an exchange row: d pre of every column
  // The d pre gathered: the columns of heads hd_lo .. of own units, ow a row.
  const int hd_lo = j0 / dh, ow = ((min(j0 + U, D) - 1) / dh - hd_lo + 1) * e4;
  const Tiling tu = a.tile;
  float* dp_s = smem;                      // kRows x ow
  float* part_s = dp_s + kRows * ow;       // segs x B x U
  float* in_s = part_s + tu.segs * B * U;  // 2 x kCellIn x (B x U): a step's cell inputs
  float* g_s = in_s + 2 * kCellIn * BU;    // dc, dn, dm carried: 3 x (B x U)
  int* off_s = reinterpret_cast<int*>(g_s + 3 * BU);  // U: a unit's offset in a d pre row
  const SplitOut so{a.split, S, (int)gridDim.x};
  const size_t bsd = (size_t)B * S * D;

  for (int p = tid; p < 2 * 4 * BU; p += kThreads) {  // own words of both slots invalid
    const int sl = p / (4 * BU), g = p / BU % 4, b = p / U % B, j = j0 + p % U;
    if (j < D) a.xch[((size_t)sl * B + b) * W + g * D + j] = 0ull;
  }
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      g_s[p] = a.d_c[o];
      g_s[BU + p] = a.d_n[o];
      g_s[2 * BU + p] = a.d_m[o];
    }
  }
  for (int u = tid; u < U; u += kThreads)
    off_s[u] = j0 + u < D ? ((j0 + u) / dh - hd_lo) * e4 : -1;
  __syncthreads();

  // The rows of r that own units read back into registers: line u is
  // r[hd, k, :] for j = j0 + u (hd = j / dh, k = j % dh), over 4dh.
  const WarpLines wl = warp_lines(tu, off_s);
  if (kExact && wl.active && !wl.one_offset) __trap();  // the host's exact_tiling was wrong
  float R[kLines][kSeg];
#pragma unroll
  for (int ci = 0; ci < kLines; ++ci) {
    const int j = j0 + wl.group * kLines + ci;
    const bool live = line_offset(wl, tu, ci) >= 0;
    const float* row = a.r + ((size_t)(j / dh) * dh + j % dh) * e4;
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      const int e = wl.seg * tu.seg + (tid & 31) + 32 * m;
      R[ci][m] = live && m < tu.kl && e < e4 ? row[e] : 0.f;
    }
  }
  // The cell threads: unit u = tid % U, rows tid / U, + kThreads / U, ...
  const int rows_at_once = kThreads / U, gu = tid % U, gj = j0 + gu;
  const bool cell = tid < rows_at_once * U && tid / U < B && gj < D;
  // Step t's cell inputs into in_s[t & 1], [k][b][u], a step ahead
  // (cp.async; pair p by thread (p + 32) mod kThreads, off the cell warp's
  // chain; waited for before the barrier that precedes the step's cell
  // phase): pre (k 0-3), the state before the step (the forward's saved c,
  // n, m of step t - 1, or the starting state; k 4-6) and d hs (k 7).
  const int fp = (tid + kThreads - 32) % kThreads;
  auto fetch = [&](int t) {
    float* dst = in_s + (t & 1) * kCellIn * BU;
    for (int p = fp; p < BU; p += kThreads) {
      const int b = p / U, j = j0 + p % U;
      if (j >= D) continue;
      const size_t row = (size_t)b * S + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async4(dst + q * BU + p, a.pre + row * W + q * D + j);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        cp_async4(dst + (4 + q) * BU + p,
                  t == 0 ? (q == 0 ? a.c0 : q == 1 ? a.n0 : a.m0) + (size_t)b * D + j
                         : a.cnm + q * bsd + (row - 1) * D + j);
      cp_async4(dst + 7 * BU + p, a.d_hs + row * D + j);
    }
    cp_async_commit();
  };
  fetch(S - 1);
  cp_async_wait<0>();
  grid.sync();  // every block's words invalid, step S - 1's inputs in
  if (kTimed && tid == 0) so.start();

  unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0, marks[2] = {0, 0};
  for (int i = 0; i < S; ++i) {
    const int t = S - 1 - i;
    if (kTimed) s0 = clock_now();
    if (t > 0) fetch(t - 1);  // its buffer's last reader, step t + 1's cell phase, is done
    // (1) the cell's gradient for own pairs; d pre_t published
    if (cell) {
      const float* in = in_s + (t & 1) * kCellIn * BU;
      u64* slot = a.xch + (size_t)(i & 1) * B * W;
      for (int b = tid / U; b < B; b += rows_at_once) {
        const int p = b * U + gu;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = in[q * BU + p];
        float dc = g_s[p], dn = g_s[BU + p], dm = g_s[2 * BU + p];
        const float dh_rec = i == 0 ? a.d_h[(size_t)b * D + gj] : line_sum(part_s, tu, B, b, gu);
        float dg[4];
        cell_backward(g, in[4 * BU + p], in[5 * BU + p], in[6 * BU + p], in[7 * BU + p] + dh_rec,
                      dc, dn, dm, dg);
        if (kTimed && tid == 0) s1 = clock_after(dg[0] + dg[1] + dg[2] + dg[3]);
        const size_t row = (size_t)b * S + t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          publish(slot + (size_t)b * W + q * D + gj, dg[q], i + 1);
          a.d_pre[row * W + q * D + gj] = dg[q];
        }
        g_s[p] = dc;
        g_s[BU + p] = dn;
        g_s[2 * BU + p] = dm;
      }
    }
    __syncthreads();  // no polling before own d pre_t is published
    u64 ticket = 0;
    if (kTimed && tid == 0) {
      s2 = clock_now();
      ticket = atomicAdd(so.counter(i), 1ull);
    }
    // (2) the d pre columns of the heads own units read; (3) own units'
    // d h_{t-1}
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int bt = min(kRows, B - b0);
      gather(a.xch + (size_t)(i & 1) * B * W, W, b0, bt, hd_lo * e4, hd_lo * e4 + ow, i + 1,
             dp_s);
      __syncthreads();
      if (kTimed && b0 == 0) s3 = clock_now();
      products<kTimed, kExact>(R, wl, tu, dp_s, ow, bt, b0, B, part_s, marks);
      cp_async_wait<0>();  // step t - 1's inputs
      __syncthreads();
    }
    if (kTimed && tid == 0) {
      // cell gradient, publish, exchange wait, products, reduction, barrier
      u64* ph = so.phases(i);
      ph[0] = s1 - s0;
      ph[1] = s2 - s1;
      ph[2] = s3 - s2;
      ph[3] = marks[0] - s3;
      ph[4] = marks[1] - marks[0];
      ph[5] = clock_now() - marks[1];
      *so.ticket(i) = ticket;
    }
  }
  if (kTimed && tid == 0) so.stop();
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      a.d_c0[o] = g_s[p];
      a.d_n0[o] = g_s[BU + p];
      a.d_m0[o] = g_s[2 * BU + p];
      a.d_h0[o] = line_sum(part_s, tu, B, b, p % U);
    }
  }
}

// ---------------------------------------------------------------------------
// The exchange alone
// ---------------------------------------------------------------------------

struct XchArgs {
  void* xch;  // tagged: (2, B, D) words; flags: (2, B, D) floats, then (grid) flags
  int B, D, U, S;
};

// S rounds of the forward's exchange with no arithmetic: each block
// publishes its B x U values (read from the round before), then (after a
// block barrier, as the scans) gathers all B x D.  kTagged: the scans'
// tagged words.  Otherwise the flag scheme:
// float words and a fence, then one flag a producer block, which one warp
// of each reader polls before the block reads the floats (half the bytes,
// two dependent trips).  The tagged time a round is the scans' chain floor.
template <bool kTagged>
__global__ void __launch_bounds__(kThreads, 1) slstm_exchange_kernel(XchArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, D = a.D, U = a.U, j0 = blockIdx.x * U, tid = threadIdx.x;
  const int BU = B * U, G = gridDim.x;
  float* h_s = smem;  // kRows x D
  u64* words = static_cast<u64*>(a.xch);
  float* floats = static_cast<float*>(a.xch);
  unsigned* flags = reinterpret_cast<unsigned*>(floats + 2 * (size_t)B * D);
  for (int p = tid; p < 2 * BU; p += kThreads) {
    const int b = p / U % B, j = j0 + p % U;
    if (kTagged && j < D) words[((size_t)(p / BU) * B + b) * D + j] = 0ull;
  }
  if (!kTagged && tid == 0) flags[blockIdx.x] = 0u;
  for (int i = tid; i < kRows * D; i += kThreads) h_s[i] = 0.f;
  grid.sync();
  for (int t = 0; t < a.S; ++t) {
    const size_t slot = (size_t)(t & 1) * B * D;
    for (int p = tid; p < BU; p += kThreads) {
      const int b = p / U, j = j0 + p % U;
      if (j >= D) continue;
      const float v = h_s[(b % kRows) * D + j] + 1.f;
      if (kTagged) {
        publish(words + slot + (size_t)b * D + j, v, t + 1);
      } else {
        floats[slot + (size_t)b * D + j] = v;
        __threadfence();
      }
    }
    __syncthreads();
    if (!kTagged) {
      if (tid == 0) st_relaxed_u32(flags + blockIdx.x, t + 1);
      if (tid < 32) {
        for (int x = tid; x < G; x += 32)
          while (ld_relaxed_u32(flags + x) < (unsigned)(t + 1)) {
          }
        __syncwarp();
        __threadfence();
      }
      __syncthreads();
    }
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int bt = min(kRows, B - b0);
      if (kTagged) {
        gather(words + slot, D, b0, bt, 0, D, t + 1, h_s);
      } else {
        for (int bb = 0; bb < bt; ++bb)
          for (int i = tid; i < D; i += kThreads)
            h_s[bb * D + i] = __ldcg(floats + slot + (size_t)(b0 + bb) * D + i);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

template <bool kTimed, bool kExact>
const void* kernel_of(bool backward) {
  return backward ? reinterpret_cast<const void*>(slstm_backward_kernel<kTimed, kExact>)
                  : reinterpret_cast<const void*>(slstm_forward_kernel<kTimed, kExact>);
}

const void* kernel_of(bool backward, bool timed, bool exact) {
  return timed ? (exact ? kernel_of<true, true>(backward) : kernel_of<true, false>(backward))
               : (exact ? kernel_of<false, true>(backward) : kernel_of<false, false>(backward));
}

int make_plan(int B, int D, int NH, bool backward, Plan* p) {
  *p = Plan{};
  if (B < 1 || D < 1 || NH < 1 || D % NH != 0) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return cudaErrorNotSupported;
  const int dh = D / NH;
  p->units = (D + p->sms - 1) / p->sms;
  p->grid = (D + p->units - 1) / p->units;
  p->tile = backward ? tiling(p->units, 4 * dh) : tiling(4 * p->units, dh);
  p->heads = 1;
  for (int x = 0; x < p->grid; ++x) {
    const int j0 = x * p->units, j1 = (j0 + p->units < D ? j0 + p->units : D) - 1;
    if (j1 / dh - j0 / dh + 1 > p->heads) p->heads = j1 / dh - j0 / dh + 1;
  }
  p->xch_words = 2ll * B * D * (backward ? 4 : 1);
  const long long words = backward ? backward_words(B, p->units, p->tile, p->heads, dh)
                                   : forward_words(B, p->units, p->tile, D);
  p->smem = words * 4 > 0x7fffffff ? 0x7fffffff : static_cast<int>(words * 4);
  // r's slice must fit the registers: at most kWarps line groups, a lane
  // at most kSeg words of each of its kLines lines.
  if (p->tile.groups > kWarps || p->tile.kl > kSeg) return cudaErrorInvalidConfiguration;
  if (words * 4 > optin) return cudaErrorInvalidConfiguration;
  p->exact = exact_tiling(B, D, dh, p->units, p->tile, backward);
  for (int timed = 0; timed < 2; ++timed) {
    err = cudaFuncSetAttribute(kernel_of(backward, timed, p->exact),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &p->per_sm, kernel_of(backward, false, p->exact), kThreads, p->smem);
  if (err != cudaSuccess) return err;
  if (p->per_sm * p->sms < p->grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

int launch(const void* kernel, const Plan& p, void* arg, void* stream) {
  void* args[] = {arg};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(kThreads), args,
                                                p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int forward(const float* wx, const float* r, const float* bias, const float* c0,
            const float* n0, const float* h0, const float* m0, float* hs, float* c, float* n,
            float* h, float* m, float* pre, float* cnm, void* xch, long long xch_words, int B,
            int S, int D, int NH, void* split, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  Plan p;
  int err = make_plan(B, D, NH, false, &p);
  if (err != cudaSuccess) return err;
  if (xch_words < p.xch_words) return cudaErrorInvalidValue;  // the exchange is too small
  FwdArgs a{wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, static_cast<u64*>(xch),
            static_cast<u64*>(split), B, S, D, NH, p.units, p.tile};
  return launch(kernel_of(false, split != nullptr, p.exact), p, &a, stream);
}

int backward(const float* d_hs, const float* d_c, const float* d_n, const float* d_h,
             const float* d_m, const float* r, const float* pre, const float* cnm,
             const float* c0, const float* n0, const float* m0, float* d_pre, float* d_c0,
             float* d_n0, float* d_h0, float* d_m0, void* xch, long long xch_words, int B, int S,
             int D, int NH, void* split, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  Plan p;
  int err = make_plan(B, D, NH, true, &p);
  if (err != cudaSuccess) return err;
  if (xch_words < p.xch_words) return cudaErrorInvalidValue;  // the exchange is too small
  BwdArgs a{d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0, d_pre, d_c0, d_n0, d_h0, d_m0,
            static_cast<u64*>(xch), static_cast<u64*>(split), B, S, D, NH, p.units, p.tile};
  return launch(kernel_of(true, split != nullptr, p.exact), p, &a, stream);
}

}  // namespace

// The launch plan of the forward (backward = 0) or backward kernel at
// (B, D, NH) on the current device: out[0..11] = units a block, grid, lines
// of r a block, warps holding them, segments a line, registers of r a
// thread, heads a block's d pre gather spans, shared memory bytes, exchange
// buffer bytes, blocks an SM holds, SMs, and 1 when the tiling is exact
// (the instance without guarded products runs).  Returns
// cudaErrorInvalidConfiguration when r's slice is over the registers or a
// block's shared memory over the opt-in limit, and
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident;
// out is filled as far as it was reckoned.
extern "C" int slstm_scan_plan(int B, int D, int NH, int backward, int* out) {
  Plan p;
  const int err = make_plan(B, D, NH, backward != 0, &p);
  out[0] = p.units;
  out[1] = p.grid;
  out[2] = p.tile.lines;
  out[3] = p.tile.groups * p.tile.segs;
  out[4] = p.tile.segs;
  out[5] = kLines * p.tile.kl;
  out[6] = p.heads;
  out[7] = p.smem;
  out[8] = static_cast<int>(p.xch_words * 8 > 0x7fffffff ? 0x7fffffff : p.xch_words * 8);
  out[9] = p.per_sm;
  out[10] = p.sms;
  out[11] = p.exact;
  return err;
}

// xch: the exchange buffer, xch_words 8-byte words, at least 2 B D; its
// contents need no initialisation.
extern "C" int slstm_scan_forward(const float* wx, const float* r, const float* bias,
                                  const float* c0, const float* n0, const float* h0,
                                  const float* m0, float* hs, float* c, float* n, float* h,
                                  float* m, float* pre, float* cnm, void* xch, int xch_words,
                                  int B, int S, int D, int NH, void* stream) {
  return forward(wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, xch, xch_words, B, S, D,
                 NH, nullptr, stream);
}

// xch: the exchange buffer, xch_words 8-byte words, at least 2 B 4D.
extern "C" int slstm_scan_backward(const float* d_hs, const float* d_c, const float* d_n,
                                   const float* d_h, const float* d_m, const float* r,
                                   const float* pre, const float* cnm, const float* c0,
                                   const float* n0, const float* m0, float* d_pre, float* d_c0,
                                   float* d_n0, float* d_h0, float* d_m0, void* xch,
                                   int xch_words, int B, int S, int D, int NH, void* stream) {
  return backward(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0, d_pre, d_c0, d_n0, d_h0,
                  d_m0, xch, xch_words, B, S, D, NH, nullptr, stream);
}

// The timed instances: as slstm_scan_forward / slstm_scan_backward, and each
// step's phase cycles, arrival tickets and the clocks into `split` (u64
// words, zeroed by the caller: S + grid S (1 + 8) + 4 grid).  Forward
// phases: exchange wait, products, reduction, barrier, gates, publish;
// backward: cell gradient, publish, exchange wait, products, reduction,
// barrier.
extern "C" int slstm_forward_split(const float* wx, const float* r, const float* bias,
                                   const float* c0, const float* n0, const float* h0,
                                   const float* m0, float* hs, float* c, float* n, float* h,
                                   float* m, float* pre, float* cnm, void* xch, int xch_words,
                                   int B, int S, int D, int NH, void* split, void* stream) {
  return forward(wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, xch, xch_words, B, S, D,
                 NH, split, stream);
}

extern "C" int slstm_backward_split(const float* d_hs, const float* d_c, const float* d_n,
                                    const float* d_h, const float* d_m, const float* r,
                                    const float* pre, const float* cnm, const float* c0,
                                    const float* n0, const float* m0, float* d_pre, float* d_c0,
                                    float* d_n0, float* d_h0, float* d_m0, void* xch,
                                    int xch_words, int B, int S, int D, int NH, void* split,
                                    void* stream) {
  return backward(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0, d_pre, d_c0, d_n0, d_h0,
                  d_m0, xch, xch_words, B, S, D, NH, split, stream);
}

// S rounds of the exchange alone on the forward's grid at (B, D, NH):
// tagged = 1 the scans' tagged words, 0 the flag scheme.  xch: at least
// 16 B D + 4 grid bytes, no initialisation needed.
extern "C" int slstm_exchange_probe(int tagged, int B, int D, int NH, int S, void* xch,
                                    void* stream) {
  Plan p;
  int err = make_plan(B, D, NH, false, &p);
  if (err != cudaSuccess) return err;
  const void* kernel = tagged ? reinterpret_cast<const void*>(slstm_exchange_kernel<true>)
                              : reinterpret_cast<const void*>(slstm_exchange_kernel<false>);
  p.smem = kRows * D * 4;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  XchArgs a{xch, B, D, p.units, S};
  return launch(kernel, p, &a, stream);
}
