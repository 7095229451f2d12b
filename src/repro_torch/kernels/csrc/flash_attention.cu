// Blocked online-softmax attention (FlashAttention style) on Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/flash_attention.py:
//   flash_attention (:75, its pallas_call at :100) and its body _fa_kernel (:29)
//   -> flash_attention_wgmma (bf16, D 64 or 128) and flash_attention_tf32
//      (float32 at any D, bf16 at D 16 or 32)
//
// What both compute, as _fa_kernel does: q (B, Sq, H, D), k and v
// (B, Skv, KV, D), heads third.  Query head h reads kv head h / (H / KV),
// with no repeat in memory.  Scores are the float32 dot q.k times D^-0.5;
// query i sits at position i + Skv - Sq and key j at j; a score is masked
// to -1e30 unless k_pos <= q_pos (causal) and k_pos > q_pos - window
// (sliding window).  Running max m, sum l and the accumulator stay in
// float32; p = exp(s - m_new) is rounded to the inputs' type before the PV
// product (l sums the unrounded p); the output is acc / max(l, 1e-30)
// rounded to the inputs' type.  Kv tiles wholly above the causal diagonal,
// or wholly before the window, are skipped: in the reference they give
// p = 0 and alpha = 1 (or, before any real key, a contribution that the
// first real key multiplies by exp(-1e30 - m) = 0), so skipping them
// changes no value.  That holds when every query row has a real key, i.e.
// when Sq <= Skv; otherwise every tile is walked.  Keys past Skv (a ragged
// last tile) get -inf, and so weight 0.
//
// What bounds it on an H100: operations.  At the encoder stage's shapes
// (B = 8, S = 2048, H = 12, D = 64, bf16, causal) the work is 4 B H D
// S(S+1)/2 = 51.6 GFLOP against 101 MB of q, k, v and o: 0.052 ms at the
// bf16 tensor-core peak against 0.030 ms of bytes.  Only wgmma reaches the
// tensor cores' rate.
//
// flash_attention_wgmma (bf16, D 64 or 128; every full-width config):
// work tiles of (b, h, 128 queries), heaviest first, walked by a
// persistent grid of one CTA per SM (a snake over the rounds evens the
// causal load), each CTA three warpgroups.  Warpgroup 0 is the producer:
// one thread loads Q and K, V in 128-key tiles by TMA, through 4-D tensor
// maps over (D, H, S, B) that read the heads-third layout in place (box
// 64 x 1 x 128 x 1, 128-byte swizzle; D 128 takes two boxes a tile), into a
// ring of mbarrier-guarded full / empty stages (4 at D 64, 3 at D 128),
// running on into the next work tile while the consumers finish this one;
// setmaxnreg gives its registers to the two consumer warpgroups, each of
// which owns 64 query rows.  A consumer computes S = Q K^T with
// wgmma.m64n128k16 (bf16 from shared memory, K-major as stored, float32
// accumulators) and runs the online softmax on the accumulator fragments:
// each thread holds two rows, whose max needs a shuffle across the quad
// that shares them; p = exp2 of the score in log2 units, the scale (times
// log2 e) applied in float32 after the product.  Only kv tiles that the
// diagonal, the window edge or Skv crosses are masked, in a second
// instance of the softmax; there a score is scaled, masked, and p =
// exp2(y - m_new) (at -1e30 the rounding of an FMA's product alone would
// overflow exp2), while off the borders, where the max is a real score's,
// p = exp2(fma(s, scale log2 e, -m_new)).  l keeps each thread's share of
// the unrounded sum, reduced across the quad once at the end, and the
// epilogue scales a row by one reciprocal of max(l, 1e-30).  p is
// rounded to bf16 in registers, where the m64n128 accumulator layout is
// already wgmma's A-fragment layout, and O += P V is a register-A wgmma
// with V as an MN-major B operand (the transpose bit) from shared memory.
// Kv tile j's S product is issued together with tile j - 1's P V, so the
// softmax of S_j runs while P V does, and the two consumers run out of
// step, one's softmax beside the other's products.  The 128-key tiles are
// the plain version's block_k blocks, so p is rounded against the same
// running max in both.  What still holds it above its bound at D 64: the
// exp unit (16 a clock per SM) needs as long for a tile's 64 x 128 exps as
// the tensor cores need for its two products, and the softmax's other
// float32 work comes on top.

// flash_attention_tf32 (float32 at any D, bf16 at D 16 or 32): the products
// on the tensor cores, by warp-level mma.sync.m16n8k8 on TF32 operands.
// TF32 keeps 10 mantissa bits, so a float32 product is split as CUTLASS's
// 3xTF32 (FastF32) splits it: each operand x becomes big, x rounded to
// TF32, and small = x - big (exact in float32; the tensor cores cut it to
// TF32), and the product sums small.big + big.small + big.big in float32
// (small terms first).  Only small.small and small's cut are dropped,
// about 2^-21 of the product, so scores keep float32's grade; the PV
// product splits p (a float32 in [0, 1]) and v the same way.  bf16
// operands, and p rounded to bf16, are exact in TF32 and take one pass.
//
// What bounds it on an H100: operations.  At the encoder stage's shape in
// float32 (B 8, S 2048, 12 heads of 64, causal) the three passes of 51.6
// GFLOP take 0.313 ms at the TF32 peak (495 TFLOP/s), against 0.770 ms
// for the same products by float32 FMA on the CUDA cores (67 TFLOP/s) and
// 0.060 ms of bytes.  mma.sync reaches about two thirds of wgmma's TF32
// rate, and beside its products the split (an add, a mask and a subtract
// an operand), the fragment loads and the softmax take the warps' issue
// slots, about 7 instructions an HMMA; so a warp at D 64 owns two 16-row
// tiles, and each K or V fragment it loads and splits feeds both, and the
// softmax works in log2 units (one FFMA and one ex2 a score off the
// borders).
//
// One block owns one (b, h, 128-query tile), the heaviest causal tiles
// first: 8 warps of 16 rows, or at D 64 4 warps of 32.  A warp keeps its
// m, l and O accumulators in registers.  K and V come in tiles of 64 keys
// (D 64 and 128) or 128 keys (D 16 and 32: the plain version's blocks, so
// bf16's p is rounded against the same running max) through a
// double-buffered ring in shared memory, as float32: cp.async for float32,
// loads widened in registers for bf16.  Q stays in shared memory (at D 128
// its split fragments would not fit beside O and S in registers).  Every
// fragment is split in registers as it is loaded, so the split costs no
// shared memory.  QK^T's k slots are permuted, slot t as dim 2t and slot
// t + 4 as dim 2t + 1 for A and B alike, so each fragment pair is one
// 8-byte load, and rows padded by 8 floats keep those loads free of bank
// conflicts.  The S accumulator (keys 2t, 2t + 1 of rows g, g + 8 in
// thread 4g + t) is the PV product's A fragment as it stands, read with
// slot t as key 2t and slot t + 4 as key 2t + 1; V's B fragment is read
// from rows 2t and 2t + 1 to match (rows padded by 4 floats: conflict-free
// 4-byte loads).  A row's max and sum need a shuffle across the quad that
// shares it; l keeps each thread's share of the unrounded sum, reduced
// once at the end.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

constexpr int kRows = 128;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskY = -1e30f * kLog2e;  // the reference's mask value -1e30, in log2 units
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kTf32Mask = 0xFFFFE000u;  // sign, exponent and TF32's 10 mantissa bits

template <int D>
constexpr int kTiles = D == 64 ? 2 : 1;  // 16-row tiles a warp owns
template <int D>
constexpr int kThreads = 32 * kRows / (16 * kTiles<D>);
template <int D>
constexpr int kKeys = D <= 32 ? 128 : 64;  // keys per K / V tile
template <int D>
constexpr int kQS = D + 8;  // row stride of Q and K in shared memory, floats
template <int D>
constexpr int kVS = D + 4;  // row stride of V

// Q, then two stages of K and of V.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kRows * kQS<D> + 2 * (size_t)kKeys<D> * (kQS<D> + kVS<D>));
}

template <typename T>
constexpr bool kIsF32 = false;
template <>
constexpr bool kIsF32<float> = true;

// N operands as TF32 words: (big, small) when kSplit, big rounded to
// nearest (ties away from zero), small = x - big as float32 bits, which the
// tensor cores cut to TF32 (they read an operand's sign, exponent and top
// 10 mantissa bits, as CUTLASS's FastF32 products rely on); else the
// float32 bits as they are (bf16 values and bf16-rounded p are exact).
template <bool kSplit, int N>
__device__ __forceinline__ void split(const float* x, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kSplit) {
      big[i] = (__float_as_uint(x[i]) + 0x1000u) & kTf32Mask;
      small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
    } else {
      big[i] = __float_as_uint(x[i]);
    }
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a[i] b over one step of 8, for the M row tiles i: three TF32
// products each (small terms first, pass by pass across the tiles), or one.
template <bool kSplit, int M>
__device__ __forceinline__ void mma_split(float (&c)[M][4], const uint32_t (&a_big)[M][4],
                                          const uint32_t (&a_small)[M][4],
                                          const uint32_t* b_big, const uint32_t* b_small) {
  if constexpr (kSplit) {
#pragma unroll
    for (int i = 0; i < M; ++i) mma(c[i], a_small[i], b_big);
#pragma unroll
    for (int i = 0; i < M; ++i) mma(c[i], a_big[i], b_small);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) mma(c[i], a_big[i], b_big);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [0, N) of a tile into shared memory as float32, `stride` floats a
// row: row i from src + i * row_elems, zeros from row `valid` on, by the
// block's kThreads threads.  float32 goes by cp.async (its group is
// committed by the caller); bf16 is loaded, widened and stored.
template <typename T, int D, int N>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src,
                                          size_t row_elems, int valid, int tid) {
  if constexpr (kIsF32<T>) {
    constexpr int kChunks = D / 4;  // 16 bytes each
#pragma unroll 4
    for (int idx = tid; idx < N * kChunks; idx += kThreads<D>) {
      const int i = idx / kChunks, c = idx % kChunks;
      const bool ok = i < valid;
      cp_async16(dst + i * stride + 4 * c, ok ? src + i * row_elems + 4 * c : src, ok);
    }
  } else {
    constexpr int kChunks = D / 8;  // 8 bf16 each
#pragma unroll 4
    for (int idx = tid; idx < N * kChunks; idx += kThreads<D>) {
      const int i = idx / kChunks, c = idx % kChunks;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (i < valid) raw = *reinterpret_cast<const uint4*>(src + i * row_elems + 8 * c);
      float4* out = reinterpret_cast<float4*>(dst + i * stride + 8 * c);
      out[0] = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xFFFF0000u),
                           __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xFFFF0000u));
      out[1] = make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xFFFF0000u),
                           __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xFFFF0000u));
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (kIsF32<T>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* out, float a, float b) {
  if constexpr (kIsF32<T>) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads<D>, D == 64 ? 2 : 1) flash_attention_tf32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int bsz, int sq, int skv, int h, int kvh, int causal, int has_window,
    int window, float scale, int skip) {
  constexpr bool kSplit = kIsF32<T>;
  constexpr int M = kTiles<D>, BK = kKeys<D>, QS = kQS<D>, VS = kVS<D>;
  constexpr int NT = BK / 8;  // S's n tiles, and the P V product's k steps
  constexpr int DT = D / 8;  // the Q K^T product's k steps, and O's n tiles
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* s_k = s_q + kRows * QS;  // [2][BK][QS]
  float* s_v = s_k + 2 * BK * QS;  // [2][BK][VS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // The work tile: the last query tiles (the heaviest under a causal mask) first.
  const int n_qt = (sq + kRows - 1) / kRows;
  const int bh = blockIdx.x % (bsz * h);
  const int q0 = (n_qt - 1 - blockIdx.x / (bsz * h)) * kRows;
  const int b = bh / h, hq = bh % h, hk = hq / (h / kvh);
  const int off = skv - sq;  // right-aligned queries

  // The kv tiles this block walks.
  int lo = 0, hi = skv;
  if (skip) {
    const int qp_first = q0 + off;
    const int qp_last = min(q0 + kRows, sq) - 1 + off;
    if (causal) hi = min(skv, qp_last + 1);
    if (has_window) lo = max(0, qp_first - window + 1);
  }
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;

  const size_t kv_row = (size_t)kvh * D;
  const T* k_bh = k + (size_t)b * skv * kv_row + (size_t)hk * D;  // key 0 of (b, hk)
  const T* v_bh = v + (size_t)b * skv * kv_row + (size_t)hk * D;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    load_rows<T, D, BK>(s_k + stage * BK * QS, QS, k_bh + k0 * kv_row, kv_row, skv - k0, tid);
    load_rows<T, D, BK>(s_v + stage * BK * VS, VS, v_bh + k0 * kv_row, kv_row, skv - k0, tid);
  };
  load_rows<T, D, kRows>(s_q, QS, q + (((size_t)b * sq + q0) * h + hq) * D, (size_t)h * D,
                         sq - q0, tid);
  load_kv(t_lo, 0);
  cp_async_commit();

  // This thread's rows: r0 + 16 i and r0 + 16 i + 8 of the block's tile, i < M.
  const int r0 = warp * 16 * M + g;
  const int qpos0 = q0 + r0 + off;
  const int warp_qpos = q0 + warp * 16 * M + off;  // the warp's first row's position
  const float scale_log2 = scale * kLog2e;  // scores in log2 units: p = exp2(y - m)
  float m[M][2], l[M][2];  // m in log2 units
  float acc[DT][M][4];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kMaskY;
      l[i][r] = 0.0f;
    }
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][i][e] = 0.0f;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int stage = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile's group (and Q's) has landed
    __syncthreads();
    const float* s_kt = s_k + stage * BK * QS;
    const float* s_vt = s_v + stage * BK * VS;
    const int k0 = tile * BK;

    // S = Q K^T: k slot t is dim 8 kk + 2t, slot t + 4 is dim 8 kk + 2t + 1.
    float s[NT][M][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t a_big[M][4], a_small[M][4];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float* row = s_q + (r0 + 16 * i) * QS + 8 * kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(row);
        const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * QS);
        const float a[4] = {x0.x, x1.x, x0.y, x1.y};
        split<kSplit, 4>(a, a_big[i], a_small[i]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(s_kt + (8 * n + g) * QS + 8 * kk + 2 * t);
        const float bv[2] = {y.x, y.y};
        uint32_t b_big[2], b_small[2];
        split<kSplit, 2>(bv, b_big, b_small);
        mma_split<kSplit, M>(s[n], a_big, a_small, b_big, b_small);
      }
    }

    // Online softmax in log2 units; p (rounded to the inputs' type) replaces
    // s.  s[n][i][e] is row r0 + 16 i + 8 (e / 2), key k0 + 8 n + 2t + (e % 2).
    // Only a tile that the diagonal, the window's edge or Skv crosses is
    // masked: there a score is scaled, masked (-1e30, or -inf past Skv) and
    // p = exp2(y - m_new), since at -1e30 the rounding of an FMA's product
    // alone would overflow exp2; elsewhere p = exp2(fma(s, scale log2 e,
    // -m_new)), the row's max taken on the raw scores (the scale is > 0).
    const bool border = (causal && k0 + BK - 1 > warp_qpos) ||
                        (has_window && k0 <= warp_qpos + 16 * M - 1 - window) || k0 + BK > skv;
    float alpha[M][2];
    auto softmax = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (kMasked) {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int qpos = qpos0 + 16 * i + 8 * r;
                const int kpos = k0 + 8 * n + 2 * t + c;
                bool keep = true;
                if (causal) keep = keep && kpos <= qpos;
                if (has_window) keep = keep && kpos > qpos - window;
                float y = keep ? s[n][i][2 * r + c] * scale_log2 : kMaskY;
                if (kpos >= skv) y = -INFINITY;  // past the keys: weight 0
                s[n][i][2 * r + c] = y;
              }
          }
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mx = fmaxf(mx, fmaxf(s[n][i][2 * r], s[n][i][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          if constexpr (!kMasked) mx *= scale_log2;
          const float m_new = fmaxf(m[i][r], mx);
          alpha[i][r] = exp2_approx(m[i][r] - m_new);
          m[i][r] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& x = s[n][i][2 * r + c];
              const float p = kMasked ? exp2_approx(x - m_new)
                                      : exp2_approx(fmaf(x, scale_log2, -m_new));
              sum += p;
              x = round_to<T>(p);
            }
          l[i][r] = alpha[i][r] * l[i][r] + sum;
        }
    };
    if (border) {
      softmax(std::true_type{});
    } else {
      softmax(std::false_type{});
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][e] *= alpha[i][e / 2];

    // O += P V: k step n is keys 8 n .. 8 n + 7, slot t key 2t, slot t + 4 key 2t + 1.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t a_big[M][4], a_small[M][4];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float a[4] = {s[n][i][0], s[n][i][2], s[n][i][1], s[n][i][3]};
        split<kSplit, 4>(a, a_big[i], a_small[i]);
      }
      const float* v_row = s_vt + (8 * n + 2 * t) * VS + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float bv[2] = {v_row[8 * d], v_row[VS + 8 * d]};
        uint32_t b_big[2], b_small[2];
        split<kSplit, 2>(bv, b_big, b_small);
        mma_split<kSplit, M>(acc[d], a_big, a_small, b_big, b_small);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[i][r];
      li += __shfl_xor_sync(kFull, li, 1);
      li += __shfl_xor_sync(kFull, li, 2);
      const int row = q0 + r0 + 16 * i + 8 * r;
      if (row >= sq) continue;
      const float denom = fmaxf(li, 1e-30f);
      T* out = o + (((size_t)b * sq + row) * h + hq) * D + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        store2<T>(out + 8 * d, acc[d][i][2 * r] / denom, acc[d][i][2 * r + 1] / denom);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int h, int kvh, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_tf32_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // Skipping masked tiles is exact only when every query row has a real key.
  const int skip = sq <= skv && (!has_window || window >= 1);
  const long long blocks = (long long)((sq + kRows - 1) / kRows) * h * b;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads<D>, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), b, sq, skv, h, kvh, causal, has_window, window, scale, skip);
  return (int)cudaGetLastError();
}

}  // namespace tc

// q (B, Sq, H, D), k and v (B, Skv, KV, D), o like q; contiguous and 16-byte
// aligned; float32 (bf16 = 0) at D 16, 32, 64 or 128, or bfloat16 (bf16 = 1)
// at D 16 or 32 (the wgmma kernel takes bf16 at 64 and 128); H a multiple
// of KV.  window is read only when has_window.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int flash_attention_tf32(const void* q, const void* k, const void* v, void* o,
                                    int b, int sq, int skv, int h, int kvh, int d, int bf16,
                                    int causal, int has_window, int window, float scale,
                                    void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define TC_LAUNCH(T, D)                                                                    \
  tc::launch<T, D>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window, scale, s)
  if (bf16) {
    switch (d) {
      case 16:
        return TC_LAUNCH(BF, 16);
      case 32:
        return TC_LAUNCH(BF, 32);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 16:
      return TC_LAUNCH(float, 16);
    case 32:
      return TC_LAUNCH(float, 32);
    case 64:
      return TC_LAUNCH(float, 64);
    case 128:
      return TC_LAUNCH(float, 128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TC_LAUNCH
}

// ---------------------------------------------------------------------------
// flash_attention_wgmma: bf16, D 64 or 128, on the tensor cores.

namespace wg {

constexpr int kRows = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kKeys = 128;  // keys per K / V tile
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kAtom = 64;  // bf16 columns in one 128-byte swizzle row
constexpr int kSubBytes = 128 * 128;  // one [128 rows][64 columns] bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskY = -1e30f * kLog2e;  // the reference's -1e30, in log2 units

template <int D>
constexpr int kStages = D == 64 ? 4 : 3;  // K / V ring depth

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 1024 bytes, and the wgmma descriptors assume the pattern starts
// there): Q, then K and V of each stage, each D / 64 boxes; the barriers.
template <int D>
struct Layout {
  static constexpr int kTile = (D / kAtom) * kSubBytes;  // 128 rows x D
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages<D> * kTile;
  static constexpr int kBars = kV + kStages<D> * kTile;
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages<D>);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N of this warpgroup's committed product groups are
// still in flight (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins register values in place around the asynchronous products: the
// compiler may not move a read or write of r across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_F32 FA_F8(0), FA_F8(8), FA_F8(16), FA_F8(24)
#define FA_F64 FA_F32, FA_F8(32), FA_F8(40), FA_F8(48), FA_F8(56)
#define FA_R32                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R64                                                                            \
  FA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
         "%62, %63"

// d (64 x 128, f32) = [d +] A (64 x 16) B^T (128 x 16), both bf16 K-major in
// shared memory.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 in registers) B (16 x N), B bf16
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_F8
#undef FA_F32
#undef FA_F64
#undef FA_R32
#undef FA_R64

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O += P V over the tile's 128 keys in steps of 16 rows of V (2048 bytes):
// V is the MN-major B operand, its two 64-column boxes of D 128 kSubBytes
// apart; P is the A operand from registers, 4 bf16 pairs a step.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2], const uint32_t (&pk)[32],
                                       uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    mma_rs(acc, pk + 4 * kk, sw128_desc(v_tile + kk * 2048, kSubBytes, 1024));
}

// One arrival per consumer warp frees a K / V stage for the producer.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Where a consumer thread's scores sit: rows row0 and row0 + 8, columns
// 8 j + col0 + {0, 1}; off = Skv - Sq.
struct Rows {
  int row0, col0, off;
};

// The online softmax of one tile's scores, in place.  Scores are carried
// as y = s D^-0.5 log2(e) (the scale applied in float32 after the product,
// log2 e folded into it), so p = exp2(y - m); a masked score is the
// reference's -1e30 in the same units, a key past Skv -inf.  Updates m
// (the row max, in y units) and l (this thread's share of the row sum of
// the unrounded p); returns each row's alpha = exp2(m_old - m_new).  Max
// and sum run in four chains for instruction-level parallelism.
template <bool kEdge>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& rows, int k0,
                                             float scale_log2, int skv, int causal,
                                             int has_window, int window) {
  if constexpr (kEdge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = k0 + 8 * (i / 4) + rows.col0 + (i % 2);
      const int qpos = rows.row0 + 8 * ((i / 2) % 2) + rows.off;
      bool keep = true;
      if (causal) keep = keep && kpos <= qpos;
      if (has_window) keep = keep && kpos > qpos - window;
      sc[i] = keep ? sc[i] * scale_log2 : kMaskY;
      if (kpos >= skv) sc[i] = -INFINITY;  // past the keys: weight 0
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) mx[a] = fmaxf(sc[4 * a + 2 * r], sc[4 * a + 2 * r + 1]);
#pragma unroll
    for (int j = 4; j < 16; ++j)
      mx[j % 4] = fmaxf(mx[j % 4], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xFFFFFFFFu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xFFFFFFFFu, row_max, 2));
    // Off the borders the scores are still raw (the scale is positive, so
    // their max scales to the max of the scaled ones).
    const float m_new = fmaxf(m[r], kEdge ? row_max : row_max * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        // Off the borders m_new is a real score's, so one FMA is exact
        // enough; on them, s - m_new first: at -1e30 the rounding of the
        // product alone would overflow exp2.
        x = exp2_approx(kEdge ? x - m_new : fmaf(x, scale_log2, -m_new));
      }
      sum[j % 4] += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l[r] = alpha[r] * l[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// One work tile: 128 query rows of one (b, h) and the kv tiles they walk.
struct Tile {
  int q0, hq, hk, b;
  int t_lo, n;  // first kv tile, number of kv tiles
};

// The attention problem, as every role of the kernel reads it.
struct Problem {
  int bsz, sq, skv, h, kvh, causal, has_window, window, skip;
  int n_qt, n_total;  // query tiles per (b, h); work tiles
};

// Work tile i: heaviest first (the last query tiles of causal attention
// walk the most keys), (b, h) fastest.
__device__ __forceinline__ Tile tile_at(const Problem& pr, int i) {
  Tile t;
  const int bh = i % (pr.h * pr.bsz);
  const int qt = pr.n_qt - 1 - i / (pr.h * pr.bsz);
  t.hq = bh % pr.h;
  t.b = bh / pr.h;
  t.hk = t.hq / (pr.h / pr.kvh);
  t.q0 = qt * kRows;
  const int off = pr.skv - pr.sq;  // right-aligned queries
  int lo = 0, hi = pr.skv;
  if (pr.skip) {
    const int qp_first = t.q0 + off;
    const int qp_last = min(t.q0 + kRows, pr.sq) - 1 + off;
    if (pr.causal) hi = min(pr.skv, qp_last + 1);
    if (pr.has_window) lo = max(0, qp_first - pr.window + 1);
  }
  t.t_lo = lo / kKeys;
  t.n = max(0, (hi + kKeys - 1) / kKeys - t.t_lo);
  return t;
}

// The w-th work tile of this CTA: round w of gridDim.x tiles, walked in a
// snake (forward in even rounds, backward in odd ones) so that over two
// rounds of the heaviest-first order each CTA gets a heavy and a light tile.
__device__ __forceinline__ int work_index(int w) {
  const int g = gridDim.x, c = blockIdx.x;
  return w * g + ((w & 1) ? g - 1 - c : c);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    const Problem pr, float scale) {
  using L = Layout<D>;
  constexpr int S = kStages<D>;
  constexpr int kBoxes = D / kAtom;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full_bar = q_empty + 8;
  const uint32_t empty_bar = full_bar + 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 0) {
    // Producer: one thread issues every load, running ahead of the
    // consumers through the ring and into the next work tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // K / V tiles loaded so far, over all work tiles
      for (int w = 0;; ++w) {
        const int i = work_index(w);
        if (i >= pr.n_total) break;
        const Tile tl = tile_at(pr, i);
        if (w > 0) mbar_wait(q_empty, (w - 1) & 1);
        mbar_expect_tx(q_full, kBoxes * kSubBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + L::kQ + x * kSubBytes, &q_map, q_full, x * kAtom, tl.hq, tl.q0, tl.b);
        for (int it = 0; it < tl.n; ++it, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty_bar + 8 * s, ((g / S) - 1) & 1);
          const uint32_t bar = full_bar + 8 * s;
          const int k0 = (tl.t_lo + it) * kKeys;
          mbar_expect_tx(bar, 2 * kBoxes * kSubBytes);
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(base + L::kK + s * L::kTile + x * kSubBytes, &k_map, bar, x * kAtom, tl.hk,
                     k0, tl.b);
            tma_load(base + L::kV + s * L::kTile + x * kSubBytes, &v_map, bar, x * kAtom, tl.hk,
                     k0, tl.b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of each work
    // tile; thread t of it holds rows r0 = 16 (t / 32) + (t % 32) / 4 and
    // r0 + 8, and of each, the columns 8 j + 2 (t % 4) + {0, 1}.  Kv tile
    // j's S = Q K^T is issued together with tile j - 1's O += P V, and the
    // softmax of S_j runs while P V still does.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = group - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int off = pr.skv - pr.sq;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;
    const uint32_t k_base = base + L::kK, v_base = base + L::kV;
    float acc[D / 2];
    float m[2], l[2], alpha[2];
    float sc[64];  // S of the newest kv tile, then its p in float32
    uint32_t pk[32];  // the p of the kv tile in the PV product, bf16 pairs
    int g = 0;  // K / V tiles consumed so far, over all work tiles

    for (int w = 0;; ++w) {
      const int i = work_index(w);
      if (i >= pr.n_total) break;
      const Tile tl = tile_at(pr, i);
      const int n = tl.n;
      Rows rows;
      rows.row0 = tl.q0 + 64 * c + 16 * (t / 32) + lane / 4;
      rows.col0 = 2 * (lane % 4);
      rows.off = off;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kMaskY;
        l[r] = 0.0f;
      }
      // A border (the diagonal, the window edge, Skv) crosses kv tile it.
      auto softmax = [&](int it) {
        const int k0 = (tl.t_lo + it) * kKeys;
        const bool edge = k0 + kKeys > pr.skv || (pr.causal && k0 + kKeys - 1 > tl.q0 + off) ||
                          (pr.has_window && k0 <= tl.q0 + kRows - 1 + off - pr.window);
        if (edge) {
          softmax_tile<true>(sc, m, l, alpha, rows, k0, scale_log2, pr.skv, pr.causal,
                             pr.has_window, pr.window);
        } else {
          softmax_tile<false>(sc, m, l, alpha, rows, k0, scale_log2, pr.skv, pr.causal,
                              pr.has_window, pr.window);
        }
      };
      // S = Q K^T of kv tile it over D in steps of 16: a step moves 32
      // bytes along a swizzled row, and every 4 steps to the next box.
      auto issue_s = [&](int it) {
        const uint32_t k_tile = k_base + ((g + it) % S) * L::kTile;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t step = (kk / 4) * kSubBytes + (kk % 4) * 32;
          mma_ss_n128(sc, sw128_desc(q_rows + step, 16, 1024),
                      sw128_desc(k_tile + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      auto pack = [&] {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            pk[2 * j + r] = pack_bf16(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
      };
      auto stage_of = [&](int it) { return (g + it) % S; };
      auto parity_of = [&](int it) { return ((g + it) / S) & 1; };

      mbar_wait(q_full, w & 1);
      if (n == 0) release(q_empty, lane);
      if (n > 0) {
        mbar_wait(full_bar + 8 * stage_of(0), parity_of(0));
        fence_regs(sc);
        wgmma_fence();
        issue_s(0);
        wgmma_wait<0>();
        fence_regs(sc);
        if (n == 1) release(q_empty, lane);  // the last read of Q is done
        softmax(0);
        pack();
      }
      for (int it = 1; it < n; ++it) {
        mbar_wait(full_bar + 8 * stage_of(it), parity_of(it));
        fence_regs(sc);
        fence_regs(pk);
        fence_regs(acc);
        wgmma_fence();
        issue_s(it);
        mma_pv<D>(acc, pk, v_base + stage_of(it - 1) * L::kTile);
        wgmma_commit();
        wgmma_wait<1>();  // S of this kv tile is done; P V of the last still runs
        fence_regs(sc);
        if (it == n - 1) release(q_empty, lane);
        softmax(it);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pk);
        release(empty_bar + 8 * stage_of(it - 1), lane);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
        pack();
      }
      if (n > 0) {
        fence_regs(pk);
        fence_regs(acc);
        wgmma_fence();
        mma_pv<D>(acc, pk, v_base + stage_of(n - 1) * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_bar + 8 * stage_of(n - 1), lane);
      }
      g += n;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xFFFFFFFFu, lr, 1);
        lr += __shfl_xor_sync(0xFFFFFFFFu, lr, 2);
        const int row = rows.row0 + 8 * r;
        if (row >= pr.sq) continue;
        // One division a row, then products: each division carries its own
        // slow-path branch, and one per element costs as long as a kv tile.
        const float inv = 1.0f / fmaxf(lr, 1e-30f);
        __nv_bfloat16* out =
            o + ((static_cast<size_t>(tl.b) * pr.sq + row) * pr.h + tl.hq) * D + rows.col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point lookup (the library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a contiguous (B, S, heads, D) bf16 tensor as (D, heads, S, B),
// box (64, 1, 128, 1) with 128-byte swizzle; rows past S read as zeros.
// Built per call from the pointer: it is never reused for another tensor.
int make_map(CUtensorMap* map, const void* ptr, int bsz, int seq, int heads, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)bsz};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {kAtom, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int h,
           int kvh, int causal, int has_window, int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, b, sq, h, D);
  if (!err) err = make_map(&k_map, k, b, skv, kvh, D);
  if (!err) err = make_map(&v_map, v, b, skv, kvh, D);
  if (err) return err;
  const int smem = Layout<D>::kBytes + 1024;  // + the alignment of the base
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  int dev = 0, sms = 0;
  cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return (int)cerr;
  Problem pr;
  pr.bsz = b;
  pr.sq = sq;
  pr.skv = skv;
  pr.h = h;
  pr.kvh = kvh;
  pr.causal = causal;
  pr.has_window = has_window;
  pr.window = window;
  pr.skip = sq <= skv && (!has_window || window >= 1);
  pr.n_qt = (sq + kRows - 1) / kRows;
  const long long total = (long long)pr.n_qt * h * b;
  if (total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  pr.n_total = (int)total;
  // Persistent: one CTA per SM walks its share of the work tiles.
  const int grid = (int)(total < sms ? total : sms);
  kernel<<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map,
                                           static_cast<__nv_bfloat16*>(o), pr, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// q (B, Sq, H, D), k and v (B, Skv, KV, D), o like q; contiguous bfloat16,
// 16-byte aligned; D 64 or 128; H a multiple of KV.  window is read only
// when has_window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                     int b, int sq, int skv, int h, int kvh, int d, int causal,
                                     int has_window, int window, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return wg::launch<64>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window, scale, s);
    case 128:
      return wg::launch<128>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window, scale,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
