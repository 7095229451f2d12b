// Blocked online-softmax attention (FlashAttention style) on Hopper (sm_90a).
//
// Replaces, in src/repro/kernels/flash_attention.py:
//   flash_attention (:75, its pallas_call at :100) and its body _fa_kernel (:29)
//   -> flash_attention
//
// What it computes, as _fa_kernel does: q (B, Sq, H, D), k and v
// (B, Skv, KV, D), float32 or bfloat16, heads third.  Query head h reads kv
// head h / (H / KV), with no repeat in memory.  Scores are the float32 dot
// q.k times D^-0.5; query i sits at position i + Skv - Sq and key j at j;
// a score is masked to -1e30 unless k_pos <= q_pos (causal) and
// k_pos > q_pos - window (sliding window).  Running max m, sum l and the
// accumulator stay in float32; p = exp(s - m_new) is rounded to the inputs'
// type before the PV product (l sums the unrounded p); the output is
// acc / max(l, 1e-30) rounded to the inputs' type.
//
// What bounds it on an H100: operations.  At the encoder stage's shapes
// (B = 8, S = 2048, H = 12, D = 64, bf16, causal) the work is 4 B H D
// S(S+1)/2 = 51.6 GFLOP against 101 MB of q, k, v and o: 0.052 ms at the
// bf16 tensor-core peak against 0.030 ms of bytes.  This first kernel does
// its products with float32 FMA on the CUDA cores (67 TFLOP/s peak), so it
// sits well above that bound; wgmma, TMA and warp specialisation are the
// redesign that comes next.
//
// Design: the TPU kernel's kv axis is a sequential grid axis carrying m, l
// and acc in VMEM scratch.  Blocks here run in no order, so one block of
// 256 threads owns one (b, h, 64-query tile) and walks the kv tiles itself,
// its state in registers.  Per 64-key tile: K and V are staged in shared
// memory as float32 (K transposed, so a thread reads 4 keys of one
// dimension as one float4); each thread computes a 4 x 4 block of scores
// (4 query rows x 4 keys) by FMA over D; the 16 threads sharing a row
// reduce its max and sum with warp shuffles; p goes through shared memory
// (transposed) into the PV product, where each thread owns its 4 rows x
// D/16 output columns.  Kv tiles wholly above the causal diagonal, or wholly
// before the window, are skipped: in the reference they give p = 0 and
// alpha = 1 (or, before any real key, a contribution that the first real
// key multiplies by exp(-1e30 - m) = 0), so skipping them changes no value.
// That holds when every query row has a real key, i.e. when Sq <= Skv;
// otherwise every tile is walked.  Keys past Skv (a ragged last tile) get
// -inf, and so weight 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int kPad = 4;  // keeps float4 rows aligned, spreads the banks
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Column e of the DC = D/16 output columns a thread owns: 4 consecutive
// columns every 64 when DC >= 4 (float4 reads), else DC consecutive ones.
template <int DC>
__device__ __forceinline__ int out_col(int tc, int e) {
  if constexpr (DC >= 4) {
    return (e / 4) * 64 + 4 * tc + (e % 4);
  } else {
    return DC * tc + e;
  }
}

// The DC columns a thread owns from one row of shared memory, as float4,
// float2 or float reads.
template <int DC>
__device__ __forceinline__ void load_cols(const float* row, int tc, float* out) {
  if constexpr (DC >= 4) {
#pragma unroll
    for (int g = 0; g < DC / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + g * 64 + 4 * tc);
      out[4 * g] = x.x;
      out[4 * g + 1] = x.y;
      out[4 * g + 2] = x.z;
      out[4 * g + 3] = x.w;
    }
  } else if constexpr (DC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * tc);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = row[tc];
  }
}

template <int D>
constexpr size_t smem_floats() {
  // qT [D][BQ+pad], kT [D][BK+pad], v [BK][D], pT [BK][BQ+pad]
  return (size_t)D * (kBQ + kPad) + (size_t)D * (kBK + kPad) + (size_t)kBK * D +
         (size_t)kBK * (kBQ + kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int skv, int h, int kvh, int causal, int has_window,
    int window, float scale, int skip) {
  constexpr int DC = D / 16;
  constexpr int QS = kBQ + kPad;  // row stride of qT and pT
  constexpr int KS = kBK + kPad;  // row stride of kT
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;
  float* kT = qT + D * QS;
  float* vs = kT + D * KS;
  float* pT = vs + kBK * D;

  const int tid = threadIdx.x;
  const int tc = tid % 16;  // key / output-column group
  const int tr = tid / 16;  // query-row group: rows 4 tr .. 4 tr + 3
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (h / kvh);
  const int off = skv - sq;  // right-aligned queries

  // Stage this block's queries, transposed: qT[d][i].
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int row = q0 + i;
    qT[d * QS + i] =
        row < sq ? to_float<T>(q[(((size_t)b * sq + row) * h + hq) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[r][e] = 0.0f;
  }

  // The kv tiles this block walks.
  int lo = 0, hi = skv;
  if (skip) {
    const int qp_first = q0 + off;
    const int qp_last = min(q0 + kBQ, sq) - 1 + off;
    if (causal) hi = min(skv, qp_last + 1);
    if (has_window) lo = max(0, qp_first - window + 1);
  }
  const int t_lo = lo / kBK, t_hi = (hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's reads of kT, vs, pT are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < skv) {
        const size_t g = (((size_t)b * skv + key) * kvh + hk) * D + d;
        kx = to_float<T>(k[g]);
        vx = to_float<T>(v[g]);
      }
      kT[d * KS + j] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    // Scores: rows 4 tr + r, keys 4 tc + c.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * QS + 4 * tr);
      const float4 bk = *reinterpret_cast<const float4*>(kT + d * KS + 4 * tc);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // Mask, online softmax over the tile, p to shared memory.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + 4 * tr + r + off;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * tc + c;
        bool keep = true;
        if (causal) keep = keep && kpos <= qpos;
        if (has_window) keep = keep && kpos > qpos - window;
        float x = keep ? s[r][c] * scale : kNegInf;
        if (kpos >= skv) x = -INFINITY;  // past the keys: weight 0
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        pT[(4 * tc + c) * QS + 4 * tr + r] = to_float<T>(from_float<T>(p));
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

    // acc += p . v over the tile's keys.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + j * QS + 4 * tr);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
      load_cols<DC>(vs + j * D, tc, vv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < DC; ++e) acc[r][e] = fmaf(pv[r], vv[e], acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * tr + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + (((size_t)b * sq + row) * h + hq) * D;
#pragma unroll
    for (int e = 0; e < DC; ++e) out[out_col<DC>(tc, e)] = from_float<T>(acc[r][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int h, int kvh, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // Skipping masked tiles is exact only when every query row has a real key.
  const int skip = sq <= skv && (!has_window || window >= 1);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, h, kvh, causal, has_window, window, scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, int b, int sq,
             int skv, int h, int kvh, int causal, int has_window, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KV, D), o like q; contiguous, all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); D in {16, 32, 64, 128}; H a
// multiple of KV.  window is read only when has_window.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                               int sq, int skv, int h, int kvh, int d, int bf16, int causal,
                               int has_window, int window, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(d, q, k, v, o, b, sq, skv, h, kvh, causal, has_window,
                                   window, scale, s);
  }
  return dispatch<float>(d, q, k, v, o, b, sq, skv, h, kvh, causal, has_window, window,
                         scale, s);
}
