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
// is a read of h (B x D) from L2, 2 B D 4dh / 132 FMAs an SM, the gates, a
// write of h and one grid-wide barrier.
//
// Design: a persistent cooperative grid (cudaLaunchCooperativeKernel; the
// entry checks with the occupancy API that every block is co-resident and
// fails rather than split the grid).  Block x owns U = ceil(D / SMs) units
// j, all four gates of each, and keeps their 4U columns of r resident in
// shared memory for the whole sequence (at xlstm-1.3b, 16 units: 128 KB of
// r's 16.8 MB, one block an SM), and their c, n, m and h in shared memory
// (a thread may own more than one (row, unit) pair, so not in registers).
// A forward step: stage h_{t-1} (kBatchTile rows at a time) past L1
// (__ldcg: other blocks wrote it), one warp a column with lanes over k and
// a butterfly sum, the gates, h_t written to hs, one grid.sync().  (A
// version that carried 2 or 4 columns a warp through arrays of pointers and
// started the wx loads before the staging measured slower on the H100.)  The
// backward runs the same owner split in reverse: the cell's gradient for
// its own units, then d h_{t-1} through the transposed product of the same
// index map.  Every block computes a partial of d h_{t-1} over its own
// columns for all D entries, writes it to a double-buffered scratch (2,
// grid, B, D), one grid.sync(), and each block sums the blocks' partials of
// its own units in a fixed order (threads over block slices, kInFlight
// loads in flight, then a fixed fold): one barrier a step, no second copy
// of r, no atomics, so the backward is deterministic from run to run.
//
// The arithmetic follows slstm_scan_plain / slstm_scan_backward_plain
// (kernels/slstm_scan.py) term for term; only the order of the products'
// sums (and FMA contraction) differs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatchTile = 4;  // rows of h_{t-1} staged at once (forward)
constexpr int kInFlight = 8;   // the backward's fold: loads in flight a thread
constexpr float kNormFloor = 1e-6f;

struct Plan {
  int units;       // U: units a block owns (all four gates of each)
  int grid;        // blocks, every one co-resident
  int batch_tile;  // forward: rows of h staged at once
  int smem;        // dynamic shared memory bytes a block
  int per_sm;      // blocks an SM holds at that shared memory
  int sms;
};

// Shared memory in 4-byte words.  r's columns are padded to dh + 1 words so
// that the one-time load (units fastest) hits few banks twice.
__host__ __device__ inline int forward_words(int B, int D, int NH, int U, int BT) {
  const int C = 4 * U, ld = D / NH + 1;
  return C * ld + BT * D + BT * C + 4 * B * U + C;
}

__host__ __device__ inline int backward_words(int B, int D, int NH, int U) {
  const int C = 4 * U, ld = D / NH + 1;
  return C * ld + B * C + 4 * B * U + kThreads + C + C + NH + 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // every lane holds the same sum (a + b == b + a)
}

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as torch's CPU kernel.
__device__ __forceinline__ float log_sigmoid_(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Column c = 4 u + g of a block: gate g of unit j0 + u; its head (-1 past
// D) into head_s and r[head, :, col] into r_s[c * ld ...].
__device__ void load_columns(const float* __restrict__ r, float* r_s, int* head_s, int j0,
                             int U, int D, int NH) {
  const int dh = D / NH, e = 4 * dh, ld = dh + 1, C = 4 * U;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int j = j0 + (c >> 2);
    head_s[c] = j < D ? ((c & 3) * D + j) / e : -1;
  }
  for (int idx = threadIdx.x; idx < C * dh; idx += kThreads) {
    const int u = idx % U, rest = idx / U, k = rest % dh, g = rest / dh, j = j0 + u;
    float v = 0.f;
    if (j < D) {
      const int q = g * D + j;
      v = r[((size_t)(q / e) * dh + k) * e + q % e];
    }
    r_s[(4 * u + g) * ld + k] = v;
  }
}

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
  int B, S, D, NH, U, BT;
};

__global__ void __launch_bounds__(kThreads) slstm_forward_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, S = a.S, D = a.D, U = a.U, BT = a.BT;
  const int dh = D / a.NH, ld = dh + 1, C = 4 * U, BU = B * U;
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* r_s = smem;              // C x ld
  float* h_s = r_s + C * ld;      // BT x D: rows of h_{t-1}
  float* rec_s = h_s + BT * D;    // BT x C: the recurrent products
  float* st_s = rec_s + BT * C;   // c, n, m, h: 4 x (B x U)
  int* head_s = reinterpret_cast<int*>(st_s + 4 * BU);  // C

  load_columns(a.r, r_s, head_s, j0, U, D, a.NH);
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
  __syncthreads();

  const size_t bsd = (size_t)B * S * D;
  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int bt = min(BT, B - b0);
      for (int i = tid; i < bt * D; i += kThreads) {
        const int bb = i / D, x = i - bb * D;
        const float* src = t == 0 ? a.h0 + (size_t)(b0 + bb) * D + x
                                  : a.hs + ((size_t)(b0 + bb) * S + (t - 1)) * D + x;
        h_s[i] = __ldcg(src);
      }
      __syncthreads();
      for (int c = warp; c < C; c += kWarps) {
        const int hd = head_s[c];
        float acc[kBatchTile];
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) acc[bb] = 0.f;
        if (hd >= 0) {
          const float* rc = r_s + c * ld;
          const float* hv = h_s + hd * dh;
          for (int k = lane; k < dh; k += 32) {
            const float rv = rc[k];
#pragma unroll
            for (int bb = 0; bb < kBatchTile; ++bb)
              if (bb < bt) acc[bb] = fmaf(rv, hv[bb * D + k], acc[bb]);
          }
        }
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) {
          const float v = warp_sum(acc[bb]);
          if (lane == 0 && bb < bt) rec_s[bb * C + c] = v;
        }
      }
      __syncthreads();
      for (int p = tid; p < bt * U; p += kThreads) {
        const int bb = p / U, u = p - bb * U, j = j0 + u, b = b0 + bb, s = b * U + u;
        if (j >= D) continue;
        const size_t row = (size_t)b * S + t;
        const float* w = a.wx + row * 4 * D;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g[q] = (w[q * D + j] + rec_s[bb * C + 4 * u + q]) + a.bias[q * D + j];
        const float c = st_s[s], n = st_s[BU + s], m = st_s[2 * BU + s];
        const float z = tanhf(g[0]);
        const float lf = log_sigmoid_(g[2]) + m;
        const float mn = fmaxf(lf, g[1]);
        const float ig = expf(g[1] - mn), fg = expf(lf - mn);
        const float c1 = fg * c + ig * z;
        const float n1 = fg * n + ig;
        const float h1 = sigmoid_(g[3]) * c1 / fmaxf(n1, kNormFloor);
        a.hs[row * D + j] = h1;
        if (a.pre != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a.pre[row * 4 * D + q * D + j] = g[q];
        }
        if (a.cnm != nullptr) {
          a.cnm[row * D + j] = c1;
          a.cnm[bsd + row * D + j] = n1;
          a.cnm[2 * bsd + row * D + j] = mn;
        }
        st_s[s] = c1;
        st_s[BU + s] = n1;
        st_s[2 * BU + s] = mn;
        st_s[3 * BU + s] = h1;
      }
      __syncthreads();  // h_s and rec_s are the next tile's
    }
    if (t + 1 < S) grid.sync();  // h_t of every unit written
  }
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
  float* part;        // (2, grid, B, D) scratch: the blocks' partials of d h
  int B, S, D, NH, U;
};

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

__global__ void __launch_bounds__(kThreads) slstm_backward_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, S = a.S, D = a.D, U = a.U, NH = a.NH;
  const int dh = D / NH, ld = dh + 1, C = 4 * U, BU = B * U, G = gridDim.x;
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x;
  float* r_s = smem;               // C x ld
  float* dpre_s = r_s + C * ld;    // B x C: the step's d pre of own columns
  float* g_s = dpre_s + B * C;     // dc, dn, dm, dh carried: 4 x (B x U)
  float* red_s = g_s + 4 * BU;     // kThreads: the partials' fold
  int* head_s = reinterpret_cast<int*>(red_s + kThreads);  // C
  int* order_s = head_s + C;       // C: own columns, by head
  int* start_s = order_s + C;      // NH + 1: each head's run in order_s

  load_columns(a.r, r_s, head_s, j0, U, D, NH);
  for (int i = tid; i < B * C; i += kThreads) dpre_s[i] = 0.f;
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      g_s[p] = a.d_c[o];
      g_s[BU + p] = a.d_n[o];
      g_s[2 * BU + p] = a.d_m[o];
      g_s[3 * BU + p] = a.d_h[o];
    }
  }
  __syncthreads();
  if (tid == 0) {
    int w = 0;
    for (int hd = 0; hd < NH; ++hd) {
      start_s[hd] = w;
      for (int c = 0; c < C; ++c)
        if (head_s[c] == hd) order_s[w++] = c;
    }
    start_s[NH] = w;
  }
  __syncthreads();

  const size_t bsd = (size_t)B * S * D;
  const int T = BU >= kThreads ? 1 : kThreads / BU;  // threads folding one pair's partials
  const int P = kThreads / T;                         // pairs folded at once
  for (int t = S - 1; t >= 0; --t) {
    // (1) the cell's gradient for own (row, unit) pairs
    for (int p = tid; p < BU; p += kThreads) {
      const int b = p / U, u = p - b * U, j = j0 + u;
      if (j >= D) continue;
      const size_t row = (size_t)b * S + t;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = a.pre[row * 4 * D + q * D + j];
      float c, n, m;
      if (t == 0) {
        const size_t o = (size_t)b * D + j;
        c = a.c0[o];
        n = a.n0[o];
        m = a.m0[o];
      } else {
        const size_t o = (row - 1) * D + j;
        c = a.cnm[o];
        n = a.cnm[bsd + o];
        m = a.cnm[2 * bsd + o];
      }
      float dc = g_s[p], dn = g_s[BU + p], dm = g_s[2 * BU + p];
      const float dh = a.d_hs[row * D + j] + g_s[3 * BU + p];
      float dg[4];
      cell_backward(g, c, n, m, dh, dc, dn, dm, dg);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dpre_s[b * C + 4 * u + q] = dg[q];
        a.d_pre[row * 4 * D + q * D + j] = dg[q];
      }
      g_s[p] = dc;
      g_s[BU + p] = dn;
      g_s[2 * BU + p] = dm;
    }
    __syncthreads();
    // (2) this block's partial of d h_{t-1} over its own columns, all D entries
    float* part = a.part + (size_t)(t & 1) * G * B * D;
    float* mine = part + (size_t)blockIdx.x * B * D;
    for (int x = tid; x < B * D; x += kThreads) {
      const int b = x / D, i = x - b * D, hd = i / dh, k = i - hd * dh;
      const float* dp = dpre_s + b * C;
      float acc = 0.f;
      for (int e = start_s[hd]; e < start_s[hd + 1]; ++e) {
        const int c = order_s[e];
        acc = fmaf(dp[c], r_s[c * ld + k], acc);
      }
      mine[x] = acc;
    }
    grid.sync();  // every block's partial written
    // (3) own units' d h_{t-1}: the blocks' partials in a fixed order.  P
    // pairs at a time, T threads a pair, each over blocks sl, sl + T, ...
    // with kInFlight loads in flight, then the T slices folded in order.
    for (int p0 = 0; p0 < BU; p0 += P) {
      const int p = p0 + tid % P, sl = tid / P;
      if (sl < T) {
        const int b = p / U, j = j0 + p % U;
        float acc = 0.f;
        if (p < BU && j < D) {
          for (int blk0 = sl; blk0 < G; blk0 += kInFlight * T) {
            float v[kInFlight];
#pragma unroll
            for (int q = 0; q < kInFlight; ++q) {
              const int blk = blk0 + q * T;
              v[q] = blk < G ? __ldcg(part + ((size_t)blk * B + b) * D + j) : 0.f;
            }
#pragma unroll
            for (int q = 0; q < kInFlight; ++q) acc += v[q];
          }
        }
        red_s[sl * P + tid % P] = acc;
      }
      __syncthreads();
      if (tid < P && p0 + tid < BU) {
        float acc = 0.f;
        for (int s2 = 0; s2 < T; ++s2) acc += red_s[s2 * P + tid];
        g_s[3 * BU + p0 + tid] = acc;
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < BU; p += kThreads) {
    const int b = p / U, j = j0 + p % U;
    if (j < D) {
      const size_t o = (size_t)b * D + j;
      a.d_c0[o] = g_s[p];
      a.d_n0[o] = g_s[BU + p];
      a.d_m0[o] = g_s[2 * BU + p];
      a.d_h0[o] = g_s[3 * BU + p];
    }
  }
}

// A grid of the forward's shape that only crosses `syncs` barriers: the
// barrier's own cost, beside the scan's time a step.
__global__ void __launch_bounds__(kThreads) slstm_barrier_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

int make_plan(int B, int D, int NH, int backward, Plan* p) {
  *p = Plan{0, 0, 0, 0, 0, 0};
  if (B < 1 || D < 1 || NH < 1 || D % NH != 0) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return cudaErrorNotSupported;
  p->units = (D + p->sms - 1) / p->sms;
  p->grid = (D + p->units - 1) / p->units;
  p->batch_tile = B < kBatchTile ? B : kBatchTile;
  const long long words = backward ? backward_words(B, D, NH, p->units)
                                   : forward_words(B, D, NH, p->units, p->batch_tile);
  if (words * 4 > optin) {
    p->smem = words * 4 > 0x7fffffff ? 0x7fffffff : static_cast<int>(words * 4);
    return cudaErrorInvalidConfiguration;
  }
  p->smem = static_cast<int>(words * 4);
  const void* kernel = backward ? reinterpret_cast<const void*>(slstm_backward_kernel)
                                : reinterpret_cast<const void*>(slstm_forward_kernel);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, kernel, kThreads, p->smem);
  if (err != cudaSuccess) return err;
  if (p->per_sm * p->sms < p->grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

// The launch plan of the forward (backward = 0) or backward kernel at
// (B, D, NH) on the current device: out[0..5] = units a block, grid,
// batch tile, shared memory bytes, blocks an SM holds, SMs.  Returns
// cudaErrorInvalidConfiguration when a block's shared memory is over the
// opt-in limit and cudaErrorCooperativeLaunchTooLarge when the grid cannot
// be co-resident; out is filled as far as it was reckoned.
extern "C" int slstm_scan_plan(int B, int D, int NH, int backward, int* out) {
  Plan p;
  const int err = make_plan(B, D, NH, backward, &p);
  out[0] = p.units;
  out[1] = p.grid;
  out[2] = p.batch_tile;
  out[3] = p.smem;
  out[4] = p.per_sm;
  out[5] = p.sms;
  return err;
}

extern "C" int slstm_scan_forward(const float* wx, const float* r, const float* bias,
                                  const float* c0, const float* n0, const float* h0,
                                  const float* m0, float* hs, float* c, float* n, float* h,
                                  float* m, float* pre, float* cnm, int B, int S, int D, int NH,
                                  void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  Plan p;
  int err = make_plan(B, D, NH, 0, &p);
  if (err != cudaSuccess) return err;
  FwdArgs a{wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, B, S, D, NH, p.units,
            p.batch_tile};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_forward_kernel),
                                    dim3(p.grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// part: (2, blocks, B, D) float32 scratch with room for `blocks` blocks'
// partials; the plan's grid is at most min(D, SMs).
extern "C" int slstm_scan_backward(const float* d_hs, const float* d_c, const float* d_n,
                                   const float* d_h, const float* d_m, const float* r,
                                   const float* pre, const float* cnm, const float* c0,
                                   const float* n0, const float* m0, float* d_pre, float* d_c0,
                                   float* d_n0, float* d_h0, float* d_m0, float* part, int blocks,
                                   int B, int S, int D, int NH, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  Plan p;
  int err = make_plan(B, D, NH, 1, &p);
  if (err != cudaSuccess) return err;
  if (p.grid > blocks) return cudaErrorInvalidValue;  // the scratch is too small
  BwdArgs a{d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0,
            d_pre, d_c0, d_n0, d_h0, d_m0, part, B, S, D, NH, p.units};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_backward_kernel),
                                    dim3(p.grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `syncs` grid barriers on the forward's grid, threads and shared memory at
// (B, D, NH): what the scan pays a step for its barrier alone.
extern "C" int slstm_barrier_probe(int B, int D, int NH, int syncs, void* stream) {
  Plan p;
  int err = make_plan(B, D, NH, 0, &p);
  if (err != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(slstm_barrier_kernel);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&syncs};
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
