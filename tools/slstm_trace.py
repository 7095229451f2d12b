#!/usr/bin/env python3
"""Where a step of the sLSTM scan kernels goes on the card, and what the
layout choices of ``csrc/slstm_scan.cu`` buy.

    python3 tools/slstm_trace.py                        # this checkout's kernels
    python3 tools/slstm_trace.py --parent build/parent  # the kernels of a parent checkout

At xlstm-1.3b's call (B 2 x S 2,048, D 2,048, NH 4, float32; r at fan-in
dh, inputs from a generator seeded 0 on the card) it builds libraries from
patched copies of the kernel source into ``build/trace/slstm/`` (one
``nvcc`` a copy, all started together) and, for each, holds the forward
against ``slstm_scan_plain`` (2e-5 over every step, saved pre-activations
and states included) and the backward against ``slstm_scan_backward_plain``
(1e-4 of each output's largest magnitude), times both (CUDA events), runs
their timed instances once (each phase's mean ns a step in block 0 and in
the block that arrived last, ``slstm_scan.read_split``) and prints ptxas's
registers and spills.

This checkout's source, in four builds, timed in turns (a b c d d c b a):

  * ``shipped``: the source as it is;
  * ``t512``: 512 threads a block, 4 lines of r a warp, 4 polls a row (64
    words of r a thread, at most 128 registers);
  * ``guarded``: the instance that carries the guarded products beside the
    unguarded ones (``exact_tiling`` false);
  * ``polls_early``: without the block barrier after the gates (the
    backward's cell phase), so the warps idle there poll while they run
    (the forward's wx copy then waits for the gather's barrier, the first
    point where the gates' buffer is free).

With ``--parent DIR``: the kernels of the checkout at DIR (the grid-barrier
design this source replaced, as at commit ff7411b: ``grid.sync()`` every
step, r in shared memory, the backward's partials folded after the
barrier), stamped by PARENT_STAMPS
into a timed instance of the same kind (the same buffer, read by
``read_split``), beside the unstamped kernels' times and the grid barrier's
own cost (``slstm_barrier_probe``).  Unpack the parent with ``git archive
<commit> | tar -x -C build/parent``.  Exits naming the text it cannot find.

Prints the card and its power limit first.  Needs the CUDA toolkit and a
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import slstm_scan as ks  # noqa: E402

OUT = ROOT / "build" / "trace" / "slstm"
SOURCE = Path("src/repro_torch/kernels/csrc/slstm_scan.cu")
B, S, D, NH = 2, 2048, 2048, 4

# The layout variants of this checkout's source: {name: {text: replacement}}.
T512 = {"constexpr int kThreads = 256;": "constexpr int kThreads = 512;",
        "constexpr int kLines = 8;": "constexpr int kLines = 4;",
        "constexpr int kPoll = 8;": "constexpr int kPoll = 4;"}
GUARDED = {"  return B % kRows == 0 && t.kl == kSeg": "  return false && t.kl == kSeg"}
POLLS_EARLY = {
    "    // No thread polls for h_t before this block has published its own (the\n"
    "    // polls of the warps idle during the gates would only load L2), and\n"
    "    // the next step's fetch_wx may overwrite the wx the gates just read.\n"
    "    __syncthreads();\n": "",
    "    __syncthreads();  // no polling before own d pre_t is published\n": "",
    # the barrier also guards the forward's wx buffer: copy after the gather
    "    if (t + 1 < S) fetch_wx(t + 1);  // its buffer's last reader, step t - 1's gates, is done\n"
    "    else cp_async_commit();\n": "",
    "        if (tid == 0 && t > 0) *so.ticket(t - 1) = ticket;\n      }\n":
    "        if (tid == 0 && t > 0) *so.ticket(t - 1) = ticket;\n      }\n"
    "      if (b0 == 0) {\n        if (t + 1 < S) fetch_wx(t + 1);\n        else cp_async_commit();\n      }\n",
}
VARIANTS = {"shipped": {}, "t512": T512, "guarded": GUARDED, "polls_early": POLLS_EARLY}

# The parent's stamps: a timed instance (template kTimed) of each kernel that
# stamps clock64 at its step's phase boundaries in thread 0 of every block
# (forward: barrier, h staging, products, wx load, gates, h write; backward:
# cell gradient, partial write, barrier, fold), takes an arrival ticket
# before the grid barrier (thread 32, whose warp does no stamping), and the
# C entries that launch it.
_HELPERS = '''// The timed instances' clocks and buffer (as the redesign's SplitOut).
__device__ __forceinline__ long long clock_after(float v) {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) : "f"(v) : "memory");
  return c;
}
__device__ __forceinline__ long long clock_now() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
  return c;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
constexpr int kPhases = 8;
struct SplitOut {
  unsigned long long* base;
  int S, G;
  __device__ unsigned long long* counter(int t) const { return base + t; }
  __device__ unsigned long long* ticket(int x, int t) const { return base + S + (size_t)x * S + t; }
  __device__ unsigned long long* phases(int x, int t) const {
    return base + S + (size_t)G * S + ((size_t)x * S + t) * kPhases;
  }
  __device__ unsigned long long* clocks(int x) const {
    return base + S + (size_t)G * S * (1 + kPhases) + (size_t)x * 4;
  }
};

__device__ __forceinline__ float sigmoid_(float x)'''
_ENTRIES = '''}  // namespace

template <bool kTimed>
static int set_smem(int backward, int smem) {
  const void* k = backward ? reinterpret_cast<const void*>(slstm_backward_kernel<kTimed>)
                           : reinterpret_cast<const void*>(slstm_forward_kernel<kTimed>);
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int slstm_forward_split(const float* wx, const float* r, const float* bias,
                                   const float* c0, const float* n0, const float* h0,
                                   const float* m0, float* hs, float* c, float* n, float* h,
                                   float* m, float* pre, float* cnm, int B, int S, int D, int NH,
                                   void* split, void* stream) {
  Plan p;
  int err = make_plan(B, D, NH, 0, &p);
  if (err != cudaSuccess) return err;
  err = set_smem<true>(0, p.smem);
  if (err != cudaSuccess) return err;
  FwdArgs a{wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm,
            static_cast<unsigned long long*>(split), B, S, D, NH, p.units, p.batch_tile};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_forward_kernel<true>),
                                    dim3(p.grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int slstm_backward_split(const float* d_hs, const float* d_c, const float* d_n,
                                    const float* d_h, const float* d_m, const float* r,
                                    const float* pre, const float* cnm, const float* c0,
                                    const float* n0, const float* m0, float* d_pre, float* d_c0,
                                    float* d_n0, float* d_h0, float* d_m0, float* part,
                                    int blocks, int B, int S, int D, int NH, void* split,
                                    void* stream) {
  Plan p;
  int err = make_plan(B, D, NH, 1, &p);
  if (err != cudaSuccess) return err;
  if (p.grid > blocks) return cudaErrorInvalidValue;
  err = set_smem<true>(1, p.smem);
  if (err != cudaSuccess) return err;
  BwdArgs a{d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0, d_pre, d_c0, d_n0, d_h0, d_m0,
            part, static_cast<unsigned long long*>(split), B, S, D, NH, p.units};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_backward_kernel<true>),
                                    dim3(p.grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The launch plan'''
PARENT_STAMPS = [
    ("__device__ __forceinline__ float sigmoid_(float x)", _HELPERS),
    # the forward
    ("  float* cnm;  // (3, B, S, D) c, n, m after each step, or null\n  int B, S, D, NH, U, BT;",
     "  float* cnm;  // (3, B, S, D) c, n, m after each step, or null\n"
     "  unsigned long long* split;\n  int B, S, D, NH, U, BT;"),
    ("__global__ void __launch_bounds__(kThreads) slstm_forward_kernel(FwdArgs a) {\n"
     "  extern __shared__ float smem[];",
     "template <bool kTimed>\n__global__ void __launch_bounds__(kThreads) slstm_forward_kernel(FwdArgs a) {\n"
     "  extern __shared__ float smem[];\n  const SplitOut so{a.split, a.S, (int)gridDim.x};\n"
     "  long long st0 = 0, st1 = 0, st2 = 0, st3 = 0, st4 = 0, st5 = 0;"),
    ("  const size_t bsd = (size_t)B * S * D;\n  for (int t = 0; t < S; ++t) {\n"
     "    for (int b0 = 0; b0 < B; b0 += BT) {",
     "  if (kTimed && tid == 0) {\n    so.clocks(blockIdx.x)[0] = clock_now();\n"
     "    so.clocks(blockIdx.x)[1] = global_ns();\n  }\n"
     "  const size_t bsd = (size_t)B * S * D;\n  for (int t = 0; t < S; ++t) {\n"
     "    if (kTimed) st0 = clock_now();\n    for (int b0 = 0; b0 < B; b0 += BT) {"),
    ("        h_s[i] = __ldcg(src);\n      }\n      __syncthreads();\n",
     "        h_s[i] = __ldcg(src);\n      }\n      __syncthreads();\n      if (kTimed) st1 = clock_now();\n"),
    ("          if (lane == 0 && bb < bt) rec_s[bb * C + c] = v;\n        }\n      }\n      __syncthreads();\n",
     "          if (lane == 0 && bb < bt) rec_s[bb * C + c] = v;\n        }\n      }\n      __syncthreads();\n"
     "      if (kTimed) st2 = clock_now();\n"),
    ("          g[q] = (w[q * D + j] + rec_s[bb * C + 4 * u + q]) + a.bias[q * D + j];\n",
     "          g[q] = (w[q * D + j] + rec_s[bb * C + 4 * u + q]) + a.bias[q * D + j];\n"
     "        if (kTimed && p == 0) st3 = clock_after(g[0] + g[1] + g[2] + g[3]);\n"),
    ("        const float h1 = sigmoid_(g[3]) * c1 / fmaxf(n1, kNormFloor);\n",
     "        const float h1 = sigmoid_(g[3]) * c1 / fmaxf(n1, kNormFloor);\n"
     "        if (kTimed && p == 0) st4 = clock_after(h1);\n"),
    ("    if (t + 1 < S) grid.sync();  // h_t of every unit written\n  }\n",
     "    if (kTimed) st5 = clock_now();\n    unsigned long long ticket = 0;\n"
     "    if (kTimed && tid == 32) ticket = atomicAdd(so.counter(t), 1ull);\n"
     "    if (t + 1 < S) grid.sync();  // h_t of every unit written\n"
     "    if (kTimed && tid == 32) *so.ticket(blockIdx.x, t) = ticket;\n"
     "    if (kTimed && tid == 0) {\n      unsigned long long* ph = so.phases(blockIdx.x, t);\n"
     "      ph[0] = clock_now() - st5;\n      ph[1] = st1 - st0;\n      ph[2] = st2 - st1;\n"
     "      ph[3] = st3 - st2;\n      ph[4] = st4 - st3;\n      ph[5] = st5 - st4;\n    }\n  }\n"
     "  if (kTimed && tid == 0) {\n    so.clocks(blockIdx.x)[2] = clock_now();\n"
     "    so.clocks(blockIdx.x)[3] = global_ns();\n  }\n"),
    # the backward
    ("  float* part;        // (2, grid, B, D) scratch: the blocks' partials of d h\n  int B, S, D, NH, U;",
     "  float* part;        // (2, grid, B, D) scratch: the blocks' partials of d h\n"
     "  unsigned long long* split;\n  int B, S, D, NH, U;"),
    ("__global__ void __launch_bounds__(kThreads) slstm_backward_kernel(BwdArgs a) {\n"
     "  extern __shared__ float smem[];",
     "template <bool kTimed>\n__global__ void __launch_bounds__(kThreads) slstm_backward_kernel(BwdArgs a) {\n"
     "  extern __shared__ float smem[];\n  const SplitOut so{a.split, a.S, (int)gridDim.x};\n"
     "  long long st0 = 0, st1 = 0, st2 = 0, st3 = 0;"),
    ("  for (int t = S - 1; t >= 0; --t) {\n",
     "  if (kTimed && tid == 0) {\n    so.clocks(blockIdx.x)[0] = clock_now();\n"
     "    so.clocks(blockIdx.x)[1] = global_ns();\n  }\n"
     "  for (int t = S - 1; t >= 0; --t) {\n    if (kTimed) st0 = clock_now();\n"),
    ("      g_s[2 * BU + p] = dm;\n    }\n    __syncthreads();\n",
     "      g_s[2 * BU + p] = dm;\n    }\n    __syncthreads();\n    if (kTimed) st1 = clock_now();\n"),
    ("    grid.sync();  // every block's partial written\n",
     "    if (kTimed) st2 = clock_now();\n    unsigned long long ticket = 0;\n"
     "    if (kTimed && tid == 32) ticket = atomicAdd(so.counter(S - 1 - t), 1ull);\n"
     "    grid.sync();  // every block's partial written\n"
     "    if (kTimed && tid == 32) *so.ticket(blockIdx.x, S - 1 - t) = ticket;\n"
     "    if (kTimed) st3 = clock_now();\n"),
    ("        g_s[3 * BU + p0 + tid] = acc;\n      }\n      __syncthreads();\n    }\n  }\n",
     "        g_s[3 * BU + p0 + tid] = acc;\n      }\n      __syncthreads();\n    }\n"
     "    if (kTimed && tid == 0) {\n      unsigned long long* ph = so.phases(blockIdx.x, S - 1 - t);\n"
     "      ph[0] = st1 - st0;\n      ph[1] = st2 - st1;\n      ph[2] = st3 - st2;\n"
     "      ph[3] = clock_now() - st3;\n    }\n  }\n"
     "  if (kTimed && tid == 0) {\n    so.clocks(blockIdx.x)[2] = clock_now();\n"
     "    so.clocks(blockIdx.x)[3] = global_ns();\n  }\n"),
    # the plan and the entries: the untimed instances where the kernels were
    ("  const void* kernel = backward ? reinterpret_cast<const void*>(slstm_backward_kernel)\n"
     "                                : reinterpret_cast<const void*>(slstm_forward_kernel);",
     "  const void* kernel = backward ? reinterpret_cast<const void*>(slstm_backward_kernel<false>)\n"
     "                                : reinterpret_cast<const void*>(slstm_forward_kernel<false>);"),
    ("}  // namespace\n\n// The launch plan", _ENTRIES),
    ("  FwdArgs a{wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, B, S, D, NH, p.units,",
     "  FwdArgs a{wx, r, bias, c0, n0, h0, m0, hs, c, n, h, m, pre, cnm, nullptr, B, S, D, NH, p.units,"),
    ("  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_forward_kernel),",
     "  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_forward_kernel<false>),"),
    ("            d_pre, d_c0, d_n0, d_h0, d_m0, part, B, S, D, NH, p.units};",
     "            d_pre, d_c0, d_n0, d_h0, d_m0, part, nullptr, B, S, D, NH, p.units};"),
    ("  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_backward_kernel),",
     "  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_backward_kernel<false>),"),
]
PARENT_PHASES = {"forward": ("barrier", "h staging", "products", "wx load", "gates", "h write"),
                 "backward": ("cell gradient", "partial write", "barrier", "fold")}
P, I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGTYPES = {
    "slstm_scan_plan": [I, I, I, I, P],
    "slstm_scan_forward": [P] * 14 + [I] * 4 + [P],
    "slstm_scan_backward": [P] * 17 + [I] * 5 + [P],
    "slstm_forward_split": [P] * 14 + [I] * 4 + [P, P],
    "slstm_backward_split": [P] * 17 + [I] * 5 + [P, P],
    "slstm_barrier_probe": [I, I, I, I, P],
}


def patched(src: str, subs, label: str) -> str:
    for old, new in (subs.items() if isinstance(subs, dict) else subs):
        if old not in src:
            sys.exit(f"slstm_trace: {label}: the source has no {old.splitlines()[0]!r}")
        src = src.replace(old, new, 1)
    return src


def build(sources: dict[str, str], argtypes: dict) -> dict[str, ctypes.CDLL]:
    """One nvcc a source, all at once; ptxas's registers and spills of each
    scan kernel printed; the libraries loaded with their entries typed."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"slstm_trace: nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and ("forward_kernel" in line or "backward_kernel" in line):
                kind = "forward" if "forward_kernel" in line else "backward"
                inst = line.split(f"slstm_{kind}_kernel")[1].split("EEvNS")[0]
                info = " | ".join(x.strip().removeprefix("ptxas info    : ") for x in lines[i + 1:i + 4]
                                  if "spill" in x or "registers" in x)
                print(f"  {name} {kind} {inst}: {info}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_split(label: str, split: dict) -> None:
    for who, name in (("block0", "block 0"), ("last", "last to arrive")):
        print(f"    {label} split, {name}, ns a step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in split[who].items())
              + f"; sum {split[who + '_sum']:.1f} (SM clock {split['ghz']:.3f} GHz)")


def inputs(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    dh = D // NH
    wx = torch.randn((B, S, 4 * D), generator=g, device=dev)
    r = torch.randn((NH, dh, 4 * dh), generator=g, device=dev) * dh ** -0.5
    bias = torch.randn(4 * D, generator=g, device=dev)
    z = torch.zeros((B, D), device=dev)
    state = (z, z + 1e-6, z.clone(), z.clone())
    fwd = ks.slstm_scan_plain(wx, r, bias, *state, save=True)
    d_hs = torch.randn((B, S, D), generator=g, device=dev)
    d_fin = [torch.randn((B, D), generator=g, device=dev) for _ in range(4)]
    bwd_args = (d_hs, *d_fin, r, fwd[5], fwd[6], state[0], state[1], state[3])
    return (wx, r, bias, *state), fwd, bwd_args, ks.slstm_scan_backward_plain(*bwd_args)


def check(label, got_f, want_f, got_b, want_b) -> None:
    fwd_err = max(float((x - y).abs().max()) for x, y in zip(got_f, want_f))
    bwd_rel = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(got_b[:4], want_b[:4]))
    ok = fwd_err <= 2e-5 and bwd_rel <= 1e-4
    print(f"    {label}: forward max abs err {fwd_err:.3e} (bar 2e-5), backward max rel err "
          f"{bwd_rel:.3e} (bar 1e-4, d_m0 aside){'' if ok else '  FAILED'}")
    if not ok:
        sys.exit(f"slstm_trace: {label} disagrees with the plain versions")


def current(dev) -> None:
    src = (ROOT / SOURCE).read_text()
    libs = build({name: patched(src, subs, name) for name, subs in VARIANTS.items()},
                 _build._ARGTYPES["slstm_scan"])
    fwd_in, want_f, bwd_args, want_b = inputs(dev)
    for name in list(libs) + list(libs)[::-1]:
        _build._LIBS["slstm_scan"] = libs[name]
        f_ms = cuda_ms(lambda: ks.slstm_scan_cuda(*fwd_in), reps=10)
        b_ms = cuda_ms(lambda: ks.slstm_scan_backward_cuda(*bwd_args), reps=5)
        x_ms = cuda_ms(lambda: ks.exchange_probe(B, D, NH, S), reps=5)
        print(f"  {name} (plan exact {ks.plan(B, D, NH)['exact']}): forward {f_ms:.4f} ms "
              f"({f_ms * 1e3 / S:.3f} us a step), backward {b_ms:.4f} ms ({b_ms * 1e3 / S:.3f} us a "
              f"step), the exchange alone {x_ms * 1e3 / S:.3f} us a round", flush=True)
        check(name, ks.slstm_scan_cuda(*fwd_in, save=True), want_f,
              ks.slstm_scan_backward_cuda(*bwd_args), want_b)
        for backward, args in ((False, (*fwd_in, False)), (True, bwd_args)):
            print_split("backward" if backward else "forward", ks.step_split(backward, *args)[0])


def parent(root: Path, dev) -> None:
    src = (root / SOURCE).read_text()
    lib = build({"parent": patched(src, PARENT_STAMPS, "parent")}, PARENT_ARGTYPES)["parent"]
    fwd_in, want_f, bwd_args, want_b = inputs(dev)
    stream = _build.stream_of(fwd_in[0])
    out = (ctypes.c_int * 6)()
    _build.check(lib.slstm_scan_plan(B, D, NH, 0, ctypes.addressof(out)), "plan")
    grid = out[1]
    blocks = min(D, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((2, blocks, B, D), device=dev)
    fo = [torch.empty_like(t) for t in want_f]
    bo = [torch.empty_like(t) for t in want_b]

    def forward(split=None, save=True):
        _build.check((lib.slstm_forward_split if split is not None else lib.slstm_scan_forward)(
            *(t.data_ptr() for t in fwd_in), *(t.data_ptr() for t in fo[:5]),
            fo[5].data_ptr() if save else None, fo[6].data_ptr() if save else None, B, S, D, NH,
            *(() if split is None else (split.data_ptr(),)), stream), "forward")

    def backward(split=None):
        _build.check((lib.slstm_backward_split if split is not None else lib.slstm_scan_backward)(
            *(t.data_ptr() for t in bwd_args), *(t.data_ptr() for t in bo), part.data_ptr(),
            blocks, B, S, D, NH, *(() if split is None else (split.data_ptr(),)), stream), "backward")

    f_ms = cuda_ms(lambda: forward(save=False), reps=10)
    b_ms = cuda_ms(backward, reps=5)
    bar_ms = cuda_ms(lambda: _build.check(lib.slstm_barrier_probe(B, D, NH, S, stream), "barrier"), reps=5)
    print(f"  parent: forward {f_ms:.4f} ms ({f_ms * 1e3 / S:.3f} us a step), backward {b_ms:.4f} ms "
          f"({b_ms * 1e3 / S:.3f} us a step), the grid barrier alone {bar_ms * 1e3 / S:.3f} us a sync")
    forward()
    backward()
    check("parent", fo, want_f, bo, want_b)
    for which, run in (("forward", forward), ("backward", backward)):
        buf = torch.zeros(ks.split_words(S, grid), dtype=torch.int64, device=dev)
        run(buf)
        print_split(which, ks.read_split(buf.cpu().numpy(), S, grid, PARENT_PHASES[which]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent (its kernels, stamped)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if not torch.cuda.is_available():
        sys.exit("slstm_trace: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"B {B} S {S} D {D} NH {NH} float32, r at fan-in {D // NH}")
    if args.parent:
        parent(args.parent.resolve(), dev)
    else:
        current(dev)


if __name__ == "__main__":
    main()
