#!/usr/bin/env python3
"""The float32 flash route on the card, beside its bounds and SDPA in float32.

    python3 tools/flash_f32_time.py

At the encoder stage's 2048 bucket (B 8, S 2048, 12 heads of 64) and at
qwen2-moe-a2.7b's call (B 8, S 2048, 16 heads of 128), float32, causal:
the float32 route's kernel from its C entry and through
``flash_attention_cuda`` (CUDA events; the route the wrapper took, by its
launch counts), its max error against ``flash_attention_plain``, the plain
version's time, and ``scaled_dot_product_attention`` in float32 with its
backend pinned to EFFICIENT_ATTENTION (the device kernels it ran, by name
under torch.profiler, and its own max error against the plain version),
each with its TFLOP/s, beside three bounds: the FLOP at the CUDA cores'
float32 rate (67 TFLOP/s), three split-TF32 passes of them at the tensor
cores' TF32 rate (494.7 TFLOP/s), and q, k, v and o once each at 3.35 TB/s
(NVIDIA's H100 SXM data sheet, dense).  The FLOP are 4 B H D a causal
(query, key) pair, S (S + 1) / 2 pairs.  TF32 is off in PyTorch's products.

It imports the first ``repro_torch`` on the path and knows both C entries
of the float32 route, ``flash_attention_tf32`` and the FMA kernel's
``flash_attention`` that it replaced, so parent against change is one call:
``for p in build/parent/src src src build/parent/src; do PYTHONPATH=$p
python3 tools/flash_f32_time.py; done``.  Prints the card and its power
limit first and a JSON line of the numbers last.  ``--sass`` also prints
each float32 instance's static instruction mix from ``cuobjdump``: the
count of each opcode and the other instructions per HMMA.  ``--mma-peak``
also builds a probe into ``build/trace/`` and times back-to-back
``mma.sync.m16n8k8`` TF32 products (8 independent accumulators a warp, 8
warps a block, 4 blocks an SM): the rate the split-TF32 kernel's products
can reach at most.  Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

SHAPES = (("stage", 8, 2048, 12, 64), ("qwen2-moe-a2.7b", 8, 2048, 16, 128))
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 494.7e12, 3.35e12


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds a call (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_mix(lib_path, entry_name: str) -> None:
    """Each float32 instance of the route's kernel: its opcodes by count."""
    import collections
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    kernel = "flash_attention_tf32_kernelIf" if entry_name.endswith("tf32") else \
        "flash_attention_kernelIf"
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = collections.Counter(
            m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                                            part))
        mma = ops.get("HMMA", 0)
        total = sum(ops.values())
        print(f"sass {name}: {total} instructions, HMMA {mma}, others per HMMA "
              f"{(total - mma) / mma if mma else float('nan'):.2f}; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(16)))


MMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  float c[8][4];
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  const uint32_t x = 0x3F800000u + (threadIdx.x << 13);  // TF32 values near 1
  const uint32_t a[4] = {x, x ^ 0x2000u, x, x ^ 0x4000u}, b[2] = {x ^ 0x6000u, x};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float sum = 0.0f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) sum += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_peak_run(float* out, int blocks, int iters, void* stream) {
  mma_peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_peak() -> None:
    """TFLOP/s of back-to-back TF32 mma.sync on this card (CUDA events)."""
    import ctypes

    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_peak.cu", out_dir / "mma_peak.so"
    src.write_text(MMA_PEAK_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    ms = cuda_ms(lambda: _build.check(lib.mma_peak_run(out.data_ptr(), blocks, iters,
                                                       _build.stream_of(out)), "mma_peak"),
                 reps=5)
    flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    print(f"mma.sync m16n8k8 TF32 peak: {flops / ms / 1e9:.1f} TFLOP/s ({blocks} blocks of 8 "
          f"warps, {iters} x 8 products a warp, {ms:.4f} ms; {sms} SMs)")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_f32_time: needs a CUDA device")
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"repro_torch: {fa.__file__}")
    entries = _build._ARGTYPES["flash_attention"]
    entry_name = "flash_attention_tf32" if "flash_attention_tf32" in entries else "flash_attention"
    entry = getattr(_build.library("flash_attention"), entry_name)
    if "--mma-peak" in sys.argv[1:]:
        mma_peak()
    if "--sass" in sys.argv[1:]:
        sass_mix(_build.build_all(("flash_attention",))["flash_attention"], entry_name)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for label, b, s, h, d in SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev) for _ in range(3))
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, s, h, h, d, 0, 1,
                0, 0, d**-0.5, _build.stream_of(q))
        entry_ms = cuda_ms(lambda: _build.check(entry(*args), entry_name), reps=10)
        before = dict(fa.flash_attention_cuda.route_launches)
        got = fa.flash_attention_cuda(q, k, v)
        route = [r for r, n in fa.flash_attention_cuda.route_launches.items() if n > before[r]]
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=10)
        want = fa.flash_attention_plain(q, k, v)
        err = float((got - want).abs().max())
        entry_err = float((o - want).abs().max())
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            ref = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
            sdpa_err = float((ref - want).abs().max())
            lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=10)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    sdpa(qt, kt, vt, is_causal=True)
                torch.cuda.synchronize()
        # The profiler has returned no kernel for this call in some runs.
        sdpa_kernels = sorted(ev.key for ev in prof.key_averages()
                              if ev.device_type == torch.autograd.DeviceType.CUDA
                              and ev.self_device_time_total > 0) or ["not recorded by the profiler"]
        flops = 4 * b * h * d * (s * (s + 1) // 2)
        nbytes = 4 * q.numel() * q.element_size()
        row = {"at": f"{label} B={b} S={s} H={h} D={d} float32 causal", "entry": entry_name,
               "route": route, "entry_ms": entry_ms, "ms": ms, "max_abs_err": err,
               "entry_max_abs_err": entry_err, "plain_ms": plain_ms,
               "sdpa_backend": "EFFICIENT_ATTENTION", "sdpa_kernels": sdpa_kernels,
               "sdpa_ms": lib_ms, "sdpa_max_abs_err": sdpa_err, "gflop": flops / 1e9,
               "mb": nbytes / 1e6, "bound_cuda_core_ms": flops / PEAK_F32 * 1e3,
               "bound_split_tf32_ms": 3 * flops / PEAK_TF32 * 1e3,
               "bound_bytes_ms": nbytes / PEAK_BYTES * 1e3}
        rows.append(row)
        print(f"flash f32 {label} (B={b} S={s} H={h} D={d} causal): {entry_name} "
              f"{entry_ms:.4f} ms from its C entry ({flops / entry_ms / 1e9:.1f} TFLOP/s), "
              f"{ms:.4f} ms through the wrapper (route {route}), max err vs plain {err:.3e}; "
              f"plain {plain_ms:.4f} ms; sdpa (EFFICIENT_ATTENTION, {', '.join(sdpa_kernels)}) "
              f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), its max err vs plain "
              f"{sdpa_err:.3e}; bounds: CUDA cores {row['bound_cuda_core_ms']:.4f} ms, split "
              f"TF32 {row['bound_split_tf32_ms']:.4f} ms, bytes {row['bound_bytes_ms']:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, o, got, want, ref, qt, kt, vt
        torch.cuda.empty_cache()
    print(f"card: {card_line()}")
    print(json.dumps({"flash_f32": rows}))


if __name__ == "__main__":
    main()
