#!/usr/bin/env python3
"""Where the wgmma flash-attention kernel's time goes, on the card.

    python3 tools/flash_trace.py

1. Builds a copy of ``src/repro_torch/kernels/csrc/flash_attention.cu`` into
   ``build/trace/`` with ``clock64()`` stamps in the consumers' kv loop (CTA
   0's first work tile, the heaviest), runs it at the encoder stage's 2048
   bucket (B 8, S 2048, 12 heads of 64, bf16, causal) and at D 128 (8
   heads), and prints each consumer warpgroup's median cycles per kv
   iteration, split into: waiting for the tile, issuing S and the last
   P V, waiting for S, the softmax, waiting for P V, rescale and pack, the
   rest.  The stamps cost a few cycles each.
2. Times the unmodified kernel from its C entry at non-causal shapes with
   the same 1536 work tiles and 16, 4 and 1 kv tiles each, which separates
   the cost of a kv tile from the fixed cost of a work tile.

Prints the card and its power limit first.  Needs the CUDA toolkit and a
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "trace"


def instrumented_source() -> str:
    """The kernel source with stamps g_trace[consumer][iteration][k]."""
    src = SRC.read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            sys.exit(f"flash_trace: the kernel source changed; no single {old.strip()!r} to stamp")
        src = src.replace(old, new)

    def stamp(k: int) -> str:
        return f"if (blockIdx.x == 0 && t == 0 && w == 0 && it < 64) g_trace[c][it][{k}] = clock64();\n"

    sub("namespace wg {\n", "namespace wg {\n__device__ long long g_trace[2][64][8];\n")
    sub("        mbar_wait(full_bar + 8 * stage_of(it), parity_of(it));\n",
        "        " + stamp(7) + "        mbar_wait(full_bar + 8 * stage_of(it), parity_of(it));\n"
        "        " + stamp(0))
    sub("        wgmma_wait<1>();  // S of this kv tile is done; P V of the last still runs\n",
        "        " + stamp(1) + "        wgmma_wait<1>();\n        " + stamp(2))
    sub("        softmax(it);\n        wgmma_wait<0>();\n",
        "        softmax(it);\n        " + stamp(3) + "        wgmma_wait<0>();\n        " + stamp(4))
    sub("          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];\n        pack();\n",
        "          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];\n        pack();\n"
        "        " + stamp(5))
    return src + ('\nextern "C" int read_trace(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, wg::g_trace, sizeof(wg::g_trace));\n}\n")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_trace: torch.cuda.is_available() is False: it needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_trace.cu").write_text(instrumented_source())
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / "flash_trace.so"),
                            str(OUT / "flash_trace.cu")], capture_output=True, text=True)
    if build.returncode:
        sys.exit(f"flash_trace: nvcc failed:\n{build.stdout[-4000:]}{build.stderr[-4000:]}")
    traced = ctypes.CDLL(str(OUT / "flash_trace.so"))
    argtypes = _build._ARGTYPES["flash_attention"]["flash_attention_wgmma"]
    traced.flash_attention_wgmma.argtypes = argtypes
    traced.read_trace.argtypes = [ctypes.c_void_p]
    plain = _build.library("flash_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    def launch(lib, q, k, v, o, causal):
        b, s, h, d = q.shape
        err = lib.flash_attention_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                                        s, h, h, d, causal, 0, 0, d**-0.5, _build.stream_of(q))
        _build.check(err, "flash_attention_wgmma")

    parts = ["wait tile", "issue S + PV", "wait S", "softmax", "wait PV", "rescale + pack", "rest"]
    for b, s, h, d in ((8, 2048, 12, 64), (8, 2048, 8, 128)):
        q, k, v = inputs(b, s, h, d)
        o = torch.empty_like(q)
        for _ in range(3):
            launch(traced, q, k, v, o, 1)
        torch.cuda.synchronize()
        tr = np.zeros((2, 64, 8), np.int64)
        _build.check(traced.read_trace(tr.ctypes.data), "read_trace")
        n = s // 128  # kv tiles of the heaviest work tile
        print(f"trace B={b} S={s} H={h} D={d} bf16 causal, CTA 0's first work tile ({n} kv tiles), "
              f"median cycles per kv iteration 1..{n - 2}:")
        for c in range(2):
            x = tr[c, 1:n - 1]
            split = np.stack([x[:, 0] - x[:, 7], x[:, 1] - x[:, 0], x[:, 2] - x[:, 1],
                              x[:, 3] - x[:, 2], x[:, 4] - x[:, 3], x[:, 5] - x[:, 4],
                              tr[c, 2:n, 7] - x[:, 5]], axis=1)
            med = np.median(split, axis=0)
            total = float(np.median(np.diff(tr[c, 1:n, 7])))
            print(f"  consumer {c}: {total:.0f} cycles; "
                  + ", ".join(f"{p} {m:.0f}" for p, m in zip(parts, med)))

    def cuda_ms(fn, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times = {}
    for b, s in ((8, 2048), (32, 512), (128, 128)):
        q, k, v = inputs(b, s, 12, 64)
        o = torch.empty_like(q)
        times[s // 128] = cuda_ms(lambda: launch(plain, q, k, v, o, 0))
        flops = 4 * b * 12 * 64 * s * s
        print(f"shape B={b} S={s} H=12 D=64 bf16 full: {b * 12 * s // 128} work tiles of {s // 128} "
              f"kv tiles, {times[s // 128]:.4f} ms, {flops / times[s // 128] / 1e9:.1f} TFLOP/s")
    # t(n) = n * per_tile + fixed: each is a sum over the 1536 work tiles,
    # which the SMs share.
    per_tile = (times[16] - times[4]) / 12
    fixed = times[4] - 4 * per_tile
    waves = 1536 / torch.cuda.get_device_properties(0).multi_processor_count
    print(f"a kv tile of every work tile: {per_tile * 1e3:.2f} us ({per_tile * 1e3 / waves:.3f} us "
          f"per 128 x 128 tile on one SM); the fixed cost of every work tile: {fixed * 1e3:.2f} us "
          f"({fixed * 1e3 / waves:.3f} us per work tile on one SM)")


if __name__ == "__main__":
    main()
