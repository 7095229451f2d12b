#!/usr/bin/env python3
"""Where the Ising-energy kernel's time goes, on the card.

    python3 tools/energy_trace.py

Builds two libraries from the checkout's
``src/repro_torch/kernels/csrc/ising_energy.cu`` into
``build/trace/energy/``: the unmodified source, and a copy that stamps
``clock64()`` at the phase boundaries of thread 0 of block (0, 0):

  * ``staging`` -- from the kernel's first line to the barrier after which
    the block's operands are in shared memory (the live-extent kernel: J's
    live corner by cp.async, h and the spins; the padded kernel: the spins);
  * ``chain`` -- the thread's k chains (the padded kernel reads J from
    global memory inside them);
  * ``densities`` -- the lane densities into shared memory and the barrier;
  * ``row sum`` -- row 0's sum over the lanes, in order.

It knows two layouts of the source and stamps whichever it finds: ``live``
(the kernel that reads the live extent in place, any n and R, int8 or
float32 spins) and ``padded`` (the first port's: tile-aligned float32
operands, one block of 8 rows and 128 threads a lane, J read from global
memory in the chain).  To trace the kernel a change started from, unpack
the parent with ``git archive`` into ``build/parent``, copy this file into
its ``tools/`` and run that copy.

Shapes, each as that layout's C entry takes it: ``main`` -- 8 reads of a
20-spin chip-range integer instance (int8 spins and the unpadded h and J
for ``live``; zero-padded to 128 float32 lanes for ``padded``);
``n 128`` -- R 8 on 128 float32 lanes; ``stack`` -- the farm's two-launch
stack, 96 jobs x 8 reads x 128 lanes; ``floor`` -- the smallest shape the
entry takes (R 1, n 1; R 8, n 8).

For each it prints the kernel's device time a launch under torch.profiler
(CUPTI, 200 launches of the unstamped library), the stamped cycles of each
phase (the median of 50 launches) and their sum, that sum at the card's
maximum SM clock, and what the device time holds beyond it (the launch,
the block's start and the last store's drain).  The stamps read the clock
in an asm that takes the phase's last result as an operand; they cost a
few cycles each, and the compiler may still move work that does not feed a
stamp across one, so a phase's cycles are approximate and the device time
is the firm number.  Exits naming the line if the source has neither
layout's lines.

Prints the card and its power limit first.  Needs the CUDA toolkit and a
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "trace" / "energy"
TRACKED = "(blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)"
PHASES = ("staging", "chain", "densities", "row sum")

# A layout: the line that identifies it, its stamps as (text, "before" /
# "after", stamp index, a value the stamp waits for), and its row-sum store
# with the stamped version that replaces it (stamp 4 waits for the sum).
LAYOUTS = {
    "live": {
        "marker": "energy_kernel(const ST* __restrict__ spins",
        "stamps": [
            ("  // Everything the block reads is requested before the first FMA: J's\n",
             "before", 0, "0.0f"),
            ("    if (i < n) chain(", "before", 1, "0.0f"),
            ("    if (i < n) chain(jt + (t & 1) * jbuf + i, sp + k0, n, n4, min(kt, n - k0), acc);\n",
             "after", 2, "acc[kRows - 1]"),
            ("  if (i < rows) out[", "before", 3, "0.0f"),
        ],
        "store": ("  if (i < rows) out[(long long)b * r + row0 + i] = repro::row_sum(el + i * n4, n);\n",
                  "  if (i < rows) {\n    const float rs_ = repro::row_sum(el + i * n4, n);\n"
                  "    STAMP(4, rs_)\n    out[(long long)b * r + row0 + i] = rs_;\n  }\n"),
    },
    "padded": {
        "marker": "ising_energy_kernel(const float* __restrict__ spins",
        "stamps": [
            ("#pragma unroll\n  for (int rr = 0; rr < BR; ++rr) sp[rr * n + i] = spins[rr * n + i];\n",
             "before", 0, "0.0f"),
            ("  repro::lane_energies(sp, j, h[i], n, i, e);\n", "before", 1, "0.0f"),
            ("  repro::lane_energies(sp, j, h[i], n, i, e);\n", "after", 2, "e[BR - 1]"),
            ("  if (i < BR) out[i] = ", "before", 3, "0.0f"),
        ],
        "store": ("  if (i < BR) out[i] = repro::row_sum(el + i * n, n);\n",
                  "  if (i < BR) {\n    const float rs_ = repro::row_sum(el + i * n, n);\n"
                  "    STAMP(4, rs_)\n    out[i] = rs_;\n  }\n"),
    },
}


def layout_of(src: str) -> str:
    for name, lay in LAYOUTS.items():
        if lay["marker"] in src:
            return name
    sys.exit("energy_trace: the kernel source has neither the live-extent nor the padded "
             "kernel's signature")


def instrumented(src: str, lay: dict) -> str:
    """The source with stamps g_trace[k] in the tracked thread."""
    for text, where, k, dep in lay["stamps"]:
        if src.count(text) != 1:
            sys.exit(f"energy_trace: the kernel source changed; no single {text.strip()!r} to stamp")
        stamp = f"  STAMP({k}, {dep})\n"
        src = src.replace(text, stamp + text if where == "before" else text + stamp)
    store, stamped = lay["store"]
    if src.count(store) != 1:
        sys.exit(f"energy_trace: the kernel source changed; no single {store.strip()!r} to stamp")
    src = src.replace(store, stamped)
    macro = ("__device__ long long g_trace[5];\n"
             "#define STAMP(k, dep) { long long clk_; asm volatile(\"mov.u64 %0, %%clock64;\" "
             ": \"=l\"(clk_) : \"f\"(dep) : \"memory\"); if " + TRACKED + " g_trace[k] = clk_; }\n")
    src = src.replace('#include "ising_energy.cuh"\n', '#include "ising_energy.cuh"\n' + macro, 1)
    return src + ('\nextern "C" int read_trace(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n")


def build(out: Path, src: str, argtypes, traced: bool):
    """Write ``src`` beside a copy of the header into ``out``, build it and
    load the library."""
    import torch  # noqa: F401  (CUDA runtime loaded before the library)

    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "ising_energy.cuh", out / "ising_energy.cuh")
    (out / "ising_energy.cu").write_text(src)
    lib_path = out / "ising_energy.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "ising_energy.cu")], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"energy_trace: nvcc failed:\n{done.stdout[-4000:]}{done.stderr[-4000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {'traced' if traced else 'plain'}: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.ising_energy.argtypes = argtypes
    if traced:
        lib.read_trace.argtypes = [ctypes.c_void_p]
    return lib


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("energy_trace: torch.cuda.is_available() is False: it needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    ghz = float(card.split(",")[-1]) / 1e3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (CSRC / "ising_energy.cu").read_text()
    name = layout_of(src)
    lay = LAYOUTS[name]
    print(f"layout: {name} ({CSRC / 'ising_energy.cu'})")
    argtypes = _build._ARGTYPES["ising_energy"]["ising_energy"]
    plain = build(OUT / name / "plain", src, argtypes, traced=False)
    traced = build(OUT / name / "traced", instrumented(src, lay), argtypes, traced=True)

    dev = torch.device("cuda")
    g = np.random.default_rng(0)

    def operands(b: int, r: int, n: int, live: int, int8: bool):
        """Spins (B, R, n), h (B, n), J (B, n, n): chip-range integer
        instances of ``live`` spins, zero past them."""
        j = np.zeros((b, n, n), np.float32)
        h = np.zeros((b, n), np.float32)
        s = np.zeros((b, r, n), np.float32)
        up = np.triu(g.integers(-14, 15, (b, live, live)), 1)
        j[:, :live, :live] = up + up.transpose(0, 2, 1)
        h[:, :live] = g.integers(-14, 15, (b, live))
        s[:, :, :live] = np.where(g.random((b, r, live)) < 0.5, 1, -1)
        t = lambda a: torch.tensor(a, device=dev)
        return t(s.astype(np.int8) if int8 else s), t(h), t(j)

    if name == "live":
        shapes = {"main": (1, 8, 20, 20, True), "n 128": (1, 8, 128, 128, False),
                  "stack": (96, 8, 128, 128, False), "floor": (1, 1, 1, 1, True)}
    else:
        shapes = {"main": (1, 8, 128, 20, False), "n 128": (1, 8, 128, 128, False),
                  "stack": (96, 8, 128, 128, False), "floor": (1, 8, 8, 8, False)}
    for label, (b, r, n, live, int8) in shapes.items():
        s, h, j = operands(b, r, n, live, int8)
        out = torch.empty((b, r), device=dev)
        stream = _build.stream_of(s)
        if name == "live":
            args = (s.data_ptr(), int(int8), h.data_ptr(), j.data_ptr(), out.data_ptr(), b, r, n,
                    s.stride(0), s.stride(1), h.stride(0), j.stride(0), j.stride(1), stream)
        else:
            args = (s.data_ptr(), h.data_ptr(), j.data_ptr(), out.data_ptr(), b, r, n, stream)

        def launch(lib):
            _build.check(lib.ising_energy(*args), "ising_energy")

        launch(plain)
        torch.cuda.synchronize()
        want = out.clone()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                launch(plain)
            torch.cuda.synchronize()
        dev_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA) / 200
        stamps = []
        for _ in range(50):
            launch(traced)
            torch.cuda.synchronize()
            tr = np.zeros(5, np.int64)
            _build.check(traced.read_trace(tr.ctypes.data), "read_trace")
            stamps.append(np.diff(tr))
        if not torch.equal(out, want):
            sys.exit(f"energy_trace: the stamped kernel's energies differ from the plain one's ({label})")
        med = np.median(np.array(stamps), axis=0)
        total = float(med.sum())
        print(f"{label} (B {b}, R {r}, n {n}, {live} live, {'int8' if int8 else 'float32'} spins): "
              f"device {dev_us:.3f} us a launch (profiler); stamped cycles "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, med))
              + f"; sum {total:.0f} = {total / ghz / 1e3:.3f} us at {ghz:.2f} GHz, "
              f"{dev_us - total / ghz / 1e3:.3f} us of the device time outside them")


if __name__ == "__main__":
    main()
