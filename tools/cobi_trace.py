#!/usr/bin/env python3
"""Where the COBI anneal loop's time goes, on the card.

    python3 tools/cobi_trace.py

Builds two libraries from the repo's COBI sources
(``src/repro_torch/kernels/csrc``) into ``build/trace/``: the unmodified
``cobi_dynamics.cu``, and a copy whose Euler loop (``cobi_anneal.cuh``)
stamps ``clock64()`` at each step's phase boundaries in thread block (0, 0),
for thread 0 (a lane that does dot products) and for the block's last warp
(row 1, lanes 96..127: they do none once the live extent is at most 96):

  * ``sincos``  -- sincosf of the thread's phases and the [cos; sin] stores;
  * ``barrier`` -- the wait at the step's barrier;
  * ``dot``     -- the dot products against 2J;
  * ``update``  -- the phase update (and the loop's own overhead).

It runs the trajectory kernel at three shapes, at 400 steps:

  * direct: one instance, R 8, 128 lanes of which 20 are live (a random
    chip-range integer instance of 20 spins, scaled as the solver scales);
  * direct, J = 0: h on 20 spins and no couplings (live extent 0), so the
    loop does no dot products: what a step costs without them;
  * farm drain: 20 bins, R 8, 128 lanes of which 120 are live;

and prints, for each tracked thread, the median cycles per step of each
phase over steps 1..398, the cycles of the whole loop, and the kernel's
time from CUDA events over 20 launches of the unmodified library (so the
cycles convert to time at the clock the card ran).  The stamps cost a few
cycles each, and the compiler may still move work that does not feed a
stamp across it, so a phase's cycles are approximate; the J = 0 shape's
time is the firm measure of what the dot products add.  Exits naming the
line if the loop's source no longer has a line it stamps.

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
OUT = ROOT / "build" / "trace"
STEPS, READS, LANES = 400, 8, 128
TRACKED = "(blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x == 0 || threadIdx.x == blockDim.x - 32))"

# The stamps: (text to stamp before or after, "before" / "after", stamp
# index, a value the stamp waits for), stamps 0..4 in step order; each
# phase spans stamps a -> b in SPANS.  A stamp reads the clock in an asm
# that takes the phase's last result as an operand, so the compiler cannot
# move the reading ahead of the work it closes.  The loop: sincos, one
# barrier, dot (per tile), update.
STAMPS = [
    ("    // sincos of the thread's phases; the live lanes' [cos; sin] into buf\n", "after", 0,
     "phi[0]"),
    ("    __syncthreads();  // buf is complete\n", "before", 1, "c[TPT - 1] + s[TPT - 1]"),
    ("    __syncthreads();  // buf is complete\n", "after", 2, "0.0f"),
    ("      // the update of this phase\n", "before", 3, "mc + ms"),
    ("  }\n  __syncthreads();  // every thread is done with cs", "before", 4,
     "phi[TPT - 1] + phi[0]"),
]
SPANS = {"sincos": (0, 1), "barrier": (1, 2), "dot": (2, 3), "update": (3, 4)}


def instrumented_header(src: str) -> str:
    """``cobi_anneal.cuh`` with stamps g_trace[thread][step][k]."""
    for text, where, k, dep in STAMPS:
        if src.count(text) != 1:
            sys.exit(f"cobi_trace: the loop source changed; no single {text.strip()!r} to stamp")
        stamp = ("{ long long clk_; asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(clk_) : "
                 f"\"f\"({dep}) : \"memory\");\n"
                 f"  if ({TRACKED} && t < 512) g_trace[threadIdx.x ? 1 : 0][t][{k}] = clk_; }}\n")
        src = src.replace(text, stamp + text if where == "before" else text + stamp)
    return src.replace("namespace repro {\n",
                       "namespace repro {\n__device__ long long g_trace[2][512][5];\n", 1)


def build(out: Path, traced: bool):
    """Copy the COBI sources into ``out`` (stamped if ``traced``) and build
    ``cobi_dynamics.cu`` there; returns the library."""
    import torch  # noqa: F401  (CUDA runtime loaded before the library)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    for f in ("cobi_dynamics.cu", "cobi_anneal.cuh", "ising_energy.cuh"):
        shutil.copy(CSRC / f, out / f)
    if traced:
        (out / "cobi_anneal.cuh").write_text(
            instrumented_header((CSRC / "cobi_anneal.cuh").read_text()))
        with open(out / "cobi_dynamics.cu", "a") as fh:
            fh.write('\nextern "C" int read_trace(void* host) {\n'
                     "  return (int)cudaMemcpyFromSymbol(host, repro::g_trace, "
                     "sizeof(repro::g_trace));\n}\n")
    lib_path = out / "cobi_dynamics.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "cobi_dynamics.cu")], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"cobi_trace: nvcc failed:\n{done.stdout[-4000:]}{done.stderr[-4000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {'traced' if traced else 'plain'}: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.cobi_trajectory.argtypes = _build._ARGTYPES["cobi_dynamics"]["cobi_trajectory"]
    if traced:
        lib.read_trace.argtypes = [ctypes.c_void_p]
    return lib


def operands(bins: int, live: int, seed: int, dev):
    """(j (B, 128, 128), h (B, 128), phi0 (B, R, 128)): chip-range integer
    instances of ``live`` spins on 128 lanes (h on max(live, 20) of them),
    divided by the solver's dynamics scale (2 max_i sum_k |J_ik| + max |h|),
    and uniform phases."""
    import torch

    rng = np.random.default_rng(seed)
    j = np.zeros((bins, LANES, LANES), np.float32)
    h = np.zeros((bins, LANES), np.float32)
    for b in range(bins):
        up = np.triu(rng.integers(-14, 15, (live, live)), 1).astype(np.float32)
        hb = rng.integers(-14, 15, max(live, 20)).astype(np.float32)
        if live:
            up[0, live - 1] = 7.0  # the live extent is exactly ``live``
        full = up + up.T
        scale = np.float32(2.0 * np.abs(full).sum(-1).max(initial=0.0) + np.abs(hb).max())
        j[b, :live, :live] = full / scale
        h[b, :hb.size] = hb / scale
    phi0 = rng.uniform(0, 2 * np.pi, (bins, READS, LANES)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (j, h, phi0)]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("cobi_trace: torch.cuda.is_available() is False: it needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    plain = build(OUT / "plain", traced=False)
    traced = build(OUT / "traced", traced=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    for label, bins, live in (("direct", 1, 20), ("direct, J = 0", 1, 0), ("farm drain", 20, 120)):
        j, h, phi0 = operands(bins, live, seed=20 if live == 0 else live, dev=dev)
        out = torch.empty_like(phi0)

        def launch(lib):
            err = lib.cobi_trajectory(j.data_ptr(), h.data_ptr(), phi0.data_ptr(), out.data_ptr(),
                                      bins, READS, LANES, STEPS, 0.35, 1.2, _build.stream_of(phi0))
            _build.check(err, "cobi_trajectory")

        for _ in range(3):
            launch(plain)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch(plain)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        want = out.clone()
        launch(traced)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            sys.exit(f"cobi_trace: the stamped kernel's phases differ from the plain one's ({label})")
        tr = np.zeros((2, 512, len(STAMPS)), np.int64)
        _build.check(traced.read_trace(tr.ctypes.data), "read_trace")
        print(f"{label}: B={bins} R={READS} {LANES} lanes, {live} live, {STEPS} steps: kernel "
              f"{ms:.4f} ms (CUDA events, 20 launches, unstamped)")
        for slot, who in enumerate(("thread 0 (dot lanes)", "last warp")):
            x = tr[slot, 1:STEPS - 1]
            med = {p: float(np.median(x[:, b] - x[:, a])) for p, (a, b) in SPANS.items()}
            loop = float(tr[slot, STEPS - 1, len(STAMPS) - 1] - tr[slot, 0, 0])
            print(f"  {who}: {loop / STEPS:.0f} cycles a step ({loop:.0f} for the loop, "
                  f"{loop / (ms * 1e-3) / 1e9:.3f} GHz against the kernel's time); median "
                  + ", ".join(f"{p} {m:.0f}" for p, m in med.items()))


if __name__ == "__main__":
    main()
