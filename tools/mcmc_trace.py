#!/usr/bin/env python3
"""Where the MCMC annealer's time goes, on the card.

    python3 tools/mcmc_trace.py

Builds two libraries from the checkout's
``src/repro_torch/kernels/csrc/mcmc_dynamics.cu`` into ``build/trace/mcmc/``:
the unmodified source, and a copy that stamps ``clock64()`` at the phase
boundaries of each step of replica 0 (block (0, 0), lane 0).  It knows two
layouts of the source and stamps whichever it finds:

  * registers (the redesign; a step is a group of up to 5 proposals
    decided by one speculated test): ``hash`` -- a round's table of
    uniforms, positions and h_k, built 32 proposals at a time (spread over
    the round's steps); ``read`` -- the group's positions, this lane's
    node's spins, its f from the owner lane and its corrections under its
    hypothesis; ``test`` -- dE, the division and expf, one for all 31
    nodes; ``resolve`` -- the ballots that find the outcome path;
    ``update`` -- f along the path; ``best`` -- the spins, the energy and
    the best-of along the path;
  * shared (the first port; a step is one proposal, one warp per replica
    over shared memory): ``hash`` -- the proposal's uniform and pick;
    ``read`` -- s_k, f_k, h_k and the warp barrier; ``test`` -- dE, the
    division and expf; ``update`` -- f over every padded lane and the spin;
    ``best`` -- the energy and the copy of every lane on an improvement.

To trace the kernel a change started from, unpack the parent with ``git
archive`` into ``build/parent``, copy this file into its ``tools/`` and run
that copy: it builds and imports the parent's sources.

It runs ``mcmc_sweep`` at three shapes, 50 sweeps in sweep mode, R 8 on
128 lanes (chip-range integer instances, the ladder from 2 max_i sum_j
|J_ij| down to 0.05):

  * direct: 20 live spins;
  * direct, hot: the same with every temperature 1e30, so that every
    proposal is accepted (the update and the best-of on every step);
  * farm: 40 live spins (the farm mix's largest document);

and prints the kernel's time (CUDA events over 20 launches of the
unstamped library), its time a proposal and the cycles that is at the
card's maximum SM clock, the stamped cycles a proposal (a step's start to
the next one's, within a round), the share of proposals accepted, and each
phase's cycles a proposal and its median a step.  The stamps read the clock
in an asm that takes the phase's last result as an operand (the first
takes none); they cost a few cycles each, and the compiler may still move
work that does not feed a stamp across it, so a phase's cycles are
approximate; the unstamped time is the firm one.  Exits naming the line if
the source has neither layout's lines.

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
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "trace" / "mcmc"
SWEEPS, READS, LANES = 50, 8, 128
MAX_P = 4096  # proposals traced
TRACKED = "(blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)"

# A layout: the index of the step in scope at the stamps (a group of
# proposals, or one proposal), the stamps as (text to stamp before or after,
# "before" / "after", stamp index, a value the stamp waits for), values
# stored beside them (slot: expression, written at stamp 3), and the phases
# as spans of stamps.  The shared layout branches on the decision, so its
# stamps 3..5 exist only for accepted proposals, and a rejected one's test
# runs to the next proposal's stamp 0.  ROUND stamps open and close the
# registers layout's table of a round.
LAYOUTS = {
    "registers": {
        "p": "(ts * in.n_real + t0 + g0)",
        "round": "(ts * ((in.n_real + kTab - 1) / kTab) + t0 / kTab)",
        "stamps": [
            ("        // read: the group's positions, this node's proposal and spins, and\n",
             "before", 0, "0.0f"),
            ("        // test\n", "before", 1, "fn + si"),
            ("        // resolve: the one node of the last level whose hypothesis every\n",
             "before", 2, "(float)acc"),
            ("        // update: f along the path, in order (path bits past the group are 0)\n",
             "before", 3, "(float)path"),
            ("        // best-of: the spins, the energy and the best state along the path\n",
             "before", 4, "f[0]"),
            ("      }  // the group\n", "before", 5, "best_e + (float)best[0]"),
        ],
        "stored": {6: "g", 7: "__popc(path)"},  # proposals in the group, accepted
        "round_stamps": [
            ("      // hash and pick: lane i tabulates proposal t0 + i\n", "before", 0, "0.0f"),
            ("      for (int g0 = 0; g0 < cnt; g0 += kDepth) {\n", "before", 1, "0.0f"),
        ],
        "spans": {"read": (0, 1), "test": (1, 2), "resolve": (2, 3), "update": (3, 4),
                  "best": (4, 5)},
    },
    "shared": {
        "p": "(ts * in.n_real + t)",
        "stamps": [
            ("        const float u_acc = u01(in.seed_acc, rep, (uint32_t)ts, (uint32_t)t);\n",
             "before", 0, "0.0f"),
            ("        const float s_k = s[k], f_k = f[k], h_k = in.h[k];\n", "before", 1,
             "u_acc + (float)k"),
            ("        const float de = (-2.0f * s_k) * (h_k + 2.0f * f_k);\n", "before", 2,
             "s_k + f_k + h_k"),
            ("          const float coef = 2.0f * s_k;\n", "after", 3, "coef"),
            ("          e = e + de;\n", "before", 4, "f[lane]"),
            ("          __syncwarp();\n        }\n", "after", 5, "best_e"),
        ],
        "stored": {},
        "round_stamps": [],
        "spans": {"hash": (0, 1), "read": (1, 2), "test": (2, 3), "update": (3, 4),
                  "best": (4, 5)},
    },
}
N_STAMPS = 8


def stamp_code(array: str, index: str, k: int, dep: str) -> str:
    return ("{ long long clk_; asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(clk_) : "
            f"\"f\"({dep}) : \"memory\");\n"
            f"  if ({TRACKED} && {index} < {MAX_P}) {array}[{index}][{k}] = clk_; }}\n")


def instrumented(src: str) -> tuple[str, str]:
    """(the layout's name, the source with stamps g_trace[p][k] and
    g_round[round][k]).  Exits naming the first line it cannot find."""
    name = next((n for n, lay in LAYOUTS.items() if lay["stamps"][0][0] in src), None)
    if name is None:
        sys.exit("mcmc_trace: the source has neither layout; no "
                 + " or ".join(repr(lay["stamps"][0][0].strip()) for lay in LAYOUTS.values())
                 + " to stamp")
    lay = LAYOUTS[name]
    for array, index, stamps in (("g_trace", lay["p"], lay["stamps"]),
                                 ("g_round", lay.get("round", "0"), lay["round_stamps"])):
        for text, where, k, dep in stamps:
            if src.count(text) != 1:
                sys.exit(f"mcmc_trace: the {name} layout changed; no single {text.strip()!r} "
                         "to stamp")
            code = stamp_code(array, index, k, dep)
            if array == "g_trace" and k == 3:
                for slot, value in lay["stored"].items():
                    code += (f"if ({TRACKED} && {index} < {MAX_P}) "
                             f"g_trace[{index}][{slot}] = {value};\n")
            src = src.replace(text, code + text if where == "before" else text + code)
    head = (f"__device__ long long g_trace[{MAX_P}][{N_STAMPS}];\n"
            f"__device__ long long g_round[{MAX_P}][2];\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    src += ('\nextern "C" int read_trace(void* p, void* r) {\n'
            "  cudaError_t e = cudaMemcpyFromSymbol(p, g_trace, sizeof(g_trace));\n"
            "  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(r, g_round, "
            "sizeof(g_round)));\n}\n"
            'extern "C" int clear_trace() {\n'
            "  void *p, *r;\n"
            "  if (cudaGetSymbolAddress(&p, g_trace) || cudaGetSymbolAddress(&r, g_round)) return 1;\n"
            "  return (int)(cudaMemset(p, 0, sizeof(g_trace)) || cudaMemset(r, 0, sizeof(g_round)));"
            "\n}\n")
    return name, src


def build(traced: bool):
    """Build ``mcmc_dynamics.cu`` (stamped if ``traced``) into OUT; returns
    (library, layout name or None)."""
    import torch  # noqa: F401  (CUDA runtime loaded before the library)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out = OUT / ("traced" if traced else "plain")
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "mcmc_dynamics.cu").read_text()
    layout = None
    if traced:
        layout, src = instrumented(src)
    (out / "mcmc_dynamics.cu").write_text(src)
    lib_path = out / "mcmc_dynamics.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "mcmc_dynamics.cu")], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"mcmc_trace: nvcc failed:\n{done.stdout[-4000:]}{done.stderr[-4000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {'traced' if traced else 'plain'}: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.mcmc_sweep.argtypes = _build._ARGTYPES["mcmc_dynamics"]["mcmc_sweep"]
    if traced:
        lib.read_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, layout


def operands(live: int, seed: int, hot: bool, dev):
    """(j, h, s0, seeds, params, temps) on the card for one chip-range
    integer instance of ``live`` spins on LANES lanes and READS replicas."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(seed)
    up = np.triu(rng.integers(-14, 15, (live, live)), 1).astype(np.float32)
    j = np.zeros((1, LANES, LANES), np.float32)
    h = np.zeros((1, LANES), np.float32)
    j[0, :live, :live] = up + up.T
    h[0, :live] = rng.integers(-14, 15, live)
    seeds = kref.mcmc_seeds(prng.key(seed))
    s0 = kref.mcmc_init_spins(seeds[0], READS, LANES)[None]
    t_hi = float(kref.mcmc_t_hi(torch.from_numpy(j[0, :live, :live])))
    params = torch.tensor([[t_hi, 0.05, float(live), float(READS)]])
    temps = (torch.full((1, SWEEPS), 1e30) if hot
             else kref.mcmc_ladder(t_hi, 0.05, SWEEPS)[None])
    t = lambda a: torch.as_tensor(a).to(dev).contiguous()
    return t(j), t(h), t(s0), t(seeds[None]), t(params), t(temps)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("mcmc_trace: torch.cuda.is_available() is False: it needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"source: {CSRC}")
    plain, _ = build(traced=False)
    traced, layout = build(traced=True)
    lay = LAYOUTS[layout]
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    for label, live, hot in (("direct", 20, False), ("direct, hot", 20, True),
                             ("farm", 40, False)):
        j, h, s0, seeds, params, temps = operands(live, seed=live, hot=hot, dev=dev)
        e_out = torch.empty((1, READS), device=dev)
        s_out = torch.empty_like(s0)

        def launch(lib):
            err = lib.mcmc_sweep(j.data_ptr(), h.data_ptr(), s0.data_ptr(), seeds.data_ptr(),
                                 params.data_ptr(), temps.data_ptr(), e_out.data_ptr(),
                                 s_out.data_ptr(), 1, READS, LANES, SWEEPS, LANES, 0, READS,
                                 _build.stream_of(s0))
            _build.check(err, "mcmc_sweep")

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
        want = (e_out.clone(), s_out.clone())
        _build.check(traced.clear_trace(), "clear_trace")  # a shape's stamps, no earlier ones
        launch(traced)
        torch.cuda.synchronize()
        if not (torch.equal(e_out, want[0]) and torch.equal(s_out, want[1])):
            sys.exit(f"mcmc_trace: the stamped kernel's result differs from the plain one's ({label})")
        tr = np.zeros((MAX_P, N_STAMPS), np.int64)
        rd = np.zeros((MAX_P, 2), np.int64)
        _build.check(traced.read_trace(tr.ctypes.data, rd.ctypes.data), "read_trace")
        props = SWEEPS * live
        tr = tr[:props]
        if layout == "shared":  # every proposal is a step; stamp 3 only where accepted
            rec = np.arange(props)
            size, accepted = np.ones(props), (tr[:, 3] != 0).astype(np.float64)
        else:  # a step is a group; its size and accepted count stored beside
            rec = np.nonzero(tr[:, 0])[0]
            size, accepted = tr[rec, 6].astype(np.float64), tr[rec, 7].astype(np.float64)
        x = tr[rec]
        t = rec % live
        # a step's cycles: to the next step's start, within a sweep (and,
        # for the registers layout, within a round of kTab proposals)
        nxt = np.append(rec[1:], -1)
        inner = (nxt // live == rec // live) & (nxt >= 0)
        if lay["round_stamps"]:
            inner &= nxt % live // 32 == t // 32
        step = np.append(np.diff(x[:, 0]), 0).astype(np.float64)
        spans = {}
        for phase, (a, b) in lay["spans"].items():
            both = (x[:, a] != 0) & (x[:, b] != 0)
            spans[phase] = np.where(both, x[:, b] - x[:, a], 0).astype(np.float64)
        if layout == "shared":  # a rejected proposal's test runs to the next one's start
            spans["test"] = np.where(accepted > 0, spans["test"], step - (x[:, 2] - x[:, 0]))
        if lay["round_stamps"]:
            rounds = SWEEPS * -(-live // 32)
            spans = {"hash": np.full(rec.size, float((rd[:rounds, 1] - rd[:rounds, 0]).sum())
                                     / rec.size), **spans}
        clock = max_clock_ghz()
        print(f"{label}: {live} live of {LANES} lanes, R={READS}, {SWEEPS} sweeps, {props} "
              f"proposals ({layout} layout, {rec.size} steps of {size.mean():.2f} proposals): "
              f"kernel {ms:.4f} ms (CUDA events, 20 launches, unstamped), {ms * 1e6 / props:.1f} "
              f"ns a proposal = {ms * 1e6 / props * clock:.0f} cycles at the {clock:.2f} GHz "
              f"maximum clock; stamped {step[inner].sum() / size[inner].sum():.0f} cycles a "
              f"proposal (median step {np.median(step[inner]):.0f}); accepted "
              f"{accepted.sum() / props:.3f}")
        for phase, v in spans.items():
            print(f"  {phase:8s} {v.sum() / props:7.1f} cycles a proposal; median a step "
                  f"{np.median(v):.0f}")


def max_clock_ghz() -> float:
    """The card's maximum SM clock (nvidia-smi), in GHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) / 1e3

if __name__ == "__main__":
    main()
