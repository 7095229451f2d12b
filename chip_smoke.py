#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and cuDNN;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together) and print the build seconds;
  3. hold every kernel against its plain PyTorch version on the card, at the
     main path's shapes (8 reads, 128 padded lanes) and at 1024 reads
     (many replica blocks, so the cross-block first-argmin is exercised);
  4. the main path: a 20-sentence document through ``solve_es`` (10
     iterations x 8 reads x 400 steps), a 100-sentence document through the
     windowed decomposition, and the solver's fused ``reduce="best"`` /
     ``"topk"`` readouts of the same instances; each path with the launch
     counts set to 0 just before and read just after;
  5. time every kernel, its plain version and its bound (at the padded
     shapes the kernels take, and at the instance's own n spins and reads);
  6. print the ``kernels`` JSON line, the card line, and last the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.  Without
a CUDA device, or without the repository around it, it fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

STEPS, READS, ITERATIONS = 400, 8, 10
TRAJ_TOL = 2e-4  # rtol = atol at 50 steps: the reference's kernel-vs-oracle bound


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events around ``reps``)."""
    import torch

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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def work(name: str, r: int, n: int, s: int) -> tuple[float, float]:
    """(FLOP, bytes) of one call of kernel ``name`` on r reads, n lanes and
    s slots at STEPS steps: each input read once, each output written once.
    The anneal counts the stacked [cos; sin] @ J product; sin/cos and the
    elementwise update are not counted."""
    f32 = 4
    anneal = STEPS * 2 * (2 * r) * n * n
    score = 2 * r * n * n + 4 * r * n
    return {
        "cobi_trajectory": (anneal, f32 * (n * n + n + 2 * r * n)),
        "ising_energy": (score, f32 * (r * n + n + n * n + r)),
        "cobi_fused_best": (anneal + score + 2 * r * n * s,
                            f32 * (2 * n * n + 2 * n + n * s + s + r * n + s + s * n)),
        "cobi_readout": (anneal + score, f32 * (2 * n * n + 2 * n + 2 * r * n + r)),
    }[name]


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py: run it from the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.core import SolveConfig, improved_ising, solve_es
    from repro_torch.core import metrics, pipeline
    from repro_torch.core.rounding import quantize_ising
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import problem_from_sentences
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cobi_dynamics as cd
    from repro_torch.kernels import ising_energy as ie
    from repro_torch.kernels import ref as kref
    from repro_torch.solvers import ising_solver

    # ------------------------------------------------------------ 1. the card
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print(f"  {name}: {line.strip()}")

    counted = {
        "cobi_trajectory": cd.cobi_trajectory_cuda,
        "ising_energy": ie.ising_energy_cuda,
        "cobi_fused_best": cd.cobi_fused_best_cuda,
        "cobi_readout": cd.cobi_readout_cuda,
    }

    def reset_counts() -> None:
        for w in counted.values():
            w.launches = 0

    def counts() -> dict:
        return {name: w.launches for name, w in counted.items()}

    # The direct document's problem and its first rounded instance: the
    # shapes and values the main path hands the kernels.
    sents = synthetic_document(7, 20)
    problem = problem_from_sentences(sents, m=6, lam=0.5, device=dev)
    key = prng.key(0)
    (k_quant, k_solve), = pipeline._iteration_keys(key, 1)
    inst = quantize_ising(improved_ising(problem), key=k_quant).ising

    # ------------------------------------------------------------ 3. kernels vs plain
    errs = {}

    def operands(reads: int, k, h=inst.h, j=inst.j):
        op = ops.anneal_operands(h, j, k, replicas=reads)
        mask, rd = ops.solo_slot(op.n_pad, reads, dev)
        return op, mask, rd

    # A 200-spin integer instance: 256 lanes, where J no longer fits shared
    # memory and the anneal reads it from global memory.
    rng = np.random.default_rng(0)
    wide_j = np.triu(rng.integers(-14, 15, (200, 200)), 1).astype(np.float32)
    wide_h = torch.tensor(rng.integers(-14, 15, 200).astype(np.float32), device=dev)
    wide_j = torch.tensor(wide_j + wide_j.T, device=dev)

    for reads, h, j in ((READS, inst.h, inst.j), (1024, inst.h, inst.j), (16, wide_h, wide_j)):
        op, mask, rd = operands(reads, k_solve, h, j)
        traj_args = (op.j_scaled, op.h_scaled, op.phi0)
        read_args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, op.phi0)
        fused_args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, mask, rd, op.phi0)
        short = dict(steps=50, dt=0.35, ks_max=1.2)
        full = dict(steps=STEPS, dt=0.35, ks_max=1.2)

        # Trajectory: phases within the reference's 50-step bound.
        got = cd.cobi_trajectory_cuda(*traj_args, **short)
        want = cd.cobi_trajectory_plain(*traj_args, **short)
        err = (got - want).abs()
        if not bool((err <= TRAJ_TOL + TRAJ_TOL * want.abs()).all()):
            fail(f"cobi_trajectory vs plain at reads={reads} lanes={op.n_pad}: "
                 f"max err {float(err.max())}")
        errs["cobi_trajectory"] = max(errs.get("cobi_trajectory", 0.0), float(err.max()))

        # Readout and fused best at 50 steps against their plain versions:
        # same spins, same energies, exactly.  At 1024 reads some phase sits
        # within the phase tolerance of a readout boundary, so only the
        # main path's 8 reads are compared spin for spin.
        if reads == READS and op.n_pad == 128:
            s_k, e_k = cd.cobi_readout_cuda(*read_args, **short)
            s_p, e_p = cd.cobi_readout_plain(*read_args, **short)
            if not torch.equal(s_k, s_p) or not torch.equal(e_k, e_p):
                fail(f"cobi_readout vs plain: spins equal {torch.equal(s_k, s_p)}, "
                     f"max energy err {float((e_k - e_p).abs().max())}")
            errs["cobi_readout"] = float((e_k - e_p).abs().max())
            be_k, bs_k = cd.cobi_fused_best_cuda(*fused_args, **short)
            be_p, bs_p = cd.cobi_fused_best_plain(*fused_args, **short)
            if not (torch.equal(be_k[:1], be_p[:1]) and torch.equal(bs_k[:1], bs_p[:1])):
                fail(f"cobi_fused_best vs plain: {be_k[:1].tolist()} vs {be_p[:1].tolist()}")
            errs["cobi_fused_best"] = float((be_k[:1] - be_p[:1]).abs().max())

        # Full anneals, kernel side: the three anneal kernels share one Euler
        # loop, so readout spins == sign(cos(trajectory phases)) and fused
        # best == readout + first argmin, bitwise; energies are exact.
        phi = cd.cobi_trajectory_cuda(*traj_args, **full)
        s_k, e_k = cd.cobi_readout_cuda(*read_args, **full)
        if not torch.equal(s_k, kref.sign_spins(phi)):
            fail(f"readout spins != sign(cos(trajectory phases)) at reads={reads}")
        e_plain = kref.ref_ising_energy(s_k, op.h_orig[0], op.j_orig)
        e_kern = ie.ising_energy_cuda(s_k, op.h_orig, op.j_orig)
        if not (torch.equal(e_k, e_plain) and torch.equal(e_kern, e_plain)):
            fail(f"energies not exact at reads={reads}: readout "
                 f"{float((e_k - e_plain).abs().max())}, ising_energy "
                 f"{float((e_kern - e_plain).abs().max())}")
        errs["ising_energy"] = max(errs.get("ising_energy", 0.0),
                                   float((e_kern - e_plain).abs().max()))
        be_k, bs_k = cd.cobi_fused_best_cuda(*fused_args, **full)
        i = int(torch.argmin(e_k[:reads]))  # first minimum
        if not (float(be_k[0]) == float(e_k[i]) and torch.equal(bs_k[0], s_k[i])):
            fail(f"fused best != readout + first argmin at reads={reads}: "
                 f"{float(be_k[0])} vs {float(e_k[i])} (row {i})")
        if not bool(torch.isinf(be_k[1:]).all()):
            fail("padding slots of the fused best are not +inf")
        print(f"kernels vs plain at reads={reads} lanes={op.n_pad}: ok (best read {i}, E={float(e_k[i])}, "
              f"{int((e_k[:reads] == e_k[i]).sum())} reads tie at the minimum)")
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 4. main path
    cfg = SolveConfig(solver="cobi", iterations=ITERATIONS, reads=READS, steps=STEPS)
    bounds = metrics.reference_bounds(problem)
    launches = {}

    reset_counts()
    t0 = time.perf_counter()
    rep = solve_es(problem, key, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    direct = counts()
    score = float(metrics.normalized_objective(rep.objective, bounds))
    rep_cpu = solve_es(problem, key, cfg, device="cpu")
    score_cpu = float(metrics.normalized_objective(rep_cpu.objective, bounds))
    print(f"direct: N={problem.n} M={problem.m} selected {rep.selection.nonzero()[0].tolist()} "
          f"norm_obj {score:.6f} (plain on CPU {score_cpu:.6f}) wall {wall:.3f} s "
          f"launches {direct}")
    if rep.selection.sum() != problem.m or not math.isfinite(rep.objective):
        fail(f"direct summary selects {rep.selection.sum()} != {problem.m}")
    if score <= 0.8:
        fail(f"direct normalized objective {score} <= 0.8")
    if abs(score - score_cpu) > 0.05:
        fail(f"card and CPU objectives differ by {abs(score - score_cpu)} > 0.05")
    want = {"cobi_trajectory": ITERATIONS, "ising_energy": ITERATIONS,
            "cobi_fused_best": 0, "cobi_readout": 0}
    if direct != want:
        fail(f"direct path launches {direct} != {want}")

    big = problem_from_sentences(synthetic_document(11, 100), m=6, lam=0.5, device=dev)
    dcfg = SolveConfig(solver="cobi", iterations=ITERATIONS, reads=READS, steps=STEPS,
                       decompose=True, p=20, q=10)
    reset_counts()
    t0 = time.perf_counter()
    drep = solve_es(big, prng.key(1), dcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decomposed = counts()
    print(f"decomposed: N={big.n} M={big.m} selected {drep.selection.nonzero()[0].tolist()} "
          f"objective {drep.objective:.6f} solves x iterations {drep.solver_invocations} "
          f"wall {wall:.3f} s launches {decomposed}")
    if drep.selection.sum() != big.m or not math.isfinite(drep.objective):
        fail(f"decomposed summary selects {drep.selection.sum()} != {big.m}")
    n_inv = drep.solver_invocations
    want = {"cobi_trajectory": n_inv, "ising_energy": n_inv,
            "cobi_fused_best": 0, "cobi_readout": 0}
    if decomposed != want:
        fail(f"decomposed path launches {decomposed} != {want}")

    # The solver's fused readouts over the direct document's rounded
    # instances: reduce="best" must pick what reduce="topk" ranks first.
    cobi = ising_solver("cobi")
    ising_fp = improved_ising(problem)
    reset_counts()
    for kq, ks in pipeline._iteration_keys(key, ITERATIONS):
        q = quantize_ising(ising_fp, key=kq).ising
        best = cobi(q, ks, reads=READS, steps=STEPS, reduce="best")
        top = cobi(q, ks, reads=READS, steps=STEPS, reduce="topk")
        if not (torch.equal(best.energies, top.energies[:1])
                and torch.equal(best.spins, top.spins[:1])):
            fail("solver reduce='best' != reduce='topk' first read")
    reduced = counts()
    print(f"reduce paths: launches {reduced}")
    want = {"cobi_trajectory": 0, "ising_energy": 0,
            "cobi_fused_best": ITERATIONS, "cobi_readout": ITERATIONS}
    if reduced != want:
        fail(f"reduce paths launches {reduced} != {want}")
    for name in counted:
        launches[name] = direct[name] + decomposed[name] + reduced[name]

    # ------------------------------------------------------------ 5. timing
    op, mask, rd = operands(READS, k_solve)
    full = dict(steps=STEPS, dt=0.35, ks_max=1.2)
    spins = kref.sign_spins(cd.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **full))
    jobs = {
        "cobi_trajectory": (
            lambda: cd.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **full),
            lambda: cd.cobi_trajectory_plain(op.j_scaled, op.h_scaled, op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:232", "cobi_dynamics.cu"),
        "ising_energy": (
            lambda: ie.ising_energy_cuda(spins, op.h_orig, op.j_orig),
            lambda: ie.ising_energy_plain(spins, op.h_orig, op.j_orig),
            "src/repro/kernels/ising_energy.py:43", "ising_energy.cu"),
        "cobi_fused_best": (
            lambda: cd.cobi_fused_best_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                            mask, rd, op.phi0, **full),
            lambda: cd.cobi_fused_best_plain(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                             mask, rd, op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:300", "cobi_dynamics.cu"),
        "cobi_readout": (
            lambda: cd.cobi_readout_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                         op.phi0, **full),
            lambda: cd.cobi_readout_plain(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                          op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:419", "cobi_dynamics.cu"),
    }
    # bound_ms counts the operands as the kernels take them (R=8 rows, 128
    # padded lanes, 8 padded slots); bound_unpadded_ms counts only the
    # instance's own n spins, its reads and its one slot.
    n_real = problem.n
    reset_counts()  # timing launches are not the main path's
    rows = []
    for name, (kern, plain, replaces, source) in jobs.items():
        ms = cuda_ms(kern, reps=200 if name == "ising_energy" else 20)
        plain_ms = cuda_ms(plain, reps=50 if name == "ising_energy" else 3, warmup=1)
        b_ms, by = bound_ms(*work(name, op.r_pad, op.n_pad, mask.shape[1]))
        u_ms, u_by = bound_ms(*work(name, READS, n_real, 1))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "bound_unpadded_ms": u_ms, "bound_unpadded_by": u_by,
        })
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({by}) at R={op.r_pad} N={op.n_pad}, "
              f"{u_ms:.6f} ms ({u_by}) at R={READS} N={n_real}; steps={STEPS}")

    # The anneal at 1024 reads (128 thread blocks): how the kernel scales.
    op_big, mask_big, rd_big = operands(1024, k_solve)
    for name, fn in (
        ("cobi_trajectory", lambda: cd.cobi_trajectory_cuda(
            op_big.j_scaled, op_big.h_scaled, op_big.phi0, **full)),
        ("cobi_fused_best", lambda: cd.cobi_fused_best_cuda(
            op_big.j_scaled, op_big.h_scaled, op_big.j_orig, op_big.h_orig,
            mask_big, rd_big, op_big.phi0, **full)),
    ):
        ms = cuda_ms(fn, reps=10)
        b_ms, by = bound_ms(*work(name, op_big.r_pad, op_big.n_pad, mask_big.shape[1]))
        print(f"time {name} at reads=1024: kernel {ms:.4f} ms, bound {b_ms:.6f} ms ({by})")

    # ------------------------------------------------------------ 6. result
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
