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
  3b. the chip farm's batched kernels against their plain versions on packed
     bins of the 16-document mix: the batched trajectory at 50 steps; at 400
     steps the fused batched best against the batched trajectory + sign +
     stacked energies + first argmin, and against each job's solo fused
     best from the same phases; one bin of 100 one-spin jobs (S = 100);
  4. the main path: a 20-sentence document through ``solve_es`` (10
     iterations x 8 reads x 400 steps), a 100-sentence document through the
     windowed decomposition, and the solver's fused ``reduce="best"`` /
     ``"topk"`` readouts of the same instances; each path with the launch
     counts set to 0 just before and read just after;
  4b. the chip farm: 16 documents of the farm benchmark's mix (m = 5,
     6 iterations x 8 reads x 400 steps) inline, then as 16 ``iter_solve_es``
     generators in lockstep through one ``CobiFarm(4)`` (``policy="manual"``,
     one drain per round), bitwise equal to inline; the 100-sentence
     document through ``solve_es(backend=CobiFarm(4))`` with pipelined
     windows, equal to its inline decomposed run; the 16 documents again
     under ``policy="bin-full"``, equal to ``manual``; and their 96 rounded
     instances through ``solve_batch(reduce="none")``, the two-launch drain,
     whose first argmins equal the fused winners.  Launch counts are held
     against what the drains imply;
  5. time every kernel, its plain version and its bound (at the padded
     shapes the kernels take, and at the instances' own n spins and reads);
     the batched kernels at the 16-document drain's shape;
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
# The farm benchmark's document mix (benchmarks/farm_throughput.py SIZES):
# synthetic_document(100 + i, n), m = 5, lambda = 0.5, 6 iterations.
FARM_SIZES = [10, 14, 18, 22, 26, 30, 34, 38, 12, 16, 20, 24, 28, 32, 36, 40]
FARM_ITERATIONS = 6


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
    elementwise update are not counted.  A batched kernel's work is the sum
    of its instances' (:func:`batched_work`)."""
    f32 = 4
    anneal = STEPS * 2 * (2 * r) * n * n
    score = 2 * r * n * n + 4 * r * n
    return {
        "cobi_trajectory": (anneal, f32 * (n * n + n + 2 * r * n)),
        "ising_energy": (score, f32 * (r * n + n + n * n + r)),
        "cobi_fused_best": (anneal + score + 2 * r * n * s,
                            f32 * (2 * n * n + 2 * n + n * s + s + r * n + s + s * n)),
        "cobi_readout": (anneal + score, f32 * (2 * n * n + 2 * n + 2 * r * n + r)),
    }[name.removesuffix("_batched")]


def batched_work(name: str, shapes) -> tuple[float, float]:
    """(FLOP, bytes) of one batched call over instances of (r, n, s) shapes."""
    flops, nbytes = zip(*(work(name, r, n, s) for r, n, s in shapes))
    return sum(flops), sum(nbytes)


def packed_operands(instances, keys, reads, dev):
    """The operands one fused farm drain hands the batched kernels, built as
    ``CobiFarm._run_group`` / ``_execute_fused`` build them: best-fit packed
    128-lane bins, each job's phases from its own key at lane offset, bins
    padded to the batch bucket and slots to a multiple of 8.  Returns
    (operands dict of (B, ...) tensors, [(bin, slot index, Slot)])."""
    import torch

    from repro_torch import prng
    from repro_torch.farm import pack_instances
    from repro_torch.farm.scheduler import _batch_pad
    from repro_torch.kernels import ops

    bins = pack_instances(list(enumerate(instances)), 128)
    b_pad = _batch_pad(len(bins))
    s_pad = -(-max(len(b.slots) for b in bins) // ops.SLOT_PAD) * ops.SLOT_PAD
    z = lambda *shape: np.zeros(shape, np.float32)
    jp, hp, ju, hu = z(b_pad, 128, 128), z(b_pad, 128), z(b_pad, 128, 128), z(b_pad, 128)
    mask, rd, phi0 = z(b_pad, 128, s_pad), z(b_pad, s_pad), z(b_pad, reads, 128)
    slots = []
    for b, inst in enumerate(bins):
        jp[b], hp[b], ju[b], hu[b] = inst.j_scaled, inst.h_scaled, inst.j_orig, inst.h_orig
        for si, slot in enumerate(inst.slots):
            lanes = slice(slot.offset, slot.offset + slot.n)
            mask[b, lanes, si] = 1.0
            rd[b, si] = reads
            phi0[b, :, lanes] = prng.uniform(
                keys[slot.job_id], (reads, 128), 0.0, 2.0 * math.pi, device="cpu"
            ).numpy()[:, : slot.n]
            slots.append((b, si, slot))
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"j": t(jp), "h": t(hp[:, None]), "ju": t(ju), "hu": t(hu[:, None]),
            "mask": t(mask), "reads": t(rd[:, None]), "phi0": t(phi0)}, slots


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
    from repro_torch.core.formulation import IsingProblem
    from repro_torch.core.rounding import quantize_ising
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import problem_from_sentences
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cobi_dynamics as cd
    from repro_torch.kernels import ising_energy as ie
    from repro_torch.kernels import ref as kref
    from repro_torch.farm import CobiFarm
    from repro_torch.obs import Observability
    from repro_torch.solvers import cobi as cobi_solver
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
        "cobi_trajectory_batched": cd.cobi_trajectory_batched_cuda,
        "cobi_fused_best_batched": cd.cobi_fused_best_batched_cuda,
        "ising_energy_batched": ie.ising_energy_batched_cuda,
    }

    def reset_counts() -> None:
        for w in counted.values():
            w.launches = 0

    def counts() -> dict:
        return {name: w.launches for name, w in counted.items()}

    def expect(**launched) -> dict:
        return {name: launched.get(name, 0) for name in counted}

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

    # ------------------------------------------------------------ 3b. batched kernels
    # The farm benchmark's 16 documents and the 96 rounded instances and
    # solve keys their iterations submit (as pipeline._submit_iterations
    # makes them).
    farm_docs = [problem_from_sentences(synthetic_document(100 + i, n), m=5, lam=0.5,
                                        device=dev) for i, n in enumerate(FARM_SIZES)]
    farm_keys = list(prng.split(prng.key(0), len(farm_docs)))
    farm_cfg = SolveConfig(solver="cobi", iterations=FARM_ITERATIONS, reads=READS,
                           steps=STEPS, int_range=14)
    farm_jobs = []
    for doc, k in zip(farm_docs, farm_keys):
        ising_fp = improved_ising(doc)
        for kq, ks in pipeline._iteration_keys(k, FARM_ITERATIONS):
            farm_jobs.append((quantize_ising(ising_fp, key=kq).ising, ks))
    insts = [q for q, _ in farm_jobs]
    opd, slots = packed_operands(insts, [k for _, k in farm_jobs], READS, dev)
    b_bins, s_pad = opd["j"].shape[0], opd["mask"].shape[-1]
    short = dict(steps=50, dt=0.35, ks_max=1.2)
    full = dict(steps=STEPS, dt=0.35, ks_max=1.2)
    four = {k: v[:4] for k, v in opd.items()}
    fused_keys = ("j", "h", "ju", "hu", "mask", "reads", "phi0")

    got = cd.cobi_trajectory_batched_cuda(four["j"], four["h"], four["phi0"], **short)
    want = cd.cobi_trajectory_batched_plain(four["j"], four["h"], four["phi0"], **short)
    err = (got - want).abs()
    if not bool((err <= TRAJ_TOL + TRAJ_TOL * want.abs()).all()):
        fail(f"cobi_trajectory_batched vs plain on 4 bins: max err {float(err.max())}")
    errs["cobi_trajectory_batched"] = float(err.max())
    be_k, bs_k = cd.cobi_fused_best_batched_cuda(*(four[k] for k in fused_keys), **short)
    be_p, bs_p = cd.cobi_fused_best_batched_plain(*(four[k] for k in fused_keys), **short)
    real = four["reads"][:, 0] > 0
    if not (torch.equal(be_k[real], be_p[real]) and torch.equal(bs_k[real], bs_p[real])):
        fail("cobi_fused_best_batched vs plain on 4 bins at 50 steps: winners differ")
    errs["cobi_fused_best_batched"] = float((be_k[real] - be_p[real]).abs().max())

    # 400 steps on every bin of the drain: the fused launch against the
    # two-launch drain (batched trajectory, sign, each job's spins scored at
    # lane offset 0 against its own instance, first argmin), against exact
    # plain re-scoring, and against each job's solo fused best.
    phi = cd.cobi_trajectory_batched_cuda(opd["j"], opd["h"], opd["phi0"], **full)
    spins = kref.sign_spins(phi)
    n_jobs = len(slots)
    s_stack = torch.zeros((n_jobs, READS, 128), device=dev)
    h_stack = torch.zeros((n_jobs, 1, 128), device=dev)
    j_stack = torch.zeros((n_jobs, 128, 128), device=dev)
    for k, (b, _, slot) in enumerate(slots):
        n, lanes = slot.n, slice(slot.offset, slot.offset + slot.n)
        s_stack[k, :, :n] = spins[b, :, lanes]
        h_stack[k, 0, :n] = insts[slot.job_id].h
        j_stack[k, :n, :n] = insts[slot.job_id].j
    e_two = ie.ising_energy_batched_cuda(s_stack, h_stack, j_stack)
    e_plain = ie.ising_energy_batched_plain(s_stack, h_stack, j_stack)
    if not torch.equal(e_two, e_plain):
        fail(f"ising_energy_batched vs plain: max err {float((e_two - e_plain).abs().max())}")
    errs["ising_energy_batched"] = float((e_two - e_plain).abs().max())
    be, bs = cd.cobi_fused_best_batched_cuda(*(opd[k] for k in fused_keys), **full)
    winners = {}
    for k, (b, si, slot) in enumerate(slots):
        n, lanes = slot.n, slice(slot.offset, slot.offset + slot.n)
        i = int(torch.argmin(e_two[k]))  # first minimum
        q = insts[slot.job_id]
        if not (float(be[b, si]) == float(e_two[k, i]) and torch.equal(bs[b, si, lanes], s_stack[k, i, :n])):
            fail(f"fused batched != two-launch drain + first argmin for job {slot.job_id}")
        if float(kref.ref_ising_energy(bs[b, si, lanes][None], q.h, q.j)[0]) != float(be[b, si]):
            fail(f"fused batched energy of job {slot.job_id} is not exact on re-scoring")
        solo = {}
        for name in ("j", "ju"):
            solo[name] = torch.zeros((128, 128), device=dev)
            solo[name][:n, :n] = opd[name][b, lanes, lanes]
        for name in ("h", "hu"):
            solo[name] = torch.zeros((1, 128), device=dev)
            solo[name][0, :n] = opd[name][b, 0, lanes]
        solo["phi0"] = torch.zeros((READS, 128), device=dev)
        solo["phi0"][:, :n] = opd["phi0"][b, :, lanes]
        solo["mask"], solo["reads"] = ops.solo_slot(128, READS, dev)
        se, ss = cd.cobi_fused_best_cuda(*(solo[k] for k in fused_keys), **full)
        if not (float(se[0]) == float(be[b, si]) and torch.equal(ss[0, :n], bs[b, si, lanes])):
            fail(f"packed winner of job {slot.job_id} != its solo fused best")
        winners[slot.job_id] = (float(be[b, si]), bs[b, si, lanes].to(torch.int8).cpu())
    print(f"batched kernels vs plain: ok ({n_jobs} jobs in {b_bins} padded bins, "
          f"S={s_pad}; packed == solo and fused == two-launch for every job)")

    # Fault 1 of the first slice: one bin of 100 one-spin jobs (S = 100,
    # padded to 104 slots) launches and agrees with its plain version.
    rng1 = np.random.default_rng(1)
    ones = [IsingProblem(h=torch.tensor([float(v)]), j=torch.zeros((1, 1)))
            for v in rng1.choice([-3, -2, -1, 1, 2, 3], 100)]
    op1, slots1 = packed_operands(ones, list(prng.split(prng.key(5), 100)), READS, dev)
    be_k, bs_k = cd.cobi_fused_best_batched_cuda(*(op1[k] for k in fused_keys), **full)
    be_p, bs_p = cd.cobi_fused_best_batched_plain(*(op1[k] for k in fused_keys), **full)
    s1 = [si for _, si, _ in slots1]
    if op1["mask"].shape[-1] != 104 or len(s1) != 100:
        fail(f"the one-spin bin has {len(s1)} slots padded to {op1['mask'].shape[-1]}")
    if not (torch.equal(be_k[0, s1], be_p[0, s1]) and torch.equal(bs_k[0, s1], bs_p[0, s1])):
        fail("100-slot bin: fused batched kernel != plain")
    exact = torch.stack([ones[sl.job_id].h[0].to(dev) * bs_k[0, si, sl.offset] for _, si, sl in slots1])
    if not torch.equal(exact, be_k[0, s1]) or not bool(torch.isinf(be_k[0, 100:]).all()):
        fail("100-slot bin: energies not exact or padding slots not +inf")
    print("100-slot bin (S=100 padded to 104): ok")
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
    want = expect(cobi_trajectory=ITERATIONS, ising_energy=ITERATIONS)
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
    want = expect(cobi_trajectory=n_inv, ising_energy=n_inv)
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
    want = expect(cobi_fused_best=ITERATIONS, cobi_readout=ITERATIONS)
    if reduced != want:
        fail(f"reduce paths launches {reduced} != {want}")
    for name in counted:
        launches[name] = direct[name] + decomposed[name] + reduced[name]

    # ------------------------------------------------------------ 4b. the chip farm
    n_docs = len(farm_docs)

    def same(a, b) -> bool:
        return (np.array_equal(a.selection, b.selection) and a.objective == b.objective
                and np.array_equal(a.curve, b.curve))

    def drive_lockstep(farm, barrier):
        """16 generators in lockstep: every generator submits its round,
        ``barrier()`` (a drain, or a flush hint to the background loop),
        then every generator reduces.  Returns the reports and the host
        seconds of each part: submit (formulation, rounding, submission),
        barrier, and reduce (waiting on futures, repair, best-of)."""
        split = dict(submit=0.0, barrier=0.0, reduce=0.0)
        t = time.perf_counter()
        gens = [pipeline.iter_solve_es(doc, k, farm_cfg, backend=farm)
                for doc, k in zip(farm_docs, farm_keys)]
        reports, active = [None] * len(gens), set(range(len(gens)))
        for g in gens:
            next(g)
        split["submit"] += time.perf_counter() - t
        while active:
            t = time.perf_counter()
            barrier()
            split["barrier"] += time.perf_counter() - t
            t = time.perf_counter()
            for i in sorted(active):
                try:
                    gens[i].send(None)
                except StopIteration as done:
                    reports[i] = done.value
                    active.discard(i)
            split["reduce"] += time.perf_counter() - t
        return reports, split

    def span_seconds(farm) -> dict:
        """Wall seconds per farm span name (the drain's pack, place, launch
        and readout phases) from the farm's tracer."""
        out: dict = {}
        for r in farm.obs.tracer.records():
            if r["kind"] == "span" and r["name"] != "farm.job":
                out[r["name"]] = out.get(r["name"], 0.0) + r["t1"] - r["t0"]
        return {k: round(v, 6) for k, v in sorted(out.items())}

    def farm_line(label, farm, wall, c, n_req) -> None:
        st = farm.stats()
        print(f"{label}: wall {wall:.3f} s drains {st.drains} bins {st.super_instances} "
              f"occupancy {st.mean_occupancy:.4f} bytes/request h2d {st.bytes_h2d / n_req:.1f} "
              f"d2h {st.bytes_d2h / n_req:.1f} launches {c}")
        want = expect(cobi_fused_best_batched=st.drains)  # one (schedule, tier) group
        if c != want:
            fail(f"{label} launches {c} != {want} ({st.drains} drains of one group each)")

    reset_counts()
    t0 = time.perf_counter()
    inline = [solve_es(doc, k, farm_cfg) for doc, k in zip(farm_docs, farm_keys)]
    torch.cuda.synchronize()
    inline_wall = time.perf_counter() - t0
    c = counts()
    print(f"farm mix inline: {n_docs} documents wall {inline_wall:.3f} s launches {c}")
    if c != expect(cobi_trajectory=n_docs * FARM_ITERATIONS, ising_energy=n_docs * FARM_ITERATIONS):
        fail(f"farm mix inline launches {c}")
    for name in counted:
        launches[name] += c[name]

    for policy in ("manual", "bin-full"):
        farm = CobiFarm(4, policy=policy, obs=Observability())
        reset_counts()
        t0 = time.perf_counter()
        reps, split = drive_lockstep(farm, farm.drain if policy == "manual" else farm.flush_hint)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        farm.close()
        farm_line(f"farm {policy}: {n_docs} documents (inline {inline_wall:.3f} s)", farm, wall,
                  c, n_docs)
        print(f"farm {policy} host split (s): " + " ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; drain spans (s): {span_seconds(farm)}")
        for i, (a, b) in enumerate(zip(inline, reps)):
            if not same(a, b):
                fail(f"farm {policy} document {i}: {b.objective} != inline {a.objective}")
        for name in counted:
            launches[name] += c[name]
    print(f"farm paths: all {n_docs} documents equal their inline solves bitwise")

    # The submit phase of the lockstep drive, split: the formulation per
    # document, the stochastic roundings per iteration (on the card), and
    # the farm's submit (host copy of each instance, programmability check).
    t = time.perf_counter()
    forms = [improved_ising(doc) for doc in farm_docs]
    torch.cuda.synchronize()
    t_form = time.perf_counter() - t
    t = time.perf_counter()
    rounded = [(quantize_ising(fp, key=kq).ising, ks) for fp, k in zip(forms, farm_keys)
               for kq, ks in pipeline._iteration_keys(k, FARM_ITERATIONS)]
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t
    probe = CobiFarm(4)
    t = time.perf_counter()
    for q, ks in rounded:
        probe.submit(q, ks, reads=READS, steps=STEPS, reduce="best")
    t_submit = time.perf_counter() - t
    probe.close(drain=False)
    print(f"farm submit split (s): formulation {t_form:.4f} ({n_docs} documents) rounding "
          f"{t_round:.4f} ({len(rounded)} instances) submit {t_submit:.4f}")

    farm = CobiFarm(4)
    reset_counts()
    t0 = time.perf_counter()
    drep_farm = solve_es(big, prng.key(1), dcfg, backend=farm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    farm_line(f"farm decomposed: N={big.n} pipelined windows (inline decomposed above)", farm,
              wall, c, 1)
    if not (np.array_equal(drep_farm.selection, drep.selection)
            and drep_farm.objective == drep.objective):
        fail(f"farm decomposed {drep_farm.objective} != inline decomposed {drep.objective}")
    for name in counted:
        launches[name] += c[name]

    # The two-launch drain (reduce="none"): every read of the 96 instances
    # comes back; each job's first argmin is the fused winner of phase 3b.
    reset_counts()
    t0 = time.perf_counter()
    results = cobi_solver.solve_batch(insts, [k for _, k in farm_jobs], n_chips=4,
                                      reads=READS, steps=STEPS, reduce="none")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    print(f"farm reduce=none: {n_jobs} jobs wall {wall:.3f} s launches {c}")
    if c != expect(cobi_trajectory_batched=1, ising_energy_batched=1):
        fail(f"farm reduce=none launches {c} != one drain of one group")
    for k, res in enumerate(results):
        i = int(np.argmin(res.energies.numpy()))
        e, s_best = winners[k]
        if not (float(res.energies[i]) == e and torch.equal(res.spins[i], s_best)):
            fail(f"reduce=none job {k}: first argmin != fused winner")
    for name in counted:
        launches[name] += c[name]

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

    # The batched kernels at the 16-document drain's shapes: the fused best
    # and the trajectory on its padded bins (B, R=8, 128 lanes, S slots),
    # the stacked energy on the two-launch drain's (jobs, R=8, 128) stack.
    # Unpadded: each job's own n spins, its reads and its one slot.
    fused_ops = [opd[k] for k in fused_keys]
    job_shapes = [(READS, slot.n, 1) for _, _, slot in slots]
    batched = {
        "cobi_trajectory_batched": (
            lambda: cd.cobi_trajectory_batched_cuda(opd["j"], opd["h"], opd["phi0"], **full),
            lambda: cd.cobi_trajectory_batched_plain(opd["j"], opd["h"], opd["phi0"], **full),
            "src/repro/kernels/cobi_dynamics.py:262", "cobi_dynamics.cu",
            [(READS, 128, s_pad)] * b_bins),
        "ising_energy_batched": (
            lambda: ie.ising_energy_batched_cuda(s_stack, h_stack, j_stack),
            lambda: ie.ising_energy_batched_plain(s_stack, h_stack, j_stack),
            "src/repro/kernels/ising_energy.py:69", "ising_energy.cu",
            [(READS, 128, 0)] * n_jobs),
        "cobi_fused_best_batched": (
            lambda: cd.cobi_fused_best_batched_cuda(*fused_ops, **full),
            lambda: cd.cobi_fused_best_batched_plain(*fused_ops, **full),
            "src/repro/kernels/cobi_dynamics.py:358", "cobi_dynamics.cu",
            [(READS, 128, s_pad)] * b_bins),
    }
    for name, (kern, plain, replaces, source, shapes) in batched.items():
        energy = name == "ising_energy_batched"
        ms = cuda_ms(kern, reps=200 if energy else 10)
        plain_ms = cuda_ms(plain, reps=20 if energy else 2, warmup=1)
        b_ms, by = bound_ms(*batched_work(name, shapes))
        u_ms, u_by = bound_ms(*batched_work(name, job_shapes))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "bound_unpadded_ms": u_ms, "bound_unpadded_by": u_by,
        })
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({by}) at {len(shapes)} x (R={READS}, N=128, S={shapes[0][2]}), "
              f"{u_ms:.6f} ms ({u_by}) at the {n_jobs} jobs' own n; steps={STEPS}")
    if any(row["launches"] == 0 for row in rows):
        fail(f"a kernel of the path never launched: {[r['name'] for r in rows if not r['launches']]}")

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
