#!/usr/bin/env python3
"""Where the time of a host-solver solve goes on the card: Tabu and SA.

    PYTHONPATH=src python3 tools/solver_profile.py [--device cuda|cpu]

On the direct document (``synthetic_document(7, 20)``, M 6, lambda 0.5,
key 0), the first iteration's rounded instance under
``SolveConfig(solver=...)`` and its solve key, 8 replicas:

  * ``wall`` -- one ``ising_solver(name)`` solve ended by a synchronise,
    median and least of 10 after two warm-up solves;
  * under ``torch.profiler`` (CPU and CUDA activity), one more solve: the
    device kernels it launched, their summed device time, that time over
    the unprofiled median wall (the device's busy share), the loop's steps
    and the kernels and host microseconds per step;
  * for SA, its host key chain on its own: ``prng.split_chain`` of the
    ``60 n`` steps (3 threefry hashes of scalars a step, in Python
    integers), and the device draws of every step's picks and uniforms
    (``randint_many`` + ``uniform_many``), each the median of 5;
  * the same at N 100 (``synthetic_document(11, 100)``, M 6), the shape of
    the ``reference_bounds`` fallback, with Tabu at its 32 replicas and
    ``30 n`` steps.

Prints the card and its power limit first and one JSON line
``{"solver_profile": ...}`` last.  ``--device cpu`` runs the same on the CPU
(no device numbers) to check the script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        sys.exit("solver_profile: torch.cuda.is_available() is False: it needs a GPU")
    sys.path.append(str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.core import SolveConfig, improved_ising, pipeline
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import problem_from_sentences
    from repro_torch.solvers import ising_solver, tabu

    dev = torch.device(args.device)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
            if on_card else "cpu")
    print(card)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def walls(fn, reps: int) -> list[float]:
        for _ in range(2):
            fn()
        sync()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append(time.perf_counter() - t0)
        return out

    def profiled(fn) -> tuple[int, float, float]:
        """Device kernels, their device milliseconds, and the wall (ms)
        of one call under the profiler."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        kernels, dev_us = 0, 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
                kernels += ev.count
                dev_us += ev.self_device_time_total
        return kernels, dev_us / 1e3, wall * 1e3

    def instance(sentences, m: int, name: str, fallback: bool):
        problem = problem_from_sentences(sentences, m=m, lam=0.5, device=dev)
        if fallback:  # reference_bounds' Tabu runs on the float instance
            return improved_ising(problem), prng.split(prng.key(0))[0]
        cfg = SolveConfig(solver=name)
        (kq, ks), = pipeline._iteration_keys(prng.key(0), 1)
        return pipeline._quantized_instance(pipeline._build_ising(problem, cfg), cfg, kq), ks

    report = {"card": card, "device": str(dev), "cases": []}
    cases = [("tabu", 20, 8, None), ("sa", 20, 8, None), ("tabu", 100, 32, "fallback"),
             ("sa", 100, 8, None)]
    docs = {20: (synthetic_document(7, 20), 6), 100: (synthetic_document(11, 100), 6)}
    for name, n, reads, note in cases:
        ising, ks = instance(*docs[n], name, note == "fallback")
        if note == "fallback":  # reference_bounds' Tabu: 32 replicas, 30 n steps
            steps = 30 * n
            fn = lambda: tabu.solve(ising, ks, replicas=reads, iters=steps)  # noqa: E731
        else:
            steps = max(40, 12 * n) if name == "tabu" else 60 * n
            solver = ising_solver(name)
            fn = lambda: solver(ising, ks, reads=reads)  # noqa: E731
        ws = walls(fn, REPS if n == 20 else 3)
        wall_ms = statistics.median(ws) * 1e3
        kernels, dev_ms, prof_wall_ms = profiled(fn)
        row = {"solver": name, "n": n, "replicas": reads, "steps": steps,
               "wall_ms": wall_ms, "wall_min_ms": min(ws) * 1e3, "profiled_wall_ms": prof_wall_ms,
               "kernels": kernels if on_card else None,
               "device_ms": dev_ms if on_card else None,
               "busy_share": dev_ms / wall_ms if on_card else None,
               "kernels_per_step": kernels / steps if on_card else None,
               "host_us_per_step": wall_ms * 1e3 / steps}
        if name == "sa":
            k_loop = prng.split(ks)[1]
            chain_s = [0.0] * 5
            for i in range(5):
                t0 = time.perf_counter()
                chain = prng.split_chain(k_loop, steps, 3)
                chain_s[i] = time.perf_counter() - t0

            def draws():
                prng.randint_many(chain[:, 0], (reads,), 0, n, device=dev)
                prng.uniform_many(chain[:, 1], (reads,), device=dev)

            row["split_chain_ms"] = statistics.median(chain_s) * 1e3
            row["draws_ms"] = statistics.median(walls(draws, 5)) * 1e3
            row["loop_share_ms"] = wall_ms - row["split_chain_ms"] - row["draws_ms"]
        report["cases"].append(row)
        print(f"{name} N={n} R={reads} {steps} steps: wall {wall_ms:.3f} ms a solve (median of "
              f"{len(ws)}, least {min(ws) * 1e3:.3f}); profiled: "
              + (f"{kernels} device kernels ({kernels / steps:.2f} a step), device time "
                 f"{dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.4f}" if on_card else
                 "no device numbers on the CPU")
              + f"; host {wall_ms * 1e3 / steps:.2f} us a step"
              + (f"; split_chain {row['split_chain_ms']:.3f} ms, device draws "
                 f"{row['draws_ms']:.3f} ms, the rest (the loop) {row['loop_share_ms']:.3f} ms"
                 if name == "sa" else "")
              + f" [{card}]")
    print(json.dumps({"solver_profile": report}))


if __name__ == "__main__":
    main()
