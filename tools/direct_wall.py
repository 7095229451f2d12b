#!/usr/bin/env python3
"""Host time of the inline direct solve and of its roundings, on the card.

    PYTHONPATH=src python3 tools/direct_wall.py [--solver cobi|mcmc] [--profile]

Times, after two warm-up calls each, on the direct document
(``synthetic_document(7, 20)``, M 6, lambda 0.5, key 0, with
``SolveConfig(solver=...)``'s 10 iterations x 8 reads x 400 steps; COBI by
default, or the MCMC annealer's 50 sweeps):

  * ``solve`` -- one ``solve_es`` call;
  * ``rounding`` -- one ``quantize_ising`` of the instance (the solver's
    scheme and range, an iteration's key), ten of which a solve makes;
  * ``keys`` -- ``pipeline._iteration_keys`` for the ten iterations;
  * with ``--solver mcmc``, also ``farm mix`` -- the farm benchmark's 16
    documents (``synthetic_document(100 + i, n)``, n = 10 to 40, M 5, 6
    iterations) solved inline one after another, as ``chip_smoke.py``'s
    "mcmc farm mix" line does;

each call ended by a device synchronise, and prints the median and the
least of each over 15 calls.  It imports the ``repro_torch`` that
Python finds first (this checkout's ``src`` comes last on the path), so with
another checkout's ``src`` on ``PYTHONPATH`` it times that checkout's port:
run the two alternately on one machine to compare them.  ``--profile`` also
prints the host operations of ten rounding calls under ``torch.profiler``,
by their own CPU time.  Prints the card and its power limit first.  Needs a
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 15
# benchmarks/farm_throughput.py's document sizes: synthetic_document(100 + i, n).
FARM_SIZES = [10, 14, 18, 22, 26, 30, 34, 38, 12, 16, 20, 24, 28, 32, 36, 40]


def timed(fn) -> list[float]:
    """Seconds of REPS calls of ``fn`` after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", choices=("cobi", "mcmc"), default="cobi",
                    help="the solver of the timed solves (default cobi)")
    ap.add_argument("--profile", action="store_true",
                    help="profile ten rounding calls and print their host operations")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("direct_wall: torch.cuda.is_available() is False: it needs a GPU")
    sys.path.append(str(ROOT / "src"))
    import repro_torch
    from repro_torch import prng
    from repro_torch.core import SolveConfig, improved_ising, pipeline, solve_es
    from repro_torch.core.rounding import quantize_ising
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import problem_from_sentences

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"repro_torch: {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda")
    problem = problem_from_sentences(synthetic_document(7, 20), m=6, lam=0.5, device=dev)
    key, cfg = prng.key(0), SolveConfig(solver=args.solver)
    print(f"solver: {args.solver}")
    ising = improved_ising(problem)
    (k_quant, _), = pipeline._iteration_keys(key, 1)
    parts = {
        "solve": lambda: solve_es(problem, key, cfg),
        "rounding": lambda: quantize_ising(ising, cfg.rounding, int_range=cfg.int_range,
                                           key=k_quant),
        "keys": lambda: pipeline._iteration_keys(key, cfg.iterations),
    }
    if args.solver == "mcmc":
        docs = [problem_from_sentences(synthetic_document(100 + i, n), m=5, lam=0.5, device=dev)
                for i, n in enumerate(FARM_SIZES)]
        doc_keys = list(prng.split(prng.key(0), len(docs)))
        farm_cfg = SolveConfig(solver="mcmc", iterations=6, reads=8, steps=400, int_range=14)
        parts["farm mix"] = lambda: [solve_es(d, k, farm_cfg) for d, k in zip(docs, doc_keys)]
    for name, fn in parts.items():
        ts = timed(fn)
        print(f"{name}: median {statistics.median(ts) * 1e3:.3f} ms, least {min(ts) * 1e3:.3f} ms "
              f"over {REPS} calls")
    if args.profile:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(10):
                parts["rounding"]()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
