"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed in the nearest precision
below the one the configuration states (fp8 for the bf16 encoder, bf16 for
the float32 bag-of-words and the float32 formulation), answering the same
documents a run samples, and judged by the same numbers.  It has to come
out not correct.

    python3 -m h100bench.control --cell es-sbert-cobi.news-batch --seeds 11 12 13

prints one line of readings a seed (run it from the repository root on the
card; ``--device cpu`` for the bag-of-words configuration).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from h100bench import reference
from h100bench.generator import Traffic
from h100bench.reference import check, formulation, scores

BENCH = Path(__file__).resolve().parent
COBI_SPINS = 59  # the most spins a COBI chip holds; a larger document is decomposed


def readings(config: dict, mix: dict, limits_file: dict, seed: int, device,
             n_docs: int) -> dict:
    """The control's numbers over ``n_docs`` documents of the mix drawn from
    ``seed``, their limits, and whether it passed.  Its answer is the best
    selection under its own mu and beta; its formulations are those of the
    windows the solver would see (the whole document up to the chip's 59
    spins, else its consecutive windows of p), each from its own mu and beta
    in bfloat16, one precision below the pipeline's float32."""
    traffic = Traffic(mix, seed, BENCH)
    lam, quant = float(mix["lam"]), reference.control_precision(config)
    exact = reference.embedder(config, seed, device)
    low = reference.embedder(config, seed, device, quant=quant)
    solve = config["solve"]
    judged = []
    for k in range(n_docs):
        _, sentences = traffic.document(k)
        mu, beta = scores.scores(exact(sentences))
        mu_c, beta_c = scores.scores(low(sentences))
        answer = check.control_answer(sentences, traffic.m, lam, mu_c, beta_c)
        one = check.judge_answer(sentences, traffic.m, lam, mu, beta, answer)
        one["mu_beta_gap"] = float(max(np.abs(mu_c - mu).max(), np.abs(beta_c - beta).max()))
        n = len(sentences)
        windows = ([np.arange(n)] if n <= COBI_SPINS else
                   [np.arange(i, min(i + solve["p"], n)) for i in range(0, n, solve["p"])])
        one["formulation_gap"] = 0.0
        for w in windows:
            m = traffic.m if len(w) == n else min(solve["q"], len(w))
            sub_mu, sub_beta = mu_c[w], beta_c[np.ix_(w, w)]
            h_c, j_c = formulation.improved_ising(sub_mu, sub_beta, m, lam, quant="bf16")
            h_r, j_r = formulation.improved_ising(sub_mu, sub_beta, m, lam)
            one["formulation_gap"] = max(one["formulation_gap"],
                                         formulation.formulation_gap(h_c, j_c, h_r, j_r))
        one.update(rounding_faults=0, energy_faults=0, window_faults=0)
        judged.append(one)
    nums = check.numbers(judged)
    lims = check.limits(limits_file)
    return {"seed": seed, "precision": quant, "numbers": nums, "limits": lims,
            "passed": check.verdict(nums, lims)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--docs", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = next(c for c in manifest["workloads"] if c["name"] == args.cell)
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = json.loads((BENCH / "limits" / f"{cell['config']}.json").read_text())
    device = torch.device(args.device)
    for seed in args.seeds:
        print(json.dumps(readings(config, mix, limits_file, seed, device, args.docs)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
