"""Tiny stand-ins of the benchmark's configurations and mixes, for CPU
rehearsals of a run: the encoder at the port's ``reduced()`` widths (the
flash route runs the kernel's plain version on a CPU tensor), in float32
unless asked otherwise (at 64 wide, bf16's rounding reads as high as the
full width's limit), a short anneal, two requests in flight, a window of a
second."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 977  # more than 32 signed bits hold, as a run's seed may be

# Cells that BENCHMARK.json leaves out (their summaries_per_s spreads too
# widely on the card's host for any bound it may set; PERF.md §7), with the
# metrics they would report.  They are rehearsed all the same: their files
# (the bag-of-words front end, the decomposed mix) stay for a later cell.
LEFT_OUT_CONFIGS = [
    {"name": "es-bow-cobi", "source": "arXiv:2601.11491 improved k-of-n Ising pipeline behind "
     "the repo's default hashed bag-of-words front end", "file": "h100bench/configs/es-bow-cobi.json",
     "reduced": [], "why": "the same engine, rounding, farm and kernels without the model"},
]
LEFT_OUT = [
    {"name": "es-bow-cobi.long-decomposed", "config": "es-bow-cobi",
     "traffic": "long-decomposed", "chips": 1, "why": "every request decomposed"},
    {"name": "es-bow-cobi.news-batch", "config": "es-bow-cobi", "traffic": "news-batch",
     "chips": 1, "why": "the first cell without the encoder"},
]
LEFT_OUT_METRICS = ("summaries_per_s", "solve_ms_p50", "farm_jobs_per_drain", "cobi_roofline",
                    "idle_share", "kernels_per_summary")


def _rehearsal(manifest: dict) -> dict:
    out = copy.deepcopy(manifest)
    out["configs"] += copy.deepcopy(LEFT_OUT_CONFIGS)
    out["workloads"] += copy.deepcopy(LEFT_OUT)
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in LEFT_OUT_METRICS:
            m["workloads"] += [c["name"] for c in LEFT_OUT]
    return out


# BENCHMARK.json with the left-out cells: what the rehearsals run.
REHEARSAL = _rehearsal(MANIFEST)
CELLS = [c["name"] for c in REHEARSAL["workloads"]]


def cell(name: str) -> dict:
    return next(c for c in REHEARSAL["workloads"] if c["name"] == name)


def config(name: str, dtype: str | None = "float32") -> dict:
    """The configuration cut to a tiny encoder, in ``dtype`` (None: the
    configuration's own), and a short anneal."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if cfg.get("encoder") is not None:
        cfg["encoder"].update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                              intermediate_size=128, vocab_size=512, max_len=512)
        if dtype is not None:
            cfg["encoder"]["dtype"] = dtype
    cfg["solve"].update(steps=60, iterations=3, reads=8)
    return cfg


def mix(name: str) -> dict:
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    m.update(warm_seconds=0.3, clients=2)
    lo, hi = m["sentences"]
    m["sentences"] = [60, 64] if lo > 59 else [6, 10]
    return m


def limits(name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{name}.json").read_text())


def run(cell_name: str, *, trace: bool = False, seconds: float | None = None,
        seed: int = SEED) -> dict:
    """One run of the cell at its tiny size on the CPU, through the harness:
    a window of a second, or three where every request is decomposed (a
    request then takes about a second on a loaded CPU)."""
    import time

    import torch

    from h100bench import harness

    c = cell(cell_name)
    if seconds is None:
        seconds = 3.0 if mix(c["traffic"])["sentences"][0] > 59 else 1.0
    return harness.run_cell(copy.deepcopy(REHEARSAL), cell_name, seed=seed, seconds=seconds,
                            trace=trace, device=torch.device("cpu"),
                            t_process=time.perf_counter(), config=config(c["config"]),
                            mix=mix(c["traffic"]), limits_file=limits(c["config"]),
                            log=lambda s: None)
