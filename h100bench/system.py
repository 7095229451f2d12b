"""The system under test, built from a configuration file: the port's
``SummarizationEngine`` with the keywords of the configuration's ``engine``
block, behind the front end the configuration names
(``front_ends/<front_end>.py``): the port's ``EncoderStage`` over a dense
encoder whose weights the benchmark makes from the seed, or the engine's
hashed bag-of-words encoder.

The benchmark takes from the program only this engine and its spans,
counters and kernel names; it never calls the program's own reference
paths.
"""

from __future__ import annotations

import math


def solve_config(config: dict):
    from repro_torch.core import SolveConfig

    return SolveConfig(**config["solve"])


# Engine arguments the harness sets itself; a configuration's ``engine``
# block may set any other keyword of ``SummarizationEngine``.
HARNESS_OWNED = frozenset({"self", "solve_cfg", "encoder", "seed", "obs", "tracing", "device"})


def engine_kwargs(config: dict) -> dict:
    """The configuration's ``engine`` block, checked against the engine's
    keywords: a key it does not take is an error, not a default."""
    import inspect

    from repro_torch.serving.engine import SummarizationEngine

    taken = set(inspect.signature(SummarizationEngine.__init__).parameters) - HARNESS_OWNED
    wrong = sorted(set(config["engine"]) - taken)
    if wrong:
        raise ValueError(f"SummarizationEngine takes no {wrong} from a configuration "
                         f"(it takes {sorted(taken)})")
    return dict(config["engine"])


def build_engine(config: dict, seed: int, device, *, tracing: bool, trace_capacity: int):
    """(engine, stage or None).  The front end is the plug-in
    ``front_ends/<front_end>.py`` the configuration names: its ``build``
    returns the engine's encoder and, for an encoder that runs as a second
    pipeline stage, that stage."""
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import SummarizationEngine

    from h100bench.generator import plugin

    encoder, stage = plugin("front_ends", config["front_end"]).build(config, seed, device)
    engine = SummarizationEngine(
        solve_config(config), encoder=encoder, seed=int(seed) % (2 ** 31),
        obs=Observability(tracing=tracing, capacity=trace_capacity), tracing=tracing,
        device=device, **engine_kwargs(config),
    )
    return engine, stage


def prewarm(engine, stage, config: dict, shapes: dict) -> int:
    """Run every shape the cell's traffic can reach once: the encoder's
    (batch, length, segments) lattice and the farm's drain lattice.
    ``shapes`` holds the traffic's ``lengths``, ``batches``, ``segments``,
    ``max_bins`` and ``max_slots``.  Returns the launches run."""
    n = 0
    if stage is not None:
        n += stage.prewarm(lengths=shapes["lengths"], batches=shapes["batches"],
                           segments=shapes["segments"])
    farm = engine.farm
    if farm is not None:
        solve = config["solve"]
        n += farm.prewarm(reads=(solve["reads"],), steps=solve["steps"],
                          max_bins=shapes["max_bins"], max_slots=shapes["max_slots"])
    return n


def pow2_bucket(n: int, base: int) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def traffic_shapes(config: dict, traffic) -> dict:
    """Every shape the traffic can reach: the encoder stage's (length bucket,
    batch bucket, segment bucket) lattice (its rules: lengths from 64 in
    powers of two capped at the context, batches from 4, segments from 8),
    and the farm's drain lattice (:func:`farm_shapes`)."""
    shapes = farm_shapes(config, traffic.lo, traffic.hi, traffic.in_flight)
    enc = config.get("encoder")
    if enc is not None:
        shapes.update(
            lengths=traffic.length_buckets(enc["max_len"]),
            batches=sorted({pow2_bucket(b, 4) for b in range(1, traffic.in_flight + 1)}),
            segments=sorted({pow2_bucket(n, 8) for n in range(traffic.lo, traffic.hi + 1)}))
    return shapes


def farm_shapes(config: dict, n_min: int, n_max: int, clients: int) -> dict:
    """The farm's reachable drain lattice: every in-flight request's jobs in
    one drain at worst (a direct request: ``iterations`` jobs of up to
    ``n_max`` lanes; a decomposed one: its speculated windows of p lanes)."""
    solve, lanes = config["solve"], 128
    per_req = n_max if n_max <= 59 else solve["p"] * (2 + solve.get("speculate_depth", 2))
    lanes_total = clients * solve["iterations"] * per_req
    min_n = min(n_min, solve["p"])
    return {"max_bins": math.ceil(lanes_total / lanes) + 2,
            "max_slots": max(1, lanes // min_n)}
