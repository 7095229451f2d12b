"""The one traffic generator: it reads a mix's data file
(``h100bench/traffic/<mix>.json``) and makes the documents from ``--seed``.
How requests arrive and what they ask for are named by the mix and found by
name: ``arrivals/<arrivals>.py`` and ``requests/<request>.py``.

A mix file holds:

* ``arrivals``: the arrival process (``closed``: ``clients`` callers, each
  sending its next request when its answer returns);
* ``request``: the request kind (``summarize``);
* ``sentences``: [lo, hi], the sentence counts, uniform;
* ``m``, ``lam``: the summary's length and the redundancy weight;
* ``warm_seconds``: traffic run before the measured window opens (set-up);
* what its arrival process reads (``clients``).

The k-th document is a function of (seed, k) alone: document id base + k
with a base drawn from the seed, its size from a permutation of the whole
span drawn a block at a time, so that every seed sends the same multiset of
sizes in its own order.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache
from pathlib import Path

import numpy as np

from h100bench import inputs

BENCH = Path(__file__).resolve().parent


def plugin(kind: str, name: str, bench: Path | None = None):
    """The module ``<bench>/<kind>/<name>.py``."""
    path = (bench or BENCH) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"h100bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Traffic:
    def __init__(self, mix: dict, seed: int, bench: Path | None = None):
        self.mix = mix
        self.seed = int(seed)
        self.arrivals = plugin("arrivals", mix["arrivals"], bench)
        self.request = plugin("requests", mix["request"], bench)
        self.lo, self.hi = mix["sentences"]
        self.m = int(mix["m"])
        self.lam = float(mix["lam"])
        self.warm_seconds = float(mix["warm_seconds"])
        self.in_flight = int(self.arrivals.in_flight(mix))
        self._base = int(inputs.document_ids(self.seed, 1)[0])

    def size(self, k: int) -> int:
        span = self.hi - self.lo + 1
        return int(self._block_perm(2, k // span, span)[k % span]) + self.lo

    def document(self, k: int) -> tuple[int, list[str]]:
        """(document id, sentences) of the k-th request."""
        doc_id = self._base + k
        return doc_id, inputs.synthetic_document(doc_id, self.size(k))

    def priority(self, k: int) -> int:
        """A number drawn from (seed, k): the sample judged a run is the
        requests of the window with the least of these."""
        x = (self.seed * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9 + 1) & (2 ** 64 - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
        return x ^ (x >> 31)

    @lru_cache(maxsize=4096)
    def _block_perm(self, stream: int, block: int, n: int) -> np.ndarray:
        return np.random.default_rng([self.seed % (2 ** 63), stream, block]).permutation(n)

    def length_buckets(self, max_len: int) -> list[int]:
        """Every encoder length bucket a document of this mix can land in: a
        bucket b (a power of two from 64, capped at the context) holds the
        token counts in (b / 2, b]."""
        lo_tok = min(1 + self.lo * (inputs.SENTENCE_BYTES[0] + 1), max_len)
        hi_tok = min(1 + self.hi * (inputs.SENTENCE_BYTES[1] + 1), max_len)
        out, b = [], 64
        while b <= max_len:
            if b >= lo_tok and (b == 64 or b // 2 < hi_tok):
                out.append(b)
            b *= 2
        return out
