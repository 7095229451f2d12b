"""Sentence embedder feeding the Ising pipeline's mu/beta (paper Eqs. 1-2).

``HashedBowEncoder``: deterministic hashed bag-of-words with a signed random
projection per word (numpy + blake2b), training-free, bit-identical to the
reference's.  The LM-backbone encoder ports with the model stack (ROADMAP
queue 1: the encoder backbone).
"""

from __future__ import annotations

import hashlib
import re
from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem
from repro_torch.data.synthetic import scores_from_embeddings
from repro_torch.device import resolve_device

_WORD_RE = re.compile(r"[a-z0-9']+")


class HashedBowEncoder:
    def __init__(self, dim: int = 256, seed: int = 0, cache_words: int = 65536):
        self.dim = dim
        self.seed = seed
        # LRU-bounded: word vectors are pure functions of (seed, word), so
        # eviction only costs a recompute.
        self.cache_words = max(0, cache_words)
        self._word_cache: OrderedDict[str, np.ndarray] = OrderedDict()

    def _word_vec(self, word: str) -> np.ndarray:
        v = self._word_cache.get(word)
        if v is not None:
            self._word_cache.move_to_end(word)
            return v
        h = hashlib.blake2b(f"{self.seed}:{word}".encode(), digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        v = rng.standard_normal(self.dim)
        v /= np.linalg.norm(v)
        if self.cache_words:
            self._word_cache[word] = v
            while len(self._word_cache) > self.cache_words:
                self._word_cache.popitem(last=False)
        return v

    def encode(self, sentences: Sequence[str]) -> torch.Tensor:
        """(len(sentences), dim) float32 unit rows on the CPU."""
        out = np.zeros((len(sentences), self.dim), np.float32)
        for i, s in enumerate(sentences):
            for w in _WORD_RE.findall(s.lower()):
                out[i] += self._word_vec(w)
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
            else:
                out[i, 0] = 1.0
        return torch.from_numpy(out)


def problem_from_sentences(
    sentences: List[str], m: int, *, lam: float = 0.5, encoder=None, device=None
) -> EsProblem:
    """Encode ``sentences`` and score them into an :class:`EsProblem` on
    ``device`` (``None``: the card; raises without one)."""
    device = resolve_device(device)
    encoder = encoder or HashedBowEncoder()
    mu, beta = scores_from_embeddings(encoder.encode(sentences).to(device))
    return EsProblem(mu=mu, beta=beta, m=m, lam=lam)
