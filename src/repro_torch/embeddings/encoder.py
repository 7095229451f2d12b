"""Sentence embedders feeding the Ising pipeline's mu/beta (paper Eqs. 1-2).

Two interchangeable backends, as in the reference:
  * ``HashedBowEncoder``: deterministic hashed bag-of-words with a signed
    random projection per word (numpy + blake2b), training-free,
    bit-identical to the reference's.
  * ``BackboneEncoder``: mean-pooled hidden states per sentence of a
    text-only backbone (``models/``: ``configs/sbert_paper.py``, or a
    dense, moe, hybrid or ssm config) via ``models.embed_sentences``;
    ``embeddings/serving.py`` batches it.
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
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.embeddings.serving import _embed_batch

_WORD_RE = re.compile(r"[a-z0-9']+")


class HashedBowEncoder:
    def __init__(self, dim: int = 256, seed: int = 0, cache_words: int = 65536):
        self.dim = dim
        self.seed = seed
        # LRU-bounded: word vectors are pure functions of (seed, word), so
        # eviction only costs a recompute.
        self.cache_words = max(0, cache_words)
        self._word_cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._hits = 0
        self._misses = 0

    def _word_vec(self, word: str) -> np.ndarray:
        v = self._word_cache.get(word)
        if v is not None:
            self._hits += 1
            self._word_cache.move_to_end(word)
            return v
        self._misses += 1
        h = hashlib.blake2b(f"{self.seed}:{word}".encode(), digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        v = rng.standard_normal(self.dim)
        v /= np.linalg.norm(v)
        if self.cache_words:
            self._word_cache[word] = v
            while len(self._word_cache) > self.cache_words:
                self._word_cache.popitem(last=False)
        return v

    def cache_stats(self) -> dict:
        """Word-vector cache health (surfaced by ``engine.stats()``)."""
        total = self._hits + self._misses
        return {
            "size": len(self._word_cache),
            "capacity": self.cache_words,
            "hits": self._hits,
            "misses": self._misses,
            "hit_rate": self._hits / total if total else 0.0,
        }

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


class BackboneEncoder:
    """Mean-pooled hidden states from the backbone, unit rows, on ``device``
    (``None``: the card; raises without one; the model moves there)."""

    def __init__(self, cfg, params, max_len: int = 1024, device=None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params.to(self.device)
        self.tok = ByteTokenizer()
        self.max_len = max_len

    def encode(self, sentences: Sequence[str]) -> torch.Tensor:
        tokens, seg_ids = self.tok.encode_sentences(list(sentences), self.max_len)
        return _embed_batch(self.cfg, self.params, torch.from_numpy(tokens)[None].to(self.device),
                            torch.from_numpy(seg_ids)[None].to(self.device), len(sentences))[0]


def problem_from_sentences(
    sentences: List[str], m: int, *, lam: float = 0.5, encoder=None, device=None
) -> EsProblem:
    """Encode ``sentences`` and score them into an :class:`EsProblem` on
    ``device`` (``None``: the card; raises without one)."""
    device = resolve_device(device)
    encoder = encoder or HashedBowEncoder()
    mu, beta = scores_from_embeddings(encoder.encode(sentences).to(device))
    return EsProblem(mu=mu, beta=beta, m=m, lam=lam)
