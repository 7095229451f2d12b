"""Plain NumPy hashed bag-of-words sentence embeddings: each lower-cased
word ([a-z0-9']+) maps to a unit Gaussian vector drawn from a generator
seeded by the blake2b hash of "<seed>:<word>"; a sentence is the unit-norm
sum of its words' vectors, or e_0 when it has none.  Sums in float64.
``quant="bf16"`` is the control: every word vector and every partial sum
rounded to bfloat16."""

from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

_WORD_RE = re.compile(r"[a-z0-9']+")


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).to(
        torch.float64).numpy()


def word_vector(word: str, dim: int, seed: int) -> np.ndarray:
    h = hashlib.blake2b(f"{seed}:{word}".encode(), digest_size=8).digest()
    v = np.random.default_rng(int.from_bytes(h, "little")).standard_normal(dim)
    return v / np.linalg.norm(v)


def embed_document(sentences, dim: int, seed: int, quant: str | None = None) -> np.ndarray:
    """(len(sentences), dim) float64 unit rows."""
    if quant not in (None, "bf16"):
        raise ValueError(f"unknown control precision {quant!r}")
    rnd = _bf16 if quant == "bf16" else (lambda a: a)
    cache: dict[str, np.ndarray] = {}
    out = np.zeros((len(sentences), dim), np.float64)
    for i, s in enumerate(sentences):
        acc = np.zeros(dim, np.float64)
        for word in _WORD_RE.findall(s.lower()):
            if word not in cache:
                cache[word] = rnd(word_vector(word, dim, seed))
            acc = rnd(acc + cache[word])
        n = np.linalg.norm(acc)
        if n > 0:
            out[i] = rnd(acc / n)
        else:
            out[i, 0] = 1.0
    return out
