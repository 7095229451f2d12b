"""Deterministic synthetic news-style corpus.

CNN/DailyMail and XSum are not downloadable offline, so benchmarks draw from
a topic-mixture generator whose induced Ising statistics match the paper's
regime: dense redundancy beta, relevance mu in roughly (0.3, 0.95), high
redundancy for same-topic sentence pairs.

Two layers, as in the reference:
  * :func:`synthetic_embeddings` -- unit-norm sentence embeddings drawn
    directly from ``repro_torch.prng`` (the reference's draws; its
    ``normal`` within 2 ulp, so embeddings agree within rtol 1e-5);
  * :func:`synthetic_document` -- readable template text, host numpy, the
    reference's text exactly.

:func:`scores_from_embeddings` turns sentence embeddings into the paper's
mu and beta.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device

TOPICS = [
    "the city council budget vote",
    "the championship final result",
    "the new vaccine trial data",
    "the coastal storm damage",
    "the quarterly earnings report",
    "the wildfire evacuation order",
    "the transit strike negotiations",
    "the satellite launch schedule",
]

_TEMPLATES = [
    "Officials said {t} would be reviewed on {d}.",
    "Residents reacted to {t} with a mixture of relief and concern.",
    "Analysts noted that {t} had shifted expectations for {d}.",
    "A spokesperson declined to comment on {t}.",
    "Early reports about {t} were revised later on {d}.",
    "Witnesses described {t} in detail to reporters.",
    "The committee linked {t} to broader regional trends.",
    "Experts cautioned that {t} remained uncertain pending {d}.",
]
_DATES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday"]


def synthetic_embeddings(
    key: torch.Tensor,
    n_sentences: int,
    *,
    dim: int = 64,
    n_topics: int = 4,
    topic_strength: float = 2.2,
    device=None,
) -> torch.Tensor:
    """(N, dim) unit-norm embeddings from a topic mixture, on ``device``
    (``None``: the card).

    Each sentence = document component + strong topic component + isotropic
    noise, normalized: same-topic pairs are redundant, cross-topic pairs
    stay moderately correlated through the document component (dense beta).
    """
    device = resolve_device(device)
    k_doc, k_topic, k_assign, k_noise, k_w = prng.split(key, 5)
    doc = prng.normal(k_doc, (dim,), device=device)
    topics = prng.normal(k_topic, (n_topics, dim), device=device)
    assign = prng.randint(k_assign, (n_sentences,), 0, n_topics, device=device)
    noise = prng.normal(k_noise, (n_sentences, dim), device=device)
    weight = prng.uniform(k_w, (n_sentences, 1), 0.6, 1.4, device=device)
    e = doc[None] + topic_strength * weight * topics[assign.long()] + noise
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


def scores_from_embeddings(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eqs. (1)-(2): mu_i = cos(e_i, mean_doc); beta_ij = cos(e_i, e_j).

    An exactly-zero row scores mu=0, beta=0 instead of NaN (the eps guard);
    nonzero rows divide by their exact norm."""
    e = e.to(torch.float32)
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-9)
    doc = e.mean(dim=0)
    doc = doc / torch.clamp(torch.linalg.norm(doc), min=1e-9)
    mu = e @ doc
    beta = e @ e.T
    beta = beta * (1.0 - torch.eye(e.shape[0], dtype=e.dtype, device=e.device))
    return mu, beta


def synthetic_benchmark(
    seed: int, n_sentences: int, m: int, *, lam: float = 1.0, dim: int = 64, device=None
):
    """One benchmark instance: an EsProblem built from synthetic embeddings."""
    from repro_torch.core.formulation import EsProblem

    e = synthetic_embeddings(prng.key(seed), n_sentences, dim=dim, device=device)
    mu, beta = scores_from_embeddings(e)
    return EsProblem(mu=mu, beta=beta, m=m, lam=lam)


def benchmark_suite(
    n_benchmarks: int, n_sentences: int, m: int = 6, *, lam: float = 1.0, seed0: int = 0,
    device=None,
):
    """The paper's '20 benchmarks of N-sentence paragraphs' analogue."""
    return [
        synthetic_benchmark(seed0 + i, n_sentences, m, lam=lam, device=device)
        for i in range(n_benchmarks)
    ]


def synthetic_document(seed: int, n_sentences: int) -> List[str]:
    """Readable synthetic article text (for the tokenizer/embedder path)."""
    rng = np.random.default_rng(seed)
    doc_topics = rng.choice(
        len(TOPICS), size=min(len(TOPICS), max(2, n_sentences // 6)), replace=False
    )
    sents = []
    for i in range(n_sentences):
        t = TOPICS[int(rng.choice(doc_topics))]
        tpl = _TEMPLATES[int(rng.integers(len(_TEMPLATES)))]
        d = _DATES[int(rng.integers(len(_DATES)))]
        sents.append(tpl.format(t=t, d=d))
    return sents
