"""Deterministic synthetic news-style corpus.

CNN/DailyMail and XSum are not downloadable offline, so the pipeline draws
readable template documents whose sentences mix a few topics (dense,
topic-structured redundancy).  :func:`synthetic_document` is host numpy and
gives the reference's text exactly; :func:`scores_from_embeddings` turns
sentence embeddings into the paper's mu and beta.  The reference's direct
embedding generator (``synthetic_embeddings``, ``benchmark_suite``) waits
for ``normal`` and ``randint`` in ``repro_torch.prng``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

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
