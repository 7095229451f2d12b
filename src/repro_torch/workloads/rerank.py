"""Diverse retrieval re-ranking: pick k results relevant to a query AND
different from each other.

The first-stage retriever's top-n candidates are re-scored as one k-of-n
selection: mu_i = cos(e_i, e_query) (the query rides the same encode batch
as the candidates -- one encoder pass per request), beta_ij = candidate
cosine redundancy.  The selected set is the re-ranked page; lam is the
relevance/diversity dial (0 = pure relevance top-k, large = MMR-like
diversity)."""

from __future__ import annotations

from typing import List

from repro_torch.serving.api import KofnSpec, SelectionRequest
from repro_torch.workloads.base import register_workload


@register_workload("rerank",
                   "diverse retrieval re-ranking: k query-relevant, "
                   "mutually-diverse candidates")
def build(*, query: str, candidates: List[str], k: int,
          lam: float = 0.7) -> SelectionRequest:
    return SelectionRequest(
        items=list(candidates),
        kofn=KofnSpec(m=k, lam=lam, relevance="query", query=query),
        workload="rerank",
    )
