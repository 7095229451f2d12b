"""Multi-document sentence selection: one pooled k-of-n over every
document's sentences.

All documents' sentences are pooled into a single item list and selected
jointly -- cross-document redundancy (the same fact reported by two
sources) is penalized exactly like within-document redundancy, which is
what separates this from summarizing each document alone.  Use
:func:`doc_index` to map selected items back to their source documents.
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.data.text import split_sentences
from repro_torch.serving.api import KofnSpec, SelectionRequest
from repro_torch.workloads.base import register_workload


def flatten(documents: List[str]) -> Tuple[List[str], List[int]]:
    """Pool every document's sentences; returns (items, doc_of) where
    ``doc_of[i]`` is the source document index of ``items[i]``."""
    items: List[str] = []
    doc_of: List[int] = []
    for d, text in enumerate(documents):
        sents = split_sentences(text)
        items.extend(sents)
        doc_of.extend([d] * len(sents))
    return items, doc_of


def doc_index(documents: List[str]) -> List[int]:
    """``doc_of`` for the items :func:`build` produces from ``documents``."""
    return flatten(documents)[1]


@register_workload("multidoc",
                   "multi-document selection: m sentences pooled across "
                   "documents, cross-source redundancy penalized")
def build(*, documents: List[str], m: int = 6,
          lam: float = 0.8) -> SelectionRequest:
    items, _ = flatten(documents)
    return SelectionRequest(
        items=items,
        kofn=KofnSpec(m=m, lam=lam, relevance="centroid"),
        workload="multidoc",
    )
