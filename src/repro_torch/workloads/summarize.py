"""Extractive summarization: the paper's task, as a zoo workload.

Selects ``m`` sentences maximizing centrality minus pairwise redundancy
(paper Eqs. 1-2).  This is EXACTLY the spec the legacy
``SummarizeRequest(text=...)`` surface builds internally, so a request from
this builder is bit-identical to the legacy path for the same seed/id.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.data.text import split_sentences
from repro_torch.serving.api import KofnSpec, SelectionRequest
from repro_torch.workloads.base import register_workload


@register_workload("summarize",
                   "extractive summarization: m central, non-redundant "
                   "sentences of one document")
def build(*, text: Optional[str] = None,
          sentences: Optional[List[str]] = None,
          m: int = 6, lam: float = 0.5) -> SelectionRequest:
    """``text`` is split with the same splitter the engine uses; pass
    ``sentences`` to skip splitting."""
    if (text is None) == (sentences is None):
        raise ValueError("pass exactly one of text= or sentences=")
    items = split_sentences(text) if text is not None else list(sentences)
    return SelectionRequest(
        items=items,
        kofn=KofnSpec(m=m, lam=lam, relevance="centroid"),
        workload="summarize",
    )
