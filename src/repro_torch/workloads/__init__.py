"""Workload zoo: named builders from domain inputs to ``SelectionRequest``.

Every workload here reduces to the same k-of-n ``EsProblem`` formulation
(the paper's "any problem that requires k of n variables to be chosen") and
is served through the engine's admission/routing/recovery stack unchanged:

  * ``summarize`` -- extractive summarization (the paper's task; the
    legacy-surface-compatible spec).
  * ``dedup``     -- MMR-style near-duplicate pruning: keep k
    representatives, redundancy-dominant lambda.
  * ``rerank``    -- diverse retrieval re-ranking: query relevance vs
    pairwise redundancy among candidates.
  * ``multidoc``  -- multi-document sentence selection: one pooled k-of-n
    over every document's sentences.

``build_request("rerank", query=..., candidates=..., k=4)`` or
``get_workload("dedup").build(...)``; registration is import-time via the
:func:`register_workload` decorator.
"""

from repro_torch.workloads.base import (  # noqa: F401
    Workload,
    available_workloads,
    build_request,
    get_workload,
    register_workload,
)
from repro_torch.workloads import dedup, multidoc, rerank, summarize  # noqa: F401
