"""Workload-generic selection API: the engine's request/response surface.

The paper's observation is that the hardware-aware formulation "can be
applied to any problem formulation that requires k of n variables to be
chosen".  This module is that observation as an API: a request is a list of
*items* plus a :class:`KofnSpec` describing how the k-of-n objective is
built from them (where the relevance vector comes from, how pairwise
redundancy is scored, how many to keep, the relevance/redundancy trade-off
lambda).  Every workload in :mod:`repro_torch.workloads` -- extractive
summarization, MMR-style dedup, diverse retrieval re-ranking, multi-doc
sentence selection -- reduces to the same :class:`repro_torch.core.formulation.
EsProblem` and is served through admission, routing and recovery unchanged.

``SummarizeRequest``/``SummarizeResponse`` (``repro_torch.serving.engine``) are
thin compatibility views over this surface: a legacy ``submit(text=...)``
builds ``SelectionRequest(items=split_sentences(text),
kofn=KofnSpec(m, lam, relevance="centroid"))`` internally, and for that
spec :func:`problem_from_embeddings` runs the *identical* op sequence as
the legacy ``problem_from_sentences`` path (``scores_from_embeddings`` on
the item embeddings), so summarization through the generic surface is
bit-identical to the legacy one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem
from repro_torch.data.synthetic import scores_from_embeddings
from repro_torch.device import resolve_device

RELEVANCE_SOURCES = ("centroid", "query", "uniform", "given")


@dataclasses.dataclass
class KofnSpec:
    """How a k-of-n objective is built from a request's items.

    ``m`` items are selected maximizing ``sum(mu[i]) - lam * sum(beta[i,j])``
    over selected pairs (paper Eqs. 1-2 generalized beyond summarization).

    ``relevance`` names the mu source:
      * ``"centroid"`` -- cosine to the item-set centroid (summarization's
        "how central is this sentence"); the legacy-compatible default.
      * ``"query"``    -- cosine to an encoded ``query`` string (retrieval
        re-ranking: "how relevant to the query").
      * ``"uniform"``  -- all ones (pure diversity selection: only the
        redundancy term differentiates items).
      * ``"given"``    -- caller-supplied ``mu`` vector (len(items),).

    ``beta`` optionally overrides the pairwise redundancy matrix
    ((n, n), zero diagonal); left ``None`` it is the item-embedding cosine
    matrix.  When both ``mu`` and ``beta`` are given no encoder runs at all.
    """

    m: int
    lam: float = 0.5
    relevance: str = "centroid"
    query: Optional[str] = None
    mu: Optional[Sequence[float]] = None
    beta: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.relevance not in RELEVANCE_SOURCES:
            raise ValueError(
                f"relevance must be one of {RELEVANCE_SOURCES}, "
                f"got {self.relevance!r}"
            )
        if self.relevance == "query" and not self.query:
            raise ValueError("relevance='query' requires a query string")
        if self.relevance == "given" and self.mu is None:
            raise ValueError("relevance='given' requires a mu vector")
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m}")


@dataclasses.dataclass
class SelectionRequest:
    """Workload-agnostic k-of-n selection request.

    ``items`` are the candidate strings (sentences, passages, documents --
    whatever the workload selects among); ``kofn`` is the objective spec.
    ``workload`` tags the request for stats/receipts (the registry names in
    :mod:`repro_torch.workloads`, or any caller string).  Id/priority/deadline
    semantics are identical to the legacy ``SummarizeRequest``.
    """

    items: List[str]
    kofn: KofnSpec
    workload: str = "selection"
    request_id: int = 0  # <= 0 means "unassigned": the engine assigns one
    priority: int = 0
    deadline: Optional[float] = None


@dataclasses.dataclass
class SelectionResponse:
    """Result of one served k-of-n selection.

    ``selected`` holds the winning items in document order; ``selection``
    is the 0/1 vector over the request's items (the ROUGE input for the
    summarization workload).  ``summary`` is a read-only compatibility
    alias for ``selected`` -- every legacy ``SummarizeResponse`` consumer
    keeps working unchanged (``SummarizeResponse`` IS this class).

    The encoder front-stage meters into the response alongside chip time:
    ``encoder_seconds`` (wall seconds of the encode drain attributed to
    this request by token share, or the inline encode time), encoder
    h2d/d2h ``encoder_bytes``, and ``encoder_joules`` (encoder seconds x
    the stage's host watts).  All zero when the spec needed no encoding.
    """

    request_id: int
    selected: List[str]
    selection: np.ndarray
    objective: float
    normalized: Optional[float]
    wall_seconds: float
    projected_solver_seconds: float  # hardware model (COBI 200us/solve etc.)
    projected_energy_joules: float
    solver_invocations: int
    # Host<->device transfer attributed to this request's jobs by lane share
    # of each drain launch (0 for host-solver backends) -- the SLO view of
    # what the request cost beyond chip time.
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    sim_completed: float = 0.0  # absolute sim-clock finish of the last job
    # deadline_met is None when the request had no deadline or no simulated
    # hardware served it (host backends have no sim clock).
    deadline_met: Optional[bool] = None
    reads_used: int = 0  # effective anneal reads (< requested when degraded)
    degraded: bool = False  # admission floored the reads under overload
    # Routed serving: which backend served the request (dominant backend of a
    # window-split decomposed request; None without a router), what the
    # router predicted at admission, and what actually happened on the
    # serving backend's clock -- the per-request predicted-vs-realized pair
    # the profile's EWMA correction learns from.
    backend_used: Optional[str] = None
    predicted_seconds: float = 0.0
    realized_seconds: float = 0.0
    # Fault-tolerant serving: recovery attempts burned by this request's
    # jobs, fault events seen (terminal faults retried/failed over PLUS
    # readout corruption absorbed by validation repair), and whether any job
    # finished on the failover backend.  All zero on a fault-free run.
    retries: int = 0
    faults_seen: int = 0
    failed_over: bool = False
    # Workload-generic serving: which zoo workload the request declared, and
    # the encoder front-stage's share of the bill.
    workload: str = "selection"
    encoder_seconds: float = 0.0
    encoder_bytes: int = 0
    encoder_joules: float = 0.0

    @property
    def summary(self) -> List[str]:
        """Legacy alias: the selected items (sentences, for summarization)."""
        return self.selected


def encode_texts(spec: KofnSpec, items: Sequence[str]) -> List[str]:
    """The texts an encoder must embed for ``spec`` ([] when none).

    With ``relevance="query"`` the query rides as the LAST row of the same
    encode batch (one encoder pass per request, not two).
    """
    need_mu = spec.relevance in ("centroid", "query")
    need_beta = spec.beta is None
    if not need_mu and not need_beta:
        return []
    if spec.relevance == "query":
        return list(items) + [spec.query]
    return list(items)


def problem_from_embeddings(
    spec: KofnSpec, items: Sequence[str], e, *, device=None
) -> EsProblem:
    """Build the EsProblem from ``spec`` + the embeddings of
    :func:`encode_texts` (``None`` when that returned []), on ``device``
    (``None``: the card; the embeddings move there).

    For the legacy-compatible spec (centroid relevance, no mu/beta
    overrides) this is EXACTLY ``scores_from_embeddings(e)`` -- the same op
    sequence as ``problem_from_sentences`` -- so summarization through the
    generic surface stays bit-identical to the legacy path.
    """
    device = resolve_device(device)

    def given(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=device)

    n = len(items)
    if spec.mu is not None and len(spec.mu) != n:
        raise ValueError(f"mu has {len(spec.mu)} entries for {n} items")
    if spec.beta is not None and np.shape(spec.beta) != (n, n):
        raise ValueError(
            f"beta has shape {np.shape(spec.beta)} for {n} items"
        )
    if e is None:
        return EsProblem(mu=given(spec.mu), beta=given(spec.beta), m=spec.m, lam=spec.lam)
    e = torch.as_tensor(e).to(device=device, dtype=torch.float32)
    if (spec.relevance == "centroid" and spec.mu is None
            and spec.beta is None):
        mu, beta = scores_from_embeddings(e)
        return EsProblem(mu=mu, beta=beta, m=spec.m, lam=spec.lam)
    e_query = None
    if spec.relevance == "query":
        e_query, e = e[-1], e[:n]
    # General path: mirror scores_from_embeddings' normalization so every
    # relevance source scores against the same unit-norm geometry.
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-9)
    if spec.relevance == "centroid":
        doc = e.mean(dim=0)
        doc = doc / torch.clamp(torch.linalg.norm(doc), min=1e-9)
        mu = e @ doc
    elif spec.relevance == "query":
        q = e_query / torch.clamp(torch.linalg.norm(e_query), min=1e-9)
        mu = e @ q
    elif spec.relevance == "uniform":
        mu = torch.ones((n,), dtype=torch.float32, device=device)
    else:  # "given"
        mu = given(spec.mu)
    if spec.beta is not None:
        beta = given(spec.beta)
    else:
        beta = e @ e.T
        beta = beta * (1.0 - torch.eye(n, dtype=torch.float32, device=device))
    return EsProblem(mu=mu, beta=beta, m=spec.m, lam=spec.lam)


def problem_from_spec(
    spec: KofnSpec, items: Sequence[str], *, encoder=None, device=None
) -> EsProblem:
    """One-shot convenience: encode (if the spec needs it) + build.

    ``encoder`` is anything with ``encode(texts) -> (n, d)`` (the hashed
    BoW default, a ``BackboneEncoder``, or an ``EncoderStage``); the problem
    lands on ``device`` (``None``: the card).  The engine
    uses the two-phase :func:`encode_texts` / :func:`problem_from_embeddings`
    split instead so encoding can pipeline through its encode stage.
    """
    texts = encode_texts(spec, items)
    e = None
    if texts:
        if encoder is None:
            from repro_torch.embeddings import HashedBowEncoder

            encoder = HashedBowEncoder()
        e = encoder.encode(texts)
    return problem_from_embeddings(spec, items, e, device=device)
