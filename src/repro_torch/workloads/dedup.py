"""MMR-style near-duplicate pruning: keep ``keep`` representatives.

Maximal-marginal-relevance dedup trades representativeness against
redundancy; in k-of-n form that is centroid relevance with a
redundancy-dominant lambda -- two near-duplicates pay ~2*lam*cos(e_i, e_j)
for co-selection, so only one survives while coverage of distinct content
is still rewarded through mu.  ``lam=0`` degenerates to "top-keep most
central"; the default 1.5 makes redundancy the binding constraint.
"""

from __future__ import annotations

from typing import List

from repro_torch.serving.api import KofnSpec, SelectionRequest
from repro_torch.workloads.base import register_workload


@register_workload("dedup",
                   "MMR-style dedup: keep k representative items, "
                   "redundancy-dominant objective")
def build(*, items: List[str], keep: int,
          lam: float = 1.5) -> SelectionRequest:
    return SelectionRequest(
        items=list(items),
        kofn=KofnSpec(m=keep, lam=lam, relevance="centroid"),
        workload="dedup",
    )
