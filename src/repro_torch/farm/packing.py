"""Block-diagonal packing of COBI-sized Ising instances onto chip lanes.

A virtual COBI chip in the farm exposes ``capacity`` spin lanes (a multiple
of the kernels' 128-lane tile).  Independent instances with ``n_i <= COBI_MAX_SPINS``
are placed at disjoint lane offsets of one super-instance; because the packed
coupling matrix is block-diagonal, the oscillator dynamics and the Ising
energy of each block are exactly those of the instance solved alone:

  * **dynamics**  -- each block's (h, J) is divided by its *own*
    ``ops.dynamics_scale`` before packing, so the packed Euler integration
    advances each block identically to a solo ``cobi_anneal`` (cross-block
    matmul contributions are exact float zeros);
  * **energy**    -- E(s_packed) = sum_k E_k(s_block_k), and per-block
    energies are recovered exactly by scoring against the UNSCALED
    block-diagonal copy (``h_orig``/``j_orig``) that each bin also carries --
    the fused readout epilogue scores against that copy and reduces per-slot
    best reads on the device (kernels/cobi_dynamics.py).

Packing is host numpy, as in the reference: its decisions, scales and
packed arrays are the reference's bit for bit.

Packing is best-fit in scheduler priority order: the scheduler hands jobs
over highest-priority first (size-decreasing within a priority class, i.e.
best-fit-decreasing), so urgent jobs land in the earliest bins and therefore
the earliest simulated chip cycles, while each later job goes to the bin it
fills tightest.

Jobs with very different read counts should not share a bin at all -- a
packed bin runs one replica count, so a 8-read job packed with a 256-read
job would occupy its lanes for 248 wasted anneals.  :func:`replica_tiers`
groups a drain's jobs into read-count tiers (max/min ratio bounded) that the
scheduler packs independently.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.formulation import IsingProblem
from repro_torch.kernels.ising_energy import LANE


def bucket_to(x: int, multiple: int) -> int:
    """Round ``x`` up to a multiple (the farm's shape buckets)."""
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class Slot:
    """One job's lane range inside a packed super-instance."""

    job_id: int
    offset: int
    n: int
    scale: float  # dynamics normalizer applied to this block before packing


@dataclasses.dataclass
class PackedInstance:
    """A block-diagonally packed super-instance programmed onto one chip."""

    capacity: int
    h_scaled: np.ndarray  # (capacity,) f32, pre-scaled per block
    j_scaled: np.ndarray  # (capacity, capacity) f32, block-diagonal
    h_orig: np.ndarray  # (capacity,) f32, original coefficients per block
    j_orig: np.ndarray  # (capacity, capacity) f32, block-diagonal, unscaled
    slots: List[Slot]

    @property
    def lanes_used(self) -> int:
        return sum(s.n for s in self.slots)

    @property
    def occupancy(self) -> float:
        return self.lanes_used / self.capacity


def pack_instances(
    jobs: Sequence[Tuple[int, IsingProblem]],
    capacity: int = LANE,
) -> List[PackedInstance]:
    """Best-fit pack ``(job_id, ising)`` pairs into block-diagonal bins.

    Jobs are taken in the given order (the scheduler pre-sorts by priority /
    deadline, size-decreasing within a class -> best-fit-decreasing); each
    goes into the bin it leaves the FEWEST free lanes in (ties to the
    earliest bin, keeping urgent work in early chip cycles), else a new bin.
    Raises if any instance alone exceeds ``capacity``.
    """
    if capacity % LANE != 0:
        raise ValueError(f"capacity must be a multiple of {LANE}, got {capacity}")
    bins: List[PackedInstance] = []
    free: List[int] = []  # free lanes per bin
    for job_id, ising in jobs:
        n = ising.n
        if n > capacity:
            raise ValueError(f"instance with {n} spins exceeds chip capacity {capacity}")
        target = None
        for b, f in enumerate(free):
            if f >= n and (target is None or f < free[target]):
                target = b  # best fit: tightest bin that still holds the job
        if target is None:
            bins.append(
                PackedInstance(
                    capacity=capacity,
                    h_scaled=np.zeros(capacity, np.float32),
                    j_scaled=np.zeros((capacity, capacity), np.float32),
                    h_orig=np.zeros(capacity, np.float32),
                    j_orig=np.zeros((capacity, capacity), np.float32),
                    slots=[],
                )
            )
            free.append(capacity)
            target = len(bins) - 1
        inst = bins[target]
        offset = capacity - free[target]
        h = np.asarray(ising.h.detach().cpu(), np.float32)
        j = np.asarray(ising.j.detach().cpu(), np.float32)
        # ops.dynamics_scale in host numpy (float32), as the reference packs.
        denom = np.float32(2.0) * np.abs(j).sum(axis=-1).max() + np.abs(h).max()
        scale = float(np.maximum(denom, np.float32(1e-9)))
        inst.h_scaled[offset : offset + n] = h / np.float32(scale)
        inst.j_scaled[offset : offset + n, offset : offset + n] = j / np.float32(scale)
        inst.h_orig[offset : offset + n] = h
        inst.j_orig[offset : offset + n, offset : offset + n] = j
        inst.slots.append(Slot(job_id=job_id, offset=offset, n=n, scale=scale))
        free[target] -= n
    return bins


@dataclasses.dataclass(frozen=True)
class PackEstimate:
    """Shape-only best-fit-decreasing estimate of how a job group would pack.

    Built by :func:`estimate_packing` from lane counts alone -- no coefficient
    arrays -- so drain policies can evaluate "would this group close a bin?"
    on every submission.  ``bins[k]`` holds the indices (into the input
    ``sizes`` sequence) that landed in bin ``k``; ``lanes_used[k]`` its lane
    total.  The estimate sorts size-decreasing (the scheduler's order within
    one priority class), so it matches the real pack exactly when priorities
    and deadlines are uniform and approximates it otherwise.
    """

    capacity: int
    bins: List[List[int]]
    lanes_used: List[int]

    @property
    def n_bins(self) -> int:
        return len(self.bins)

    @property
    def occupancies(self) -> List[float]:
        return [u / self.capacity for u in self.lanes_used]

    @property
    def max_occupancy(self) -> float:
        return max(self.occupancies, default=0.0)

    def closed_bins(self, target: float) -> List[int]:
        """Bins at or above ``target`` occupancy (ready to launch)."""
        return [k for k, occ in enumerate(self.occupancies) if occ >= target]


def estimate_packing(sizes: Sequence[int], capacity: int = LANE) -> PackEstimate:
    """Best-fit-decreasing bin estimate over lane counts only.

    Mirrors :func:`pack_instances` (tightest bin that still fits, ties to the
    earliest) applied in size-decreasing order, but tracks nothing except
    which input index went to which bin -- cheap enough for the scheduler's
    per-submit drain-policy triggers.
    """
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    bins: List[List[int]] = []
    free: List[int] = []
    for i in order:
        n = int(sizes[i])
        if n > capacity:
            raise ValueError(f"instance with {n} spins exceeds chip capacity {capacity}")
        target = None
        for b, f in enumerate(free):
            if f >= n and (target is None or f < free[target]):
                target = b
        if target is None:
            bins.append([])
            free.append(capacity)
            target = len(bins) - 1
        bins[target].append(i)
        free[target] -= n
    return PackEstimate(
        capacity=capacity,
        bins=bins,
        lanes_used=[capacity - f for f in free],
    )


def replica_tiers(
    reads: Sequence[int],
    *,
    bucket: int = 8,
    ratio: float = 2.0,
) -> List[Tuple[int, List[int]]]:
    """Group jobs into read-count tiers: ``[(tier_reads, indices), ...]``.

    ``reads[i]`` is job i's read count.  Jobs are sorted by reads and greedily
    tiered so that within a tier ``max_reads <= max(bucket, ratio * min_reads)``
    -- similar read counts share a bin (and its single replica schedule, with
    per-slot read budgets masking the surplus), while jobs with very
    different read counts go to separate tiers instead of all running the
    largest job's count.  A tier runs ``bucket_to(max reads in tier, bucket)``
    anneals, so the wasted-anneal factor of any job is bounded by ``ratio``
    (plus bucket rounding).  Tiers are returned smallest-reads first.
    """
    if ratio < 1.0:
        raise ValueError(f"ratio must be >= 1, got {ratio}")
    rs = [max(int(r), 1) for r in reads]  # non-positive reads run 1 anneal
    order = sorted(range(len(rs)), key=lambda i: (rs[i], i))
    tiers: List[Tuple[int, List[int]]] = []
    cur: List[int] = []
    cur_min = 0
    for i in order:
        if cur and rs[i] > max(bucket, ratio * cur_min):
            tiers.append((bucket_to(max(rs[k] for k in cur), bucket), cur))
            cur = []
        if not cur:
            cur_min = rs[i]
        cur.append(i)
    if cur:
        tiers.append((bucket_to(max(rs[k] for k in cur), bucket), cur))
    return tiers
