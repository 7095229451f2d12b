"""Deterministic fault injection and host-side readout validation.

The farm's kernels are trusted bit-exact simulators, so faults are
injected *above* them, at the scheduler's drain boundary: a seeded
:class:`FaultPlan` decides -- as a pure function of stable identifiers
(job ids, chip ids, global drain cycles) -- which drains time out, which
chips fail, and which readouts come back corrupted.  Because every
decision is a hash of ``(seed, kind, *ids)`` rather than a stateful RNG
stream, a chaos run is replayable from the seed alone: retries get fresh
job ids (fresh draws), while re-running the same workload reproduces the
same fault sequence regardless of drain composition or call order.

Detection is validation, not trust: every drained readout is re-checked
host-side by recomputing the Ising energy from the reported spins and
comparing it against the energy the "device" reported.  For the integer
instances the QUBO front-end emits, achievable energies are exact
integers well inside f32 range, so the comparison is exact and a single
bit-flip is repairable by searching for the unique flipped spin whose
restored energy matches the reported one.  Readouts that cannot be
repaired unambiguously are classified corrupt and surface as typed
:class:`CorruptReadout` failures -- never as results.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FaultPlan",
    "FarmFault",
    "DrainTimeout",
    "ChipFailure",
    "CorruptReadout",
    "ising_energy_np",
    "validate_readout",
]


# ---------------------------------------------------------------------------
# Typed fault exceptions
# ---------------------------------------------------------------------------


class FarmFault(RuntimeError):
    """Base class for injected/detected farm faults.

    Instances carry enough context for the recovery layer: the job that
    failed, the chip it was placed on (when attributable), and the
    :class:`~repro_torch.farm.scheduler.JobReceipt` for work already billed
    (partial receipts ride terminal failures up to the caller).
    """

    def __init__(self, msg: str, *, job_id: Optional[int] = None,
                 chip_id: Optional[int] = None, receipt=None):
        super().__init__(msg)
        self.job_id = job_id
        self.chip_id = chip_id
        self.receipt = receipt


class DrainTimeout(FarmFault):
    """The whole drain hung/timed out; readouts were lost but time was spent."""


class ChipFailure(FarmFault):
    """A chip failed (transiently or persistently) during this drain cycle."""


class CorruptReadout(FarmFault):
    """Readout failed validation and could not be repaired unambiguously."""


# ---------------------------------------------------------------------------
# Seeded deterministic fault plan
# ---------------------------------------------------------------------------


def _u01(seed: int, kind: str, *parts: int) -> float:
    """Uniform [0, 1) as a pure function of (seed, kind, parts)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", seed))
    h.update(kind.encode())
    for p in parts:
        h.update(struct.pack("<q", int(p)))
    return int.from_bytes(h.digest(), "little") / float(1 << 64)


def _pick(seed: int, kind: str, n: int, *parts: int) -> int:
    """Deterministic index in [0, n)."""
    return int(_u01(seed, kind, *parts) * n) % max(1, n)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, replayable fault schedule for a :class:`CobiFarm`.

    All rates are probabilities in [0, 1].  Decisions are pure functions
    of the seed plus stable identifiers, so the same plan produces the
    same faults for the same workload no matter how drains are batched.
    """

    seed: int = 0
    # Whole-drain faults: the launch "hangs" and every readout is lost.
    drain_timeout_rate: float = 0.0
    # Per-(chip, global cycle) transient failures and always-dead chips.
    chip_transient_rate: float = 0.0
    failed_chips: Tuple[int, ...] = ()
    # Per-job readout corruption.
    bitflip_rate: float = 0.0     # single spin flip -> repairable
    corrupt_rate: float = 0.0     # multi-flip + energy scramble -> corrupt
    # Persistent per-(chip, lane) stuck spins.
    stuck_lane_rate: float = 0.0
    stuck_value: int = 1

    def __post_init__(self):
        for name in ("drain_timeout_rate", "chip_transient_rate",
                     "bitflip_rate", "corrupt_rate", "stuck_lane_rate"):
            v = getattr(self, name)
            if not (0.0 <= float(v) <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if int(self.stuck_value) not in (-1, 1):
            raise ValueError("stuck_value must be +1 or -1")

    # -- whole-drain ---------------------------------------------------

    def drain_timeout(self, job_ids: Sequence[int]) -> bool:
        """Does the drain carrying exactly these jobs time out?

        Keyed on the sorted job-id set so a retry (new job ids) draws
        fresh, while replaying the same workload reproduces the hang.
        """
        if self.drain_timeout_rate <= 0.0 or not job_ids:
            return False
        key = min(int(j) for j in job_ids)
        mixed = sum(int(j) for j in job_ids)
        return _u01(self.seed, "drain", key, mixed) < self.drain_timeout_rate

    # -- per-chip ------------------------------------------------------

    def chip_failed(self, chip: int, cycle: int) -> bool:
        """Does ``chip`` fail during global drain ``cycle``?"""
        if int(chip) in self.failed_chips:
            return True
        if self.chip_transient_rate <= 0.0:
            return False
        return _u01(self.seed, "chip", chip, cycle) < self.chip_transient_rate

    def stuck_lanes(self, chip: int, lanes: int) -> List[int]:
        """Persistently stuck lane indices on ``chip`` (same every drain)."""
        if self.stuck_lane_rate <= 0.0:
            return []
        return [la for la in range(int(lanes))
                if _u01(self.seed, "lane", chip, la) < self.stuck_lane_rate]

    # -- per-job readout ----------------------------------------------

    def readout_fault(self, job_id: int) -> Optional[str]:
        """``None`` | ``"bitflip"`` | ``"corrupt"`` for this job's readout."""
        u = _u01(self.seed, "readout", job_id)
        if u < self.corrupt_rate:
            return "corrupt"
        if u < self.corrupt_rate + self.bitflip_rate:
            return "bitflip"
        return None

    def flip_position(self, job_id: int, n: int, which: int = 0) -> int:
        """Deterministic spin index to flip for job ``job_id``."""
        return _pick(self.seed, "flip", n, job_id, which)

    # -- application helpers (mutate copies, never kernel outputs) -----

    def corrupt_readout(self, job_id: int, spins: np.ndarray,
                        energies: np.ndarray) -> Tuple[np.ndarray, np.ndarray, str]:
        """Apply this job's readout fault to copies of (spins, energies).

        ``spins`` is (R, N) +-1 int8/f32; ``energies`` is (R,).  A
        "bitflip" flips one spin in every read row and leaves the
        reported energy untouched (it was computed on-device before the
        corruption), so validation can repair it.  A "corrupt" readout
        flips two spins *and* scrambles the reported energies by +0.5:
        integer instances can never achieve a half-integer energy, so a
        corrupt readout can never masquerade as clean or repairable.
        """
        kind = self.readout_fault(job_id)
        if kind is None:
            return spins, energies, "none"
        spins = np.array(spins, copy=True)
        energies = np.array(energies, copy=True)
        n = spins.shape[-1]
        p0 = self.flip_position(job_id, n, 0)
        spins[..., p0] = -spins[..., p0]
        if kind == "corrupt":
            p1 = self.flip_position(job_id, n, 1)
            if p1 == p0:
                p1 = (p1 + 1) % n
            spins[..., p1] = -spins[..., p1]
            energies = energies + 0.5
        return spins, energies, kind


# ---------------------------------------------------------------------------
# Host-side validation / repair
# ---------------------------------------------------------------------------


def ising_energy_np(spins: np.ndarray, h: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Host float64 Ising energy E(s) = h.s + s^T J s for (R, N) spins."""
    s = np.asarray(spins, dtype=np.float64)
    hv = np.asarray(h, dtype=np.float64)
    jm = np.asarray(j, dtype=np.float64)
    return s @ hv + np.einsum("ri,ij,rj->r", s, jm, s)


def _is_integer_instance(h: np.ndarray, j: np.ndarray) -> bool:
    return (np.allclose(h, np.round(h), atol=0.0)
            and np.allclose(j, np.round(j), atol=0.0))


@dataclass
class ReadoutVerdict:
    """Result of validating one job's drained readout."""

    status: str                    # "clean" | "repaired" | "corrupt"
    spins: np.ndarray              # possibly repaired (R, N)
    energies: np.ndarray           # recomputed-consistent (R,)
    detail: str = ""
    repaired_reads: int = 0
    candidates: List[int] = field(default_factory=list)


def validate_readout(spins: np.ndarray, energies: np.ndarray,
                     h: np.ndarray, j: np.ndarray) -> ReadoutVerdict:
    """Check a drained readout against its reported energies.

    The reported energy is computed on-device from the *true* spins
    before any readout corruption, so it acts as a per-read syndrome:

    * recomputed energy == reported -> clean;
    * exactly one single-spin flip restores the reported energy on every
      mismatching read -> repaired (bit-identical to the clean run);
    * anything else (no candidate, or an ambiguous >=2-candidate
      syndrome) -> corrupt.  Conservative by design: a corrupt verdict
      is retryable, a wrong repair would be silent data corruption.

    Exact f32 comparison is used for integer instances (energies are
    exact integers well inside f32 range); non-integer instances fall
    back to a relative tolerance and are never single-flip repaired.
    """
    spins = np.asarray(spins)
    if spins.ndim == 1:
        spins = spins[None, :]
    energies = np.atleast_1d(np.asarray(energies, dtype=np.float64))
    exact = _is_integer_instance(h, j)

    recomputed = ising_energy_np(spins, h, j)
    if exact:
        reported = np.float32(energies).astype(np.float64)
        ok = np.float32(recomputed).astype(np.float64) == reported
    else:
        scale = np.maximum(1.0, np.abs(energies))
        ok = np.abs(recomputed - energies) <= 1e-4 * scale
    if bool(ok.all()):
        return ReadoutVerdict("clean", spins, energies)
    if not exact:
        return ReadoutVerdict("corrupt", spins, energies,
                              detail="energy mismatch (non-integer instance)")

    bad = np.flatnonzero(~ok)
    repaired = np.array(spins, copy=True)
    for r in bad:
        row = repaired[r].astype(np.float64)
        # E(flip i) = E - 2*s_i*(h_i + 2 * sum_j J_sym[i,j] s_j)
        jm = np.asarray(j, dtype=np.float64)
        hv = np.asarray(h, dtype=np.float64)
        grad = hv + (jm + jm.T) @ row
        base = float(recomputed[r])
        flipped = base - 2.0 * row * grad
        reported_r = float(np.float32(energies[r]))
        cand = np.flatnonzero(
            np.float32(flipped).astype(np.float64) == reported_r)
        if cand.size != 1:
            why = "ambiguous syndrome" if cand.size > 1 else "no single-flip repair"
            return ReadoutVerdict("corrupt", spins, energies, detail=why,
                                  candidates=[int(c) for c in cand])
        repaired[r, cand[0]] = -repaired[r, cand[0]]
    return ReadoutVerdict("repaired", repaired, energies,
                          repaired_reads=int(bad.size))
