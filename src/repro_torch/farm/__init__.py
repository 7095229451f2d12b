"""Virtual COBI chip farm: packed multi-instance annealing on the card.

The paper's deployment target is ONE 59-spin COBI chip solving one instance
per 200 us execution.  The port's anneal kernels pad that instance to 128
lanes and run its 8 reads as one thread block, so a single solve leaves most
of the card idle.  This package turns the solver into a *farm*:

  * :mod:`repro_torch.farm.packing` -- block-diagonally combines many
    independent ≤59-spin instances into one 128-lane super-instance.  Each
    block is pre-scaled by its own dynamics normalizer, so the packed
    trajectory advances every block exactly as a solo anneal would (the zero
    cross-blocks contribute exact float zeros to the dot products), and
    per-block energies unpack exactly.  Best-fit-decreasing packing in
    priority order keeps urgent jobs in the earliest chip cycles while
    filling lanes densely, and :func:`replica_tiers` keeps jobs with wildly
    different read counts out of each other's bins.

  * :mod:`repro_torch.farm.scheduler` -- :class:`CobiFarm` accepts solve jobs
    with priorities/deadlines and returns thread-safe, ``await``-able
    futures.  A drain groups jobs by anneal schedule and replica tier, packs
    them, pads the super-instance stack to a batch bucket, and runs ONE
    batched CUDA launch with grid (replica-block, instance) -- the software
    picture of ``n_chips`` physical COBI arrays each programmed once and
    executed R times.  Drains are fired by the caller (``policy="manual"``)
    or by a background drive loop (``"bin-full"``, ``"deadline"``,
    ``"timer"``); results are bit-identical across policies.
    ``reduce="best"`` jobs resolve through the fused anneal→readout→best-of
    epilogue, so a drain brings back O(lanes) per super-instance.  Per-chip
    occupancy plus the paper's 200 us / 25 mW per-execution model drive the
    latency/energy receipts each future carries.

  * :mod:`repro_torch.farm.faults` / :mod:`repro_torch.farm.health` -- a
    seeded, replayable :class:`FaultPlan` injects drain timeouts, chip
    failures, stuck lanes and readout bit-flips at the drain boundary; every
    drained readout is validated host-side; per-chip circuit breakers
    quarantine sick chips.

The reference's MCMC annealer bank (``McmcPoolBackend``) ports with the MCMC
family.
"""

from repro_torch.farm.faults import (  # noqa: F401
    ChipFailure,
    CorruptReadout,
    DrainTimeout,
    FarmFault,
    FaultPlan,
    ising_energy_np,
    validate_readout,
)
from repro_torch.farm.health import (  # noqa: F401
    BreakerConfig,
    ChipBreaker,
    FarmHealth,
)
from repro_torch.farm.packing import (  # noqa: F401
    PackedInstance,
    PackEstimate,
    Slot,
    bucket_to,
    estimate_packing,
    pack_instances,
    replica_tiers,
)
from repro_torch.farm.scheduler import (  # noqa: F401
    BATCH_BUCKET,
    DRAIN_POLICIES,
    REPLICA_BUCKET,
    REPLICA_TIER_RATIO,
    ChipStats,
    CobiFarm,
    FarmFuture,
    FarmJob,
    FarmJobCancelled,
    FarmPendingError,
    FarmStats,
    JobReceipt,
    solve_many,
)
