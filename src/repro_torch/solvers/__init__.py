from repro_torch.solvers.base import (  # noqa: F401
    ISING_SOLVER_NAMES,
    AwaitableFuture,
    PoolFuture,
    PoolJobCancelled,
    PoolReceipt,
    SolverResult,
    ThreadPoolBackend,
    ising_solver,
)
