from repro_torch.solvers import (  # noqa: F401
    brute,
    cobi,
    greedy,
    mcmc,
    random_baseline,
    sa,
    tabu,
)
from repro_torch.solvers.base import (  # noqa: F401
    ISING_SOLVER_NAMES,
    AwaitableFuture,
    PoolFuture,
    PoolJobCancelled,
    PoolReceipt,
    SolverBackend,
    SolverFuture,
    SolverResult,
    ThreadPoolBackend,
    ising_solver,
)
