from repro_torch.solvers.base import ISING_SOLVER_NAMES, SolverResult, ising_solver  # noqa: F401
