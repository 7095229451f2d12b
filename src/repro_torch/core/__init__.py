"""The paper's contribution: hardware-aware Ising extractive summarization."""

from repro_torch.core.formulation import (  # noqa: F401
    EsProblem,
    IsingProblem,
    QuboProblem,
    es_objective,
    gamma_auto,
    improved_ising,
    ising_energy,
    original_ising,
    qubo_energy,
    qubo_improved,
    qubo_original,
    qubo_to_ising,
    selection_to_spins,
    spins_to_selection,
)
from repro_torch.core.kofn import kofn_bias, rebalance_ising, rebalance_qubo  # noqa: F401
from repro_torch.core.pipeline import SolveConfig, SolveReport, solve_es  # noqa: F401
from repro_torch.core.rounding import COBI_RANGE, quantize_ising  # noqa: F401
