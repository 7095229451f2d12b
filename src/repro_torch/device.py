"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, only an explicit ``"cpu"`` runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the caller "
                "passes device='cpu' (the kernels' plain versions)"
            )
        return torch.device("cuda")
    return torch.device(device)
