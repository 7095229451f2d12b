"""Batched Ising energy E_r = h.s_r + s_r^T J s_r: the CUDA kernel's wrapper
and its plain version.

Ports of ``repro.kernels.ising_energy``: ``ising_energy_pallas``, the
paper's per-iteration objective evaluation (:func:`ising_energy_cuda`), and
its stacked twin ``ising_energy_batched_pallas``, which scores every job of a
chip-farm drain against its own instance in one launch
(:func:`ising_energy_batched_cuda`).  Both bind to one kernel
(``csrc/ising_energy.cu``, grid (R / 8, B)), which takes tile-aligned shapes:
``ops.ising_energy`` pads, as the reference does.  On a CPU tensor a wrapper
runs its plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

LANE = 128
BR = 8  # replica rows per CUDA thread block (csrc: repro::BR)


def check_cuda_args(*tensors: torch.Tensor) -> None:
    """What the CUDA entries take: float32, contiguous, one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"kernel wants contiguous float32 tensors on {dev}; got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


def ising_energy_plain(spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Plain version: spins (R, N), h (1, N), j (N, N) -> energies (R,)."""
    return kref.ref_ising_energy(spins, h[0], j)


def ising_energy_cuda(
    spins: torch.Tensor,  # (R, N) f32 in {-1, 0, +1}; R % 8 == 0, N % LANE == 0
    h: torch.Tensor,  # (1, N)
    j: torch.Tensor,  # (N, N)
) -> torch.Tensor:
    """Energies (R,) of R spin rows; the kernel on CUDA, plain on CPU."""
    if spins.device.type == "cpu":
        return ising_energy_plain(spins, h, j)
    out = _energy(spins[None], h[None], j[None])[0]
    _build.count_launch(ising_energy_cuda)
    return out


ising_energy_cuda.launches = 0


def ising_energy_batched_plain(
    spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor
) -> torch.Tensor:
    """Plain version: spins (B, R, N), h (B, 1, N), j (B, N, N) -> (B, R)."""
    return kref.ref_ising_energy_batched(spins, h[:, 0], j)


def ising_energy_batched_cuda(
    spins: torch.Tensor,  # (B, R, N) f32 in {-1, 0, +1}; R % 8 == 0, N % LANE == 0
    h: torch.Tensor,  # (B, 1, N)
    j: torch.Tensor,  # (B, N, N)
) -> torch.Tensor:
    """Energies (B, R): row r of instance b against (h[b], j[b]), one launch."""
    if spins.device.type == "cpu":
        return ising_energy_batched_plain(spins, h, j)
    out = _energy(spins, h, j)
    _build.count_launch(ising_energy_batched_cuda)
    return out


ising_energy_batched_cuda.launches = 0


def _energy(spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Launch ``ising_energy`` on (B, R, N) spins; returns (B, R)."""
    b, r, n = spins.shape
    if n % LANE or r % BR or h.shape != (b, 1, n) or j.shape != (b, n, n):
        raise ValueError(f"untiled shapes: spins {spins.shape}, h {h.shape}, j {j.shape}")
    check_cuda_args(spins, h, j)
    out = torch.empty((b, r), dtype=torch.float32, device=spins.device)
    err = _build.library("ising_energy").ising_energy(
        spins.data_ptr(), h.data_ptr(), j.data_ptr(), out.data_ptr(),
        b, r, n, _build.stream_of(spins),
    )
    _build.check(err, "ising_energy")
    return out
