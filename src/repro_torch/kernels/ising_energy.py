"""Batched Ising energy E_r = h.s_r + s_r^T J s_r: the CUDA kernel's wrapper
and its plain version.

Ports of ``repro.kernels.ising_energy``: ``ising_energy_pallas``, the
paper's per-iteration objective evaluation (:func:`ising_energy_cuda`), and
its stacked twin ``ising_energy_batched_pallas``, which scores every job of a
chip-farm drain against its own instance in one launch
(:func:`ising_energy_batched_cuda`).  Both bind to one kernel
(``csrc/ising_energy.cu``), which takes the operands as the caller holds
them: any n from 1 to 1024 lanes and any R, int8 or float32 spins, rows at
any stride.  So ``ops.ising_energy`` pads nothing, and the tile-aligned
shapes of the reference are one case among others.  On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

LANE = 128
BR = 8  # the COBI kernels take R in multiples of this (csrc: repro::BR)
MAX_LANES = 1024  # the energy kernel's n: one thread a lane
SPIN_TYPES = (torch.int8, torch.float32)  # what the energy kernel reads as it is


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
    spins: torch.Tensor,  # (R, N) int8 or f32 in {-1, 0, +1}
    h: torch.Tensor,  # (1, N)
    j: torch.Tensor,  # (N, N)
) -> torch.Tensor:
    """Energies (R,) of R spin rows; the kernel on CUDA, plain on CPU."""
    if spins.device.type == "cpu":
        return ising_energy_plain(spins, h, j)
    out = _energy(spins, h, j)
    _build.count_launch(ising_energy_cuda)
    return out


ising_energy_cuda.launches = 0


def ising_energy_batched_plain(
    spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor
) -> torch.Tensor:
    """Plain version: spins (B, R, N), h (B, 1, N), j (B, N, N) -> (B, R)."""
    return kref.ref_ising_energy_batched(spins, h[:, 0], j)


def ising_energy_batched_cuda(
    spins: torch.Tensor,  # (B, R, N) int8 or f32 in {-1, 0, +1}
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
    """Launch ``ising_energy`` on spins (R, n) against h (1, n), j (n, n),
    or on spins (B, R, n) against h (B, 1, n), j (B, n, n); returns (R,) or
    (B, R).  The operands are read in place: spins of another type than int8
    or float32, h or j of another than float32, and an operand whose last
    dimension is not unit-stride are converted first."""
    *batch, r, n = spins.shape
    if (len(batch) > 1 or h.shape != (*batch, 1, n) or j.shape != (*batch, n, n) or r < 1
            or not 1 <= n <= MAX_LANES):
        raise ValueError(
            f"energy shapes: spins {tuple(spins.shape)}, h {tuple(h.shape)}, "
            f"j {tuple(j.shape)} (1 to {MAX_LANES} lanes, at least one row)"
        )
    if spins.dtype not in SPIN_TYPES:
        spins = spins.to(torch.float32)
    if h.dtype != torch.float32:
        h = h.to(torch.float32)
    if j.dtype != torch.float32:
        j = j.to(torch.float32)
    if n > 1:
        spins, h, j = (t if t.stride(-1) == 1 else t.contiguous() for t in (spins, h, j))
    dev = spins.get_device()
    if h.get_device() != dev or j.get_device() != dev:
        raise ValueError(f"energy operands on {spins.device}, {h.device} and {j.device}")
    out = torch.empty((*batch, r), dtype=torch.float32, device=spins.device)
    err = _build.library("ising_energy").ising_energy(
        spins.data_ptr(), int(spins.dtype == torch.int8), h.data_ptr(), j.data_ptr(),
        out.data_ptr(), batch[0] if batch else 1, r, n, spins.stride(0) if batch else 0,
        spins.stride(-2), h.stride(0) if batch else 0, j.stride(0) if batch else 0,
        j.stride(-2), _build.stream_of(spins),
    )
    _build.check(err, "ising_energy")
    return out
