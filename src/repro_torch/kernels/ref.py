"""Plain PyTorch oracles of the COBI and Ising-energy kernels.

Twins of ``repro.kernels.ref``: the same op order (``j + j``, one stacked
[cos; sin] @ 2J product, ``sin 2phi = 2 sin phi cos phi``, the float32 ramp
``ks_max * (t + 1) / steps``), so on the CPU they track the reference's
trajectories to rounding and give its integer energies exactly.  They run on
any device; the kernel wrappers use them for CPU tensors and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import torch


def ref_cobi_trajectory(
    j_scaled: torch.Tensor,  # (N, N) symmetric, zero diag, pre-scaled
    h_scaled: torch.Tensor,  # (N,) pre-scaled
    phi0: torch.Tensor,  # (R, N) initial phases
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> torch.Tensor:
    """Euler-integrate the oscillator phase ODE; returns final phases (R, N).

    dphi_i/dt = [2 sum_j J_ij sin(phi_i - phi_j) + h_i sin phi_i]
                - ks(t) sin(2 phi_i),
    gradient descent on the phase relaxation of H = h.s + s^T J s plus a
    ramped sub-harmonic injection-locking term that binarizes phases.
    """
    j = j_scaled.to(torch.float32)
    h = h_scaled.to(torch.float32).reshape(1, -1)
    j2 = j + j  # exact: *2 only bumps exponents
    r = phi0.shape[0]
    phi = phi0.to(torch.float32)
    ks_max32 = torch.tensor(ks_max, dtype=torch.float32)
    for t in range(steps):
        s = torch.sin(phi)
        c = torch.cos(phi)
        mj = torch.cat([c, s], dim=0) @ j2  # (2R, N)
        grad = (s * mj[:r] - c * mj[r:]) + h * s
        ks = float(ks_max32 * (float(t) + 1.0) / steps)  # float32 ramp
        phi = phi + dt * (grad - ks * (2.0 * (s * c)))
    return phi


def sign_spins(phi: torch.Tensor) -> torch.Tensor:
    """Readout s = sign(cos phi) in {-1, +1} as float32 (``cos >= 0 -> +1``)."""
    return torch.where(torch.cos(phi) >= 0.0, 1.0, -1.0).to(torch.float32)


def ref_cobi_spins(phi: torch.Tensor) -> torch.Tensor:
    """Read out spins s = sign(cos phi) in {-1, +1} (int8)."""
    return sign_spins(phi).to(torch.int8)


def ref_cobi_fused_best(
    phi: torch.Tensor,  # (B, R, N) final phases
    j_orig: torch.Tensor,  # (B, N, N) scoring couplings
    h_orig: torch.Tensor,  # (B, N)
    mask: torch.Tensor,  # (B, N, S) 0/1 lane->slot assignment
    reads: torch.Tensor,  # (B, S) valid-read count per slot
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle of the fused readout epilogue: sign, per-lane energy density
    against the original coefficients, per-slot energies through the lane
    mask, reads past a slot's budget masked to +inf, and the FIRST replica
    attaining each slot's minimum.  Returns (best energies (B, S) f32, best
    spins (B, S, N) f32 in {-1, +1})."""
    s = sign_spins(phi)
    sj = torch.einsum("brn,bnm->brm", s, j_orig.to(torch.float32))
    e_lanes = s * sj + h_orig.to(torch.float32)[:, None, :] * s
    e_slots = torch.einsum("brn,bns->brs", e_lanes, mask.to(torch.float32))
    r = phi.shape[1]
    rep = torch.arange(r, dtype=torch.float32, device=phi.device)[None, :, None]
    valid = rep < reads.to(torch.float32)[:, None, :]
    e_slots = torch.where(valid, e_slots, torch.inf)
    best_e = e_slots.min(dim=1).values  # (B, S)
    hit = e_slots == best_e[:, None, :]
    first = torch.where(hit, rep, float(r)).min(dim=1).values.to(torch.int64)
    best_s = torch.stack([sb[fb] for sb, fb in zip(s, first)])  # (B, S, N)
    return best_e, best_s


def ref_ising_energy(spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """E_r = h . s_r + s_r^T J s_r for a batch of spin vectors (R, N)."""
    s = spins.to(torch.float32)
    return s @ h.to(torch.float32) + torch.einsum(
        "ri,ij,rj->r", s, j.to(torch.float32), s
    )


def ref_ising_energy_batched(spins: torch.Tensor, h: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """E_br for (B, R, N) spins against per-instance (B, N) h, (B, N, N) J."""
    s = spins.to(torch.float32)
    lin = torch.einsum("brn,bn->br", s, h.to(torch.float32))
    quad = torch.einsum("bri,bij,brj->br", s, j.to(torch.float32), s)
    return lin + quad
