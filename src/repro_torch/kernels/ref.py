"""Plain PyTorch oracles of the COBI, Ising-energy and MCMC kernels.

Twins of ``repro.kernels.ref``: the same op order (``j + j``, one stacked
[cos; sin] @ 2J product, ``sin 2phi = 2 sin phi cos phi``, the float32 ramp
``ks_max * (t + 1) / steps``), so on the CPU they track the reference's
trajectories to rounding and give its integer energies exactly; the MCMC
oracle gives the reference's spins and energies bit for bit.  They run on
any device; the kernel wrappers use them for CPU tensors and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.formulation import row_sum


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


# ---------------------------------------------------------------------------
# MCMC asynchronous Metropolis sweeps (counter-based randomness)
# ---------------------------------------------------------------------------

# Odd 32-bit constants decorrelating the (replica, sweep, proposal) counter
# axes before the avalanche mix; the reference's, verbatim.  The randomness
# is a pure function of logical indices, so the CUDA kernel draws the same
# numbers under any split of replicas over thread blocks.
MCMC_CTR_REP = 0x9E3779B1
MCMC_CTR_SWEEP = 0x85EBCA77
MCMC_CTR_POS = 0xC2B2AE3D
_MASK = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64-held uint32 ``x``, in two 16-bit halves
    of ``c`` so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def mcmc_mix32(x):
    """lowbias32-style avalanche on uint32 values held in int64 tensors (or
    numpy arrays)."""
    x = x & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mcmc_u01(seed, rep, sweep, pos):
    """Uniform [0, 1) float32, a pure function of (seed, replica, sweep,
    proposal); 24 mantissa bits.  Arguments are ints and int64 tensors (or
    int64 numpy arrays) that broadcast together; so is the result."""
    x = (int(seed) + _mul32(rep, MCMC_CTR_REP) + _mul32(sweep, MCMC_CTR_SWEEP)
         + _mul32(pos, MCMC_CTR_POS)) & _MASK
    bits = mcmc_mix32(x) >> 8
    f = bits.astype(np.float32) if isinstance(bits, np.ndarray) else bits.to(torch.float32)
    return f * (1.0 / (1 << 24))


def mcmc_seeds(key: torch.Tensor) -> torch.Tensor:
    """(4,) seed words [init, pick, accept, spare] from a key, as int64 on
    the CPU: ``jax.random.bits(key, (4,), uint32)``.  The only place the key
    is consumed."""
    return torch.from_numpy(prng.bits_host(key, 4))


def mcmc_init_spins(seed_init, replicas: int, n: int, device="cpu") -> torch.Tensor:
    """(R, N) float32 +-1 initial spins from counters (sweep axis 0), hashed
    on the host (numpy holds no lock a pool's other threads wait on) and
    copied to ``device`` once."""
    rep = np.arange(replicas, dtype=np.int64)[:, None]
    pos = np.arange(n, dtype=np.int64)[None, :]
    u = mcmc_u01(seed_init, rep, 0, pos)
    return torch.from_numpy(np.where(u < 0.5, 1.0, -1.0).astype(np.float32)).to(device)


def mcmc_t_hi(j: torch.Tensor) -> torch.Tensor:
    """Default hot temperature ``2 max_i sum_j |J_ij| + 1e-6`` in float32,
    the row sums in the reference's order.  Take it on the unpadded J."""
    rows = row_sum(j.to(torch.float32).abs())
    return 2.0 * rows.max() + torch.tensor(1e-6, dtype=torch.float32, device=j.device)


def mcmc_ladder(t_hi, t_lo, sweeps: int) -> torch.Tensor:
    """The per-sweep temperatures ``t_hi * (t_lo/t_hi) ** (t/(sweeps-1))``
    as (sweeps,) float32 on the CPU, in the reference's float32 op order,
    one scalar ``powf`` each.  The kernel takes this array instead of
    calling the device's ``powf``."""
    t_hi, t_lo = np.float32(float(t_hi)), np.float32(float(t_lo))
    ratio = t_lo / t_hi
    denom = np.float32(max(sweeps - 1, 1))
    temps = [t_hi * ratio ** (np.float32(t) / denom) for t in range(sweeps)]
    return torch.from_numpy(np.array(temps, dtype=np.float32))


def mcmc_anneal_states(
    j: torch.Tensor,  # (N, N) f32
    h: torch.Tensor,  # (N,)
    s0: torch.Tensor,  # (R, N) f32 +-1 initial spins
    seeds: torch.Tensor,  # (4,) seed words [init, pick, accept, spare]
    temps: torch.Tensor,  # (sweeps,) f32 ladder (mcmc_ladder)
    *,
    n_real: int,
    mode: str = "sweep",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep loop of :func:`ref_mcmc_sweep` from given initial spins:
    (best spins (R, N) f32 +-1, best energies (R,) f32).

    Every op is the reference's, in its float32 order; proposals at
    ``t >= n_real`` are skipped, which leaves the result as the reference's
    no-op proposals do (a flip factor of 0 changes no value).  The uniforms
    of a sweep are drawn at once: they are counters, not carried state.
    """
    if mode not in ("sweep", "random"):
        raise ValueError(f"unknown mcmc mode {mode!r}")
    dev = s0.device
    j = j.to(torch.float32)
    h = h.to(torch.float32).reshape(-1)
    r, n = s0.shape
    seed_pick, seed_acc = int(seeds[1]), int(seeds[2])
    rep = torch.arange(r, dtype=torch.int64, device=dev)[:, None]
    pos = torch.arange(n_real, dtype=torch.int64, device=dev)[None, :]
    rows = torch.arange(r, device=dev)
    n_live = torch.tensor(float(n_real), dtype=torch.float32, device=dev)
    floor_t = torch.tensor(1e-9, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    s = s0.to(torch.float32).clone()
    f = torch.zeros_like(s)
    for i in range(n):  # f0 = s0 @ J, the lanes in order
        f = f + s[:, i : i + 1] * j[i]
    e = row_sum(s * h + s * f)
    best_e, best_s = e.clone(), s.clone()
    for ts in range(temps.shape[0]):
        t_div = torch.maximum(temps[ts], floor_t).to(dev)
        u_acc = mcmc_u01(seed_acc, rep, ts, pos)  # (R, n_real)
        if mode == "random":
            picks = torch.floor(mcmc_u01(seed_pick, rep, ts, pos) * n_live).to(torch.int64)
        for t in range(n_real):
            k = picks[:, t] if mode == "random" else t
            s_k, f_k, h_k = s[rows, k], f[rows, k], h[k]
            de = -2.0 * s_k * (h_k + 2.0 * f_k)
            accept = u_acc[:, t] < torch.exp(torch.minimum(-de / t_div, zero))
            flip = torch.where(accept, 1.0, 0.0)
            s[rows, k] = torch.where(accept, -s_k, s_k)
            j_k = j[k] if mode == "random" else j[k][None]
            f = f - (2.0 * (s_k * flip))[:, None] * j_k
            e = e + de * flip
            better = e < best_e
            best_e = torch.where(better, e, best_e)
            best_s = torch.where(better[:, None], s, best_s)
    return best_s, best_e


def ref_mcmc_sweep(
    j: torch.Tensor,  # (N, N) symmetric couplings, zero diagonal
    h: torch.Tensor,  # (N,)
    key: torch.Tensor,  # key words -> counter seeds via mcmc_seeds
    *,
    replicas: int,
    sweeps: int,
    mode: str = "sweep",
    t_hi=None,
    t_lo: float = 0.05,
    n_real: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Asynchronous single-spin Metropolis sweeps; the MCMC kernels' oracle.

    R replicas anneal independently down the geometric ladder
    :func:`mcmc_ladder`; each sweep makes one proposal per position, in
    order (``mode="sweep"``) or drawn uniformly from [0, n_real)
    (``"random"``); dE = -2 s_k (h_k + 2 f_k) with f = s J kept by rank-1
    updates; the Metropolis rule ``u < exp(min(-dE/T, 0))``.  Returns (best
    spins (R, N) f32 +-1, best energies (R,) f32): the best state each
    replica visited.  Runs on j's device.
    """
    n = j.shape[-1]
    if t_hi is None:
        t_hi = mcmc_t_hi(j)
    seeds = mcmc_seeds(key)
    s0 = mcmc_init_spins(seeds[0], replicas, n, device=j.device)
    return mcmc_anneal_states(
        j, h, s0, seeds, mcmc_ladder(t_hi, t_lo, sweeps),
        n_real=n if n_real is None else n_real, mode=mode,
    )
