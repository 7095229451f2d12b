"""MCMC asynchronous-sweep Metropolis annealer: the CUDA kernels' wrappers and
their plain versions.

Ports of ``repro.kernels.mcmc_dynamics``:

  * :func:`mcmc_sweep_batched` -- ``mcmc_sweep_batched_pallas``: each
    replica's best-visited (energy, spins).
  * :func:`mcmc_fused_best_batched` -- ``mcmc_fused_best_batched_pallas``:
    the same plus the first-argmin over the first ``reads`` replicas, so only
    each instance's winner leaves the card.

Both bind to ``csrc/mcmc_dynamics.cu`` (grid (R / W, B), one warp per
replica).  The operands are the Pallas functions': J (B, N, N), h (B, 1, N),
s0 (B, R, N) +-1, per-instance seed words (B, 4) [init, pick, accept,
spare] and params (B, 4) [t_hi, t_lo, n_real, reads]; N a multiple of 128,
R a multiple of ``replica_block``.  Energies come back (B, R) and (B,), not
broadcast over lanes.  The temperature ladder is computed on the host from
params (``ref.mcmc_ladder``) and handed to the kernel.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each wrapper counts its launches in
``.launches``.  Randomness is counter-based, so ``chunk`` and
``replica_block`` change how the work is split and never the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ising_energy import LANE, check_cuda_args

DEFAULT_REPLICA_BLOCK = 256
DEFAULT_CHUNK = LANE
MODES = {"sweep": 0, "random": 1}


def _check(j, h, s0, seeds, params, *, chunk: int, mode: str, replica_block: int):
    """(B, R, N) of the operands; raises on what the kernels do not take."""
    b, r, n = s0.shape
    if (n % LANE or j.shape != (b, n, n) or h.shape != (b, 1, n)
            or seeds.shape != (b, 4) or params.shape != (b, 4)):
        raise ValueError(
            f"untiled shapes: s0 {s0.shape}, j {j.shape}, h {h.shape}, seeds "
            f"{seeds.shape}, params {params.shape}"
        )
    if mode not in MODES:
        raise ValueError(f"unknown mcmc mode {mode!r}")
    if chunk < 1 or n % chunk:
        raise ValueError(f"chunk {chunk} does not divide {n} lanes")
    if replica_block % 8 or r % replica_block:
        raise ValueError(f"{r} replicas are not blocks of {replica_block} (a multiple of 8)")
    return b, r, n


def _ladders(params: torch.Tensor, sweeps: int) -> torch.Tensor:
    """(B, sweeps) float32 temperatures on the CPU, one ladder per instance."""
    p = params.detach().cpu()
    return torch.stack([kref.mcmc_ladder(p[i, 0], p[i, 1], sweeps) for i in range(p.shape[0])])


def _launch(entry: str, j, h, s0, seeds, params, outs, *, sweeps, chunk, mode, replica_block):
    check_cuda_args(j, h, s0, *outs)
    b, r, n = s0.shape
    dev = s0.device
    temps = _ladders(params, sweeps).to(dev)
    seeds = seeds.to(device=dev, dtype=torch.int64).contiguous()
    params = params.to(device=dev, dtype=torch.float32).contiguous()
    err = getattr(_build.library("mcmc_dynamics"), entry)(
        j.data_ptr(), h.data_ptr(), s0.data_ptr(), seeds.data_ptr(), params.data_ptr(),
        temps.data_ptr(), *(t.data_ptr() for t in outs),
        b, r, n, sweeps, chunk, MODES[mode], replica_block, _build.stream_of(s0),
    )
    _build.check(err, entry)


def mcmc_sweep_batched_plain(j, h, s0, seeds, params, *, sweeps, chunk=DEFAULT_CHUNK,
                             mode="sweep", replica_block=DEFAULT_REPLICA_BLOCK):
    """Plain version: instance by instance through ``ref.mcmc_anneal_states``;
    (energies (B, R), spins (B, R, N) f32)."""
    _check(j, h, s0, seeds, params, chunk=chunk, mode=mode, replica_block=replica_block)
    p, sd = params.detach().cpu(), seeds.detach().cpu()
    es, ss = [], []
    for i in range(s0.shape[0]):
        s, e = kref.mcmc_anneal_states(
            j[i], h[i, 0], s0[i], sd[i], kref.mcmc_ladder(p[i, 0], p[i, 1], sweeps),
            n_real=int(p[i, 2]), mode=mode,
        )
        es.append(e)
        ss.append(s)
    return torch.stack(es), torch.stack(ss)


def mcmc_sweep_batched(
    j: torch.Tensor,  # (B, N, N) original couplings
    h: torch.Tensor,  # (B, 1, N)
    s0: torch.Tensor,  # (B, R, N) +-1 initial spins
    seeds: torch.Tensor,  # (B, 4) seed words
    params: torch.Tensor,  # (B, 4) [t_hi, t_lo, n_real, reads]
    *,
    sweeps: int,
    chunk: int = DEFAULT_CHUNK,
    mode: str = "sweep",
    replica_block: int = DEFAULT_REPLICA_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anneal B instances: (best energies (B, R), best spins (B, R, N) f32)."""
    kw = dict(sweeps=sweeps, chunk=chunk, mode=mode, replica_block=replica_block)
    if s0.device.type == "cpu":
        return mcmc_sweep_batched_plain(j, h, s0, seeds, params, **kw)
    b, r, n = _check(j, h, s0, seeds, params, chunk=chunk, mode=mode,
                     replica_block=replica_block)
    e_out = torch.empty((b, r), dtype=torch.float32, device=s0.device)
    s_out = torch.empty_like(s0)
    _launch("mcmc_sweep", j, h, s0, seeds, params, (e_out, s_out), **kw)
    _build.count_launch(mcmc_sweep_batched)
    return e_out, s_out


mcmc_sweep_batched.launches = 0


def mcmc_fused_best_batched_plain(j, h, s0, seeds, params, *, sweeps, chunk=DEFAULT_CHUNK,
                                  mode="sweep", replica_block=DEFAULT_REPLICA_BLOCK):
    """Plain version: all replicas, those at index >= reads masked to +inf,
    first argmin; (energies (B,), spins (B, N) f32)."""
    e, s = mcmc_sweep_batched_plain(j, h, s0, seeds, params, sweeps=sweeps, chunk=chunk,
                                    mode=mode, replica_block=replica_block)
    rep = torch.arange(e.shape[1], dtype=torch.float32, device=e.device)
    reads = params[:, 3].to(device=e.device, dtype=torch.float32)
    e = torch.where(rep[None] < reads[:, None], e, torch.inf)
    first = torch.argmin(e, dim=1)  # the first minimum on ties
    rows = torch.arange(e.shape[0], device=e.device)
    return e[rows, first], s[rows, first]


def mcmc_fused_best_batched(
    j: torch.Tensor,  # (B, N, N)
    h: torch.Tensor,  # (B, 1, N)
    s0: torch.Tensor,  # (B, R, N)
    seeds: torch.Tensor,  # (B, 4)
    params: torch.Tensor,  # (B, 4) [t_hi, t_lo, n_real, reads]
    *,
    sweeps: int,
    chunk: int = DEFAULT_CHUNK,
    mode: str = "sweep",
    replica_block: int = DEFAULT_REPLICA_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused best-of anneal: (energies (B,), spins (B, N) f32), the first
    replica attaining each instance's minimum among its first ``reads``."""
    kw = dict(sweeps=sweeps, chunk=chunk, mode=mode, replica_block=replica_block)
    if s0.device.type == "cpu":
        return mcmc_fused_best_batched_plain(j, h, s0, seeds, params, **kw)
    b, r, n = _check(j, h, s0, seeds, params, chunk=chunk, mode=mode,
                     replica_block=replica_block)
    dev = s0.device
    blk_e = torch.empty((b, r // 8), dtype=torch.float32, device=dev)  # >= 8 replicas a block
    blk_rows = torch.empty((b, r // 8, n), dtype=torch.float32, device=dev)
    e_out = torch.empty(b, dtype=torch.float32, device=dev)
    s_out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _launch("mcmc_fused_best", j, h, s0, seeds, params, (blk_e, blk_rows, e_out, s_out), **kw)
    _build.count_launch(mcmc_fused_best_batched)
    return e_out, s_out


mcmc_fused_best_batched.launches = 0
