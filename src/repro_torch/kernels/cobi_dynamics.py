"""COBI coupled-oscillator anneal: the CUDA kernels' wrappers and their plain
versions.

Ports of ``repro.kernels.cobi_dynamics``:

  * :func:`cobi_trajectory_cuda` -- ``cobi_trajectory_pallas``: final phases.
  * :func:`cobi_readout_cuda`    -- ``cobi_readout_pallas``: anneal, sign
    readout and every read's energy, in one launch.
  * :func:`cobi_fused_best_cuda` -- ``cobi_fused_best_pallas``: anneal, sign,
    per-slot energies and the first-argmin best read of each slot.
  * :func:`cobi_trajectory_batched_cuda` -- ``cobi_trajectory_batched_pallas``
    and :func:`cobi_fused_best_batched_cuda` --
    ``cobi_fused_best_batched_pallas``: the same over a stack of B (packed)
    instances, one launch with grid (R / AR, B), AR replica rows a block
    (``cobi_anneal_rows``).  The chip farm's drains.

All of them share one Euler loop (``csrc/cobi_anneal.cuh``), so for the same
inputs their phases are bitwise identical and the fused best equals the
readout plus a first argmin.  Shapes are the padded ones ``ops`` builds
(lanes a multiple of 128, replica rows a multiple of 8).  On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises.  Each wrapper counts its launches in ``.launches``; a batched wrapper
counts apart from its solo twin.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ising_energy import BR, LANE, check_cuda_args


def _check_tiles(phi0: torch.Tensor, j: torch.Tensor, h: torch.Tensor) -> tuple[int, int, int]:
    """(B, R, N) of batched operands j (B, N, N), h (B, 1, N), phi0 (B, R, N)."""
    b, r, n = phi0.shape
    if n % LANE or r % BR or j.shape != (b, n, n) or h.shape != (b, 1, n):
        raise ValueError(f"untiled shapes: phi0 {phi0.shape}, j {j.shape}, h {h.shape}")
    return b, r, n


def _check_fused(j_orig, h_orig, mask, reads, b: int, n: int) -> int:
    """The fused epilogue's operands for B instances of n lanes; returns S."""
    s_slots = mask.shape[-1]
    if (j_orig.shape != (b, n, n) or h_orig.shape != (b, 1, n)
            or mask.shape != (b, n, s_slots) or reads.shape != (b, 1, s_slots)):
        raise ValueError(
            f"fused shapes: j {j_orig.shape}, h {h_orig.shape}, mask {mask.shape}, "
            f"reads {reads.shape} for {b} x {n} lanes"
        )
    if not 1 <= s_slots <= n:
        raise ValueError(
            f"the fused best takes 1 to {n} slots (one job per lane), got {s_slots}"
        )
    return s_slots


# ---------------------------------------------------------------- trajectory


def _trajectory(j_scaled, h_scaled, phi0, *, steps, dt, ks_max) -> torch.Tensor:
    """Launch ``cobi_trajectory`` on batched operands; returns (B, R, N)."""
    b, r, n = _check_tiles(phi0, j_scaled, h_scaled)
    check_cuda_args(j_scaled, h_scaled, phi0)
    out = torch.empty_like(phi0)
    err = _build.library("cobi_dynamics").cobi_trajectory(
        j_scaled.data_ptr(), h_scaled.data_ptr(), phi0.data_ptr(), out.data_ptr(),
        b, r, n, steps, dt, ks_max, _build.stream_of(phi0),
    )
    _build.check(err, "cobi_trajectory")
    return out


def cobi_trajectory_plain(j_scaled, h_scaled, phi0, *, steps, dt, ks_max):
    """Plain version: j (N, N), h (1, N), phi0 (R, N) -> final phases (R, N)."""
    return kref.ref_cobi_trajectory(
        j_scaled, h_scaled[0], phi0, steps=steps, dt=dt, ks_max=ks_max
    )


def cobi_trajectory_cuda(
    j_scaled: torch.Tensor,  # (N, N) pre-scaled
    h_scaled: torch.Tensor,  # (1, N)
    phi0: torch.Tensor,  # (R, N)
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> torch.Tensor:
    """Final phases (R, N) of R independent anneals."""
    if phi0.device.type == "cpu":
        return cobi_trajectory_plain(j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    out = _trajectory(j_scaled[None], h_scaled[None], phi0[None],
                      steps=steps, dt=dt, ks_max=ks_max)
    _build.count_launch(cobi_trajectory_cuda)
    return out[0]


cobi_trajectory_cuda.launches = 0


def cobi_trajectory_batched_plain(j_scaled, h_scaled, phi0, *, steps, dt, ks_max):
    """Plain version: j (B, N, N), h (B, 1, N), phi0 (B, R, N) -> (B, R, N),
    instance by instance (the reference's vmap of its oracle)."""
    return torch.stack([
        cobi_trajectory_plain(jb, hb, pb, steps=steps, dt=dt, ks_max=ks_max)
        for jb, hb, pb in zip(j_scaled, h_scaled, phi0)
    ])


def cobi_trajectory_batched_cuda(
    j_scaled: torch.Tensor,  # (B, N, N) pre-scaled, block-diagonal packs welcome
    h_scaled: torch.Tensor,  # (B, 1, N)
    phi0: torch.Tensor,  # (B, R, N)
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> torch.Tensor:
    """Final phases (B, R, N) of B instances' R anneals each, one launch."""
    if phi0.device.type == "cpu":
        return cobi_trajectory_batched_plain(
            j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    out = _trajectory(j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    _build.count_launch(cobi_trajectory_batched_cuda)
    return out


cobi_trajectory_batched_cuda.launches = 0


# ------------------------------------------------------------------- readout


def cobi_readout_plain(j_scaled, h_scaled, j_orig, h_orig, phi0, *, steps, dt, ks_max):
    """Plain version: (spins (R, N) f32 in {-1, +1}, energies (R,))."""
    phi = cobi_trajectory_plain(j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    s = kref.sign_spins(phi)
    return s, kref.ref_ising_energy(s, h_orig[0], j_orig)


def cobi_readout_cuda(
    j_scaled: torch.Tensor,  # (N, N)
    h_scaled: torch.Tensor,  # (1, N)
    j_orig: torch.Tensor,  # (N, N) scoring couplings
    h_orig: torch.Tensor,  # (1, N)
    phi0: torch.Tensor,  # (R, N)
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anneal + sign + score keeping all reads: (spins (R, N) f32, energies (R,))."""
    if phi0.device.type == "cpu":
        return cobi_readout_plain(
            j_scaled, h_scaled, j_orig, h_orig, phi0, steps=steps, dt=dt, ks_max=ks_max
        )
    _, r, n = _check_tiles(phi0[None], j_scaled[None], h_scaled[None])
    if j_orig.shape != (n, n) or h_orig.shape != (1, n):
        raise ValueError(f"scoring shapes j {j_orig.shape}, h {h_orig.shape} != lanes {n}")
    check_cuda_args(j_scaled, h_scaled, j_orig, h_orig, phi0)
    spins = torch.empty_like(phi0)
    energies = torch.empty(r, dtype=torch.float32, device=phi0.device)
    err = _build.library("cobi_dynamics").cobi_readout(
        j_scaled.data_ptr(), h_scaled.data_ptr(), j_orig.data_ptr(), h_orig.data_ptr(),
        phi0.data_ptr(), spins.data_ptr(), energies.data_ptr(),
        1, r, n, steps, dt, ks_max, _build.stream_of(phi0),
    )
    _build.check(err, "cobi_readout")
    _build.count_launch(cobi_readout_cuda)
    return spins, energies


cobi_readout_cuda.launches = 0


# ---------------------------------------------------------------- fused best


def _fused_best(j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0,
                *, steps, dt, ks_max) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``cobi_fused_best`` on batched operands: (e (B, S), s (B, S, N))."""
    b, r, n = _check_tiles(phi0, j_scaled, h_scaled)
    s_slots = _check_fused(j_orig, h_orig, mask, reads, b, n)
    check_cuda_args(j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0)
    dev = phi0.device
    lib = _build.library("cobi_dynamics")
    nblk = r // lib.cobi_anneal_rows()  # scratch entries: one per anneal block
    blk_e = torch.empty((b, nblk, s_slots), dtype=torch.float32, device=dev)
    blk_rows = torch.empty((b, nblk, s_slots, n), dtype=torch.float32, device=dev)
    e_out = torch.empty((b, s_slots), dtype=torch.float32, device=dev)
    s_out = torch.empty((b, s_slots, n), dtype=torch.float32, device=dev)
    err = lib.cobi_fused_best(
        j_scaled.data_ptr(), h_scaled.data_ptr(), j_orig.data_ptr(), h_orig.data_ptr(),
        mask.data_ptr(), reads.data_ptr(), phi0.data_ptr(),
        blk_e.data_ptr(), blk_rows.data_ptr(), e_out.data_ptr(), s_out.data_ptr(),
        b, r, n, s_slots, steps, dt, ks_max, _build.stream_of(phi0),
    )
    _build.check(err, "cobi_fused_best")
    return e_out, s_out


def cobi_fused_best_plain(
    j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0, *, steps, dt, ks_max
):
    """Plain version: (best energies (S,), best spins (S, N) f32)."""
    phi = cobi_trajectory_plain(j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    best_e, best_s = kref.ref_cobi_fused_best(
        phi[None], j_orig[None], h_orig, mask[None], reads
    )
    return best_e[0], best_s[0]


def cobi_fused_best_cuda(
    j_scaled: torch.Tensor,  # (N, N) pre-scaled dynamics couplings
    h_scaled: torch.Tensor,  # (1, N)
    j_orig: torch.Tensor,  # (N, N) original (scoring) couplings
    h_orig: torch.Tensor,  # (1, N)
    mask: torch.Tensor,  # (N, S) 0/1 lane->slot assignment, 1 <= S <= N
    reads: torch.Tensor,  # (1, S) f32 valid-read count per slot
    phi0: torch.Tensor,  # (R, N)
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused anneal -> sign -> per-slot first-argmin best read:
    (best energies (S,), best spins (S, N) f32 in {-1, +1})."""
    if phi0.device.type == "cpu":
        return cobi_fused_best_plain(
            j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0,
            steps=steps, dt=dt, ks_max=ks_max,
        )
    e_out, s_out = _fused_best(
        j_scaled[None], h_scaled[None], j_orig[None], h_orig[None], mask[None],
        reads[None], phi0[None], steps=steps, dt=dt, ks_max=ks_max,
    )
    _build.count_launch(cobi_fused_best_cuda)
    return e_out[0], s_out[0]


cobi_fused_best_cuda.launches = 0


def cobi_fused_best_batched_plain(
    j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0, *, steps, dt, ks_max
):
    """Plain version: (best energies (B, S), best spins (B, S, N) f32)."""
    phi = cobi_trajectory_batched_plain(
        j_scaled, h_scaled, phi0, steps=steps, dt=dt, ks_max=ks_max)
    return kref.ref_cobi_fused_best(phi, j_orig, h_orig[:, 0], mask, reads[:, 0])


def cobi_fused_best_batched_cuda(
    j_scaled: torch.Tensor,  # (B, N, N) pre-scaled, block-diagonal packs
    h_scaled: torch.Tensor,  # (B, 1, N)
    j_orig: torch.Tensor,  # (B, N, N) original (scoring) couplings
    h_orig: torch.Tensor,  # (B, 1, N)
    mask: torch.Tensor,  # (B, N, S) 0/1 lane->slot assignment, 1 <= S <= N
    reads: torch.Tensor,  # (B, 1, S) f32 read budget per slot (0: padding)
    phi0: torch.Tensor,  # (B, R, N)
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused best over B packed bins in one launch: (best energies (B, S),
    best spins (B, S, N) f32 in {-1, +1}); padding slots come back +inf."""
    if phi0.device.type == "cpu":
        return cobi_fused_best_batched_plain(
            j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0,
            steps=steps, dt=dt, ks_max=ks_max,
        )
    out = _fused_best(j_scaled, h_scaled, j_orig, h_orig, mask, reads, phi0,
                      steps=steps, dt=dt, ks_max=ks_max)
    _build.count_launch(cobi_fused_best_batched_cuda)
    return out


cobi_fused_best_batched_cuda.launches = 0
