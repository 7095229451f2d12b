"""Public wrappers around the CUDA kernels: ``repro.kernels.ops`` for torch.

Responsibilities, as in the reference: pad shapes to the reference's tiles
(lanes of 128, replica blocks of 8-multiples), pre-scale coefficients, draw
the initial phases, and expose the functional API.  Dispatch follows the
tensors' device: the kernel wrappers launch their CUDA kernel on a CUDA
tensor (or raise) and run their plain version on a CPU tensor.

The anneals' padding rules are the reference's exactly, at its default
replica block of 256: ``r_block = min(256, pad8(R))`` and
``r_pad = pad(R, r_block)``.  The phases are drawn at ``(r_pad, n_pad)``
with the reference's threefry stream, so the same key starts every anneal
from the same phases bit for bit.  The MCMC anneal (:func:`mcmc_anneal`)
pads the same way and draws its initial spins from the reference's counters
at ``(r_pad, n_pad)``.  The energy kernel takes its operands unpadded, so
:func:`ising_energy` pads nothing: the reference's zero padding adds only
exact zero terms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ref as kref
from repro_torch.kernels.cobi_dynamics import (
    cobi_fused_best_batched_cuda,
    cobi_fused_best_cuda,
    cobi_readout_cuda,
    cobi_trajectory_batched_cuda,
    cobi_trajectory_cuda,
)
from repro_torch.kernels.ising_energy import (
    LANE,
    ising_energy_batched_cuda,
    ising_energy_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mcmc_dynamics import (
    DEFAULT_CHUNK,
    mcmc_fused_best_batched,
    mcmc_sweep_batched,
)
from repro_torch.kernels import slstm_scan as _slstm  # registers repro_torch::slstm_scan

SLOT_PAD = 8  # slot axis of the fused readout is padded to this multiple
ANNEAL_REPLICA_BLOCK = 256  # the reference's replica_block default


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _padded(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x`` zero-padded to ``shape`` as float32 (``x`` itself when it is
    already that: the kernels only read their operands)."""
    if tuple(x.shape) == tuple(shape) and x.dtype == torch.float32 and x.is_contiguous():
        return x
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    out[tuple(slice(0, d) for d in x.shape)] = x.to(torch.float32)
    return out


def dynamics_scale(h: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Normalizer so one Euler step moves phases by O(dt)."""
    denom = 2.0 * j.abs().sum(dim=-1).max() + h.abs().max()
    return torch.clamp(denom, min=1e-9)


@dataclasses.dataclass(frozen=True)
class AnnealOperands:
    """The padded operands of one solo anneal, as the kernels take them."""

    j_scaled: torch.Tensor  # (n_pad, n_pad) dynamics couplings
    h_scaled: torch.Tensor  # (1, n_pad)
    j_orig: torch.Tensor | None  # (n_pad, n_pad) scoring couplings, as given
    h_orig: torch.Tensor | None  # (1, n_pad); both None unless scoring=True
    phi0: torch.Tensor  # (r_pad, n_pad) initial phases
    n_pad: int
    r_pad: int


def anneal_operands(
    h: torch.Tensor,
    j: torch.Tensor,
    key: torch.Tensor,
    *,
    replicas: int,
    prescaled: bool = False,
    scoring: bool = True,
) -> AnnealOperands:
    """Scale, pad and draw the initial phases exactly as the reference does:
    ``r_block = min(256, pad8(R))``, ``r_pad = pad(R, r_block)``,
    phases ``uniform(key, (r_pad, n_pad), 0, 2 pi)`` on h's device.  The
    scoring copies are the unscaled coefficients, zero-padded, for the
    kernels that score inside the anneal launch; ``scoring=False`` skips
    them (the energy kernel reads h and J unpadded)."""
    h32, j32 = h.to(torch.float32), j.to(torch.float32)
    if prescaled:
        h_s, j_s = h32, j32
    else:
        scale = dynamics_scale(h, j)
        h_s, j_s = h32 / scale, j32 / scale
    n = h.shape[-1]
    n_pad = _pad_to(max(n, LANE), LANE)
    r_block = min(ANNEAL_REPLICA_BLOCK, _pad_to(replicas, 8))
    r_pad = _pad_to(replicas, r_block)
    phi0 = prng.uniform(key, (r_pad, n_pad), 0.0, 2.0 * math.pi, device=h.device)
    return AnnealOperands(
        j_scaled=_padded(j_s, (n_pad, n_pad)),
        h_scaled=_padded(h_s[None], (1, n_pad)),
        j_orig=_padded(j32, (n_pad, n_pad)) if scoring else None,
        h_orig=_padded(h32[None], (1, n_pad)) if scoring else None,
        phi0=phi0,
        n_pad=n_pad,
        r_pad=r_pad,
    )


def solo_slot(n_pad: int, replicas: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused epilogue's (mask (n_pad, SLOT_PAD), reads (1, SLOT_PAD)) for
    one instance: every lane in slot 0 with ``replicas`` valid reads; the
    padding slots have no reads and come back +inf."""
    mask = torch.zeros((n_pad, SLOT_PAD), dtype=torch.float32, device=device)
    mask[:, 0] = 1.0
    reads = torch.zeros((1, SLOT_PAD), dtype=torch.float32, device=device)
    reads[0, 0] = float(replicas)
    return mask, reads


def cobi_anneal(
    h: torch.Tensor,
    j: torch.Tensor,
    key: torch.Tensor,
    *,
    replicas: int = 256,
    steps: int = 300,
    dt: float = 0.35,
    ks_max: float = 1.0,
    reduce: str = "none",
    topk: int | None = None,
    prescaled: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anneal ``replicas`` independent oscillator networks on h's device.

    ``reduce`` selects the readout (all score against the *given* problem):

      * ``"none"`` -- (spins (R, N) int8, energies (R,)): anneal, then a
        separate energy launch on the int8 spins and the unpadded h, J;
      * ``"best"`` -- (spins (N,) int8, energy ()): one fused launch, equal to
        ``"none"`` + first argmin;
      * ``"topk"`` -- (spins (k, N) int8, energies (k,) ascending, stable);
        ``topk=None`` means k = replicas.

    ``prescaled=True`` skips the dynamics normalization.
    """
    if reduce not in ("none", "best", "topk"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    op = anneal_operands(h, j, key, replicas=replicas, prescaled=prescaled,
                         scoring=reduce != "none")
    n = h.shape[-1]
    anneal = dict(steps=steps, dt=dt, ks_max=ks_max)
    jp, hp, ju, hu, phi0 = op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, op.phi0

    if reduce == "none":
        phi = cobi_trajectory_cuda(jp, hp, phi0, **anneal)
        spins = kref.ref_cobi_spins(phi[:replicas, :n])
        return spins, ising_energy(spins, h, j)

    if reduce == "best":
        mask, reads = solo_slot(op.n_pad, replicas, h.device)
        best_e, best_s = cobi_fused_best_cuda(jp, hp, ju, hu, mask, reads, phi0, **anneal)
        return best_s[0, :n].to(torch.int8), best_e[0]

    k = replicas if topk is None else min(int(topk), replicas)
    s_out, e_out = cobi_readout_cuda(jp, hp, ju, hu, phi0, **anneal)
    energies = e_out[:replicas]
    order = torch.argsort(energies, stable=True)[:k]  # ties keep replica order
    return s_out[order][:, :n].to(torch.int8), energies[order]


def ising_energy(
    spins: torch.Tensor,
    h: torch.Tensor,
    j: torch.Tensor,
) -> torch.Tensor:
    """Ising energies for spins in {-1, +1}.  Two layouts:

      * (R, N) or (N,) spins against one instance ``h (N,), j (N, N)`` ->
        (R,) / scalar float32;
      * (B, R, N) spins against a stack ``h (B, N), j (B, N, N)`` -> (B, R),
        in one launch (the chip farm's scoring).

    One kernel launch on the operands as given (int8 or float32 spins, no
    padding copy); the reference's padding adds only exact zero terms.
    """
    if spins.ndim == 3:
        return ising_energy_batched_cuda(spins, h[:, None], j)
    squeeze = spins.ndim == 1
    e = ising_energy_cuda(spins[None] if squeeze else spins, h[None], j)
    return e[0] if squeeze else e


# ---------------------------------------------------------------------------
# Batched (chip-farm) anneals: B instances, block-diagonal packs welcome.
# ---------------------------------------------------------------------------


def cobi_trajectory_batch(
    j_scaled: torch.Tensor,  # (B, N, N) pre-scaled stack
    h_scaled: torch.Tensor,  # (B, N)
    phi0: torch.Tensor,  # (B, R, N) initial phases
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> torch.Tensor:
    """Anneal B independent (possibly packed) instances in one launch.

    The farm pre-scales each block-diagonal sub-block by its own
    ``dynamics_scale`` before packing, so a packed instance's dynamics match
    the instance-at-a-time path block by block.  Returns final phases
    (B, R, N).
    """
    b, r, n = phi0.shape
    n_pad = _pad_to(max(n, LANE), LANE)
    r_block = min(ANNEAL_REPLICA_BLOCK, _pad_to(r, 8))
    r_pad = _pad_to(r, r_block)
    jp = _padded(j_scaled, (b, n_pad, n_pad))
    hp = _padded(h_scaled[:, None], (b, 1, n_pad))
    pp = _padded(phi0, (b, r_pad, n_pad))
    phi = cobi_trajectory_batched_cuda(jp, hp, pp, steps=steps, dt=dt, ks_max=ks_max)
    return phi[:, :r, :n]


def cobi_anneal_batch(
    h: torch.Tensor,  # (B, N)
    j: torch.Tensor,  # (B, N, N)
    key: torch.Tensor,
    *,
    replicas: int = 256,
    steps: int = 300,
    dt: float = 0.35,
    ks_max: float = 1.0,
    prescaled: bool = False,
    reduce: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`cobi_anneal` over a stack of B instances on h's device.

    ``reduce="none"`` returns (spins (B, R, N) int8 in {-1, +1}, energies
    (B, R) f32 of the *given* problems); ``reduce="best"`` fuses the readout
    into the anneal launch and returns only each instance's winner: (spins
    (B, N) int8, energies (B,) f32) -- bit-identical to ``"none"`` + argmin
    on integer instances.  ``prescaled=True`` skips the per-instance dynamics
    normalization (the farm packer applies it per block before packing).
    The phases are ``uniform(key, (B, replicas, N), 0, 2 pi)``, as the
    reference draws them.
    """
    b, n = h.shape
    h32, j32 = h.to(torch.float32), j.to(torch.float32)
    if prescaled:
        h_s, j_s = h32, j32
    else:
        scale = torch.stack([dynamics_scale(hb, jb) for hb, jb in zip(h, j)])  # (B,)
        h_s, j_s = h32 / scale[:, None], j32 / scale[:, None, None]
    phi0 = prng.uniform(key, (b, replicas, n), 0.0, 2.0 * math.pi, device=h.device)
    if reduce == "best":
        mask = torch.ones((b, n, 1), dtype=torch.float32, device=h.device)
        reads = torch.full((b, 1), float(replicas), dtype=torch.float32, device=h.device)
        best_e, best_s = cobi_anneal_packed_best(
            j_s, h_s, j32, h32, mask, reads, phi0, steps=steps, dt=dt, ks_max=ks_max,
        )
        return best_s[:, 0, :n], best_e[:, 0]
    if reduce != "none":
        raise ValueError(f"unknown reduce mode {reduce!r}")
    phi = cobi_trajectory_batch(j_s, h_s, phi0, steps=steps, dt=dt, ks_max=ks_max)
    spins = kref.ref_cobi_spins(phi)
    return spins, ising_energy(spins, h, j)


def cobi_anneal_packed_best(
    j_scaled: torch.Tensor,  # (B, N, N) pre-scaled dynamics couplings (packs welcome)
    h_scaled: torch.Tensor,  # (B, N)
    j_orig: torch.Tensor,  # (B, N, N) original scoring couplings (block-diagonal)
    h_orig: torch.Tensor,  # (B, N)
    mask: torch.Tensor,  # (B, N, S) 0/1 lane->slot assignment
    reads: torch.Tensor,  # (B, S) valid-read count per slot (0 = padding slot)
    phi0: torch.Tensor,  # (B, R, N) initial phases
    *,
    steps: int,
    dt: float,
    ks_max: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused anneal -> readout -> best-of over B (possibly packed) instances.

    The farm hot path: one launch returns (best energies (B, S) f32, best
    spins (B, S, N) int8) -- each slot's first-argmin read scored against the
    ORIGINAL coefficients, with replicas past the slot's read budget ignored.
    Padding slots (``reads == 0``) come back as +inf / garbage; callers index
    only real slots.  Replica spins and phases never leave the device.
    """
    b, r, n = phi0.shape
    s_slots = mask.shape[-1]
    n_pad = _pad_to(max(n, LANE), LANE)
    s_pad = _pad_to(max(s_slots, SLOT_PAD), SLOT_PAD)
    r_block = min(ANNEAL_REPLICA_BLOCK, _pad_to(r, 8))
    r_pad = _pad_to(r, r_block)
    e_out, s_out = cobi_fused_best_batched_cuda(
        _padded(j_scaled, (b, n_pad, n_pad)),
        _padded(h_scaled[:, None], (b, 1, n_pad)),
        _padded(j_orig, (b, n_pad, n_pad)),
        _padded(h_orig[:, None], (b, 1, n_pad)),
        _padded(mask, (b, n_pad, s_pad)),
        _padded(reads[:, None], (b, 1, s_pad)),
        _padded(phi0, (b, r_pad, n_pad)),
        steps=steps, dt=dt, ks_max=ks_max,
    )
    return e_out[:, :s_slots], s_out[:, :s_slots, :n].to(torch.int8)


# ---------------------------------------------------------------------------
# MCMC: asynchronous Metropolis sweeps (the second solver family).
# ---------------------------------------------------------------------------


def mcmc_anneal(
    h: torch.Tensor,
    j: torch.Tensor,
    key: torch.Tensor,
    *,
    replicas: int = 8,
    sweeps: int = 50,
    chunk: int = DEFAULT_CHUNK,
    mode: str = "sweep",
    t_hi=None,
    t_lo: float = 0.05,
    replica_block: int = ANNEAL_REPLICA_BLOCK,
    reduce: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asynchronous Metropolis sweeps over ``replicas`` chains on h's device.

    Geometric per-sweep temperature ladder from ``t_hi`` (default
    ``ref.mcmc_t_hi`` of the unpadded J) down to ``t_lo``, proposals in
    order (``mode="sweep"``) or uniform (``"random"``), counter-based
    randomness from ``key``.  There is no dynamics pre-scale: the given
    couplings drive the proposals and score the energies.

    ``reduce="none"`` returns each replica's best-visited state (spins
    (R, N) int8, energies (R,) f32); ``"best"`` fuses the first-argmin
    replica reduction into the launch (spins (N,) int8, energy () f32),
    equal to ``"none"`` + first argmin.
    """
    if reduce not in ("none", "best"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    n = h.shape[-1]
    if t_hi is None:
        t_hi = kref.mcmc_t_hi(j)  # unpadded: padding would reorder the row sums
    t_hi = float(np.float32(float(t_hi)))

    n_pad = _pad_to(max(n, LANE), LANE)
    r_block = min(replica_block, _pad_to(replicas, 8))
    r_pad = _pad_to(replicas, r_block)
    seeds = kref.mcmc_seeds(key)
    s0 = kref.mcmc_init_spins(seeds[0], r_pad, n_pad, device=h.device)
    params = torch.tensor([[t_hi, t_lo, float(n), float(replicas)]], dtype=torch.float32)
    operands = (_padded(j, (n_pad, n_pad))[None], _padded(h[None], (1, n_pad))[None],
                s0[None], seeds[None], params)
    kw = dict(sweeps=sweeps, chunk=chunk, mode=mode, replica_block=r_block)
    if reduce == "best":
        e, s = mcmc_fused_best_batched(*operands, **kw)
        return s[0, :n].to(torch.int8), e[0]
    e, s = mcmc_sweep_batched(*operands, **kw)
    return s[0, :replicas, :n].to(torch.int8), e[0, :replicas]


def flash_attention(q, k, v, *, causal=True, window=None):
    """Blocked attention of q (B, Sq, H, D) over k, v (B, Skv, KV, D) at the
    reference's 128-row tiles; see kernels/flash_attention.py.  A CUDA
    tensor launches the kernel (or raises), a CPU tensor runs its plain
    version.

    Forward only, as the reference's kernel is (it defines no VJP): with
    autograd recording and an input that requires grad it raises rather
    than return an output cut off from the graph.  Training runs
    ``attn_impl="auto"``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: the reference's flash kernel defines none, so "
            "a train step runs attn_impl='auto' (the chunked route); call flash under "
            "torch.no_grad() or on inputs that do not require grad")
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def slstm_scan(wx, r, bias, state):
    """The sLSTM recurrence of wx (B, S, 4D), the input projection, with
    recurrent weights r (NH, dh, 4dh) and bias (4D,) from ``state`` {c, n,
    h, m} (B, D): (hs (B, S, D), the final {c, n, h, m}), all float32.  One
    call of the custom op ``repro_torch::slstm_scan`` (kernels/slstm_scan.py):
    one kernel launch on the card, the plain loop on the CPU, shapes only
    under ``FakeTensorMode``; its autograd rule runs the reverse scan (one
    launch).  The op keeps what its backward needs only when autograd
    records it.  Functional: the state is read, never written."""
    args = [t.to(torch.float32).contiguous() for t in
            (wx, r, bias, state["c"], state["n"], state["h"], state["m"])]
    save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    hs, c, n, h, m, _, _ = _slstm.slstm_scan(*args, save)
    return hs, {"c": c, "n": n, "h": h, "m": m}
