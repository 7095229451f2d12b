"""Quantization / rounding of Ising coefficients (paper Sec. IV-A, C3).

COBI supports integer couplings ``h_i, J_ij in [-14, +14]``.  One joint scale
maps max(|h|, |J|) onto the integer range, then one of three schemes rounds:

  * ``deterministic``      -- round to nearest (half to even).
  * ``stochastic_5050``    -- floor/ceil with probability 1/2 each.
  * ``stochastic``         -- floor + Bernoulli(frac)  (unbiased SR).

J is rounded on the strict upper triangle and mirrored, as on the chip.  The
uniforms are drawn with :mod:`repro_torch.prng` at the reference's shapes
(``h.shape`` from the first half of ``split(key)``, ``(n, n)`` from the
second), so the same key rounds to the same integers bit for bit.  K
roundings of one instance are one batch, as the reference's vmapped launch
(:func:`quantize_ising_many`); :func:`quantize_ising` is its K = 1 case.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core.formulation import IsingProblem

COBI_RANGE = 14  # native integer coupling range of the COBI chip
SCHEMES = ("deterministic", "stochastic_5050", "stochastic")


def int_range_for_bits(bits: int) -> int:
    """Symmetric integer range for a b-bit signed fixed-point format."""
    if bits < 2:
        raise ValueError(f"need >=2 bits, got {bits}")
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QuantizedIsing:
    """An integer-coefficient Ising instance plus its scale back to FP."""

    ising: IsingProblem  # integer-valued h, J (stored as float32)
    scale: float  # fp_coeff ~= int_coeff / scale


def joint_scale(ising: IsingProblem, int_range: int) -> float:
    """Single scale mapping max(|h|, |J|) onto the integer range: the float32
    division of ``_quantize_many`` (one host sync)."""
    m = torch.maximum(ising.h.abs().max(), ising.j.abs().max()).to(torch.float32)
    return float(torch.full((), float(int_range), dtype=torch.float32, device=m.device)
                 / torch.clamp(m, min=1e-12))


def _round(v: torch.Tensor, scheme: str, u: Optional[torch.Tensor]) -> torch.Tensor:
    """Round ``v`` with the uniforms ``u`` (K, *v.shape), one row per
    rounding; ``deterministic`` takes none and returns v's shape."""
    if scheme == "deterministic":
        return torch.round(v)
    lo = torch.floor(v)
    frac = v - lo
    if scheme == "stochastic_5050":
        # Integer-valued entries stay put; otherwise 50/50 floor vs ceil.
        p_up = torch.where(frac > 0.0, 0.5, 0.0)
    else:
        p_up = frac
    return lo + (u < p_up).to(v.dtype)


def _quantize_many(ising: IsingProblem, keys: list, scheme: str,
                   int_range: int) -> list[QuantizedIsing]:
    """The reference's vmapped ``_quantize_arrays`` over K keys as one
    batch: the scale once, two draws for all K, then round, clamp and
    mirror the stacked (K, n) and (K, n, n) operands."""
    h, j = ising.h.to(torch.float32), ising.j.to(torch.float32)
    dev, n, kk = h.device, h.shape[-1], len(keys)
    m = torch.maximum(h.abs().max(), j.abs().max())
    # A true float32 division: torch evaluates ``int / tensor`` as a
    # reciprocal times the int, which can round the scale differently.
    scale = torch.full((), float(int_range), dtype=torch.float32, device=dev) / torch.clamp(
        m, min=1e-12)
    uh = uj = None
    if scheme != "deterministic":
        halves = prng.split_host(keys)  # (K, 2, 2): each key's (kh, kj)
        uh = prng.uniform_many(halves[:, 0], (n,), device=dev)
        uj = prng.uniform_many(halves[:, 1], (n, n), device=dev)
    h_q = torch.clamp(_round(h * scale, scheme, uh), -int_range, int_range)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), 1)
    j_q = torch.where(upper, _round(j * scale, scheme, uj), 0.0)
    j_q = torch.clamp(j_q + j_q.transpose(-1, -2), -int_range, int_range)
    if scheme == "deterministic":  # one rounding, K copies
        h_q, j_q = h_q.expand(kk, n).contiguous(), j_q.expand(kk, n, n).contiguous()
    s = float(scale)  # the call's one host sync
    return [QuantizedIsing(ising=IsingProblem(h=h_q[i], j=j_q[i]), scale=s) for i in range(kk)]


def _check(scheme: str, bits: Optional[int], int_range: int) -> int:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown rounding scheme {scheme!r}; want one of {SCHEMES}")
    return int_range if bits is None else int_range_for_bits(bits)


def quantize_ising(
    ising: IsingProblem,
    scheme: str = "stochastic",
    *,
    int_range: int = COBI_RANGE,
    bits: Optional[int] = None,
    key: Optional[torch.Tensor] = None,
) -> QuantizedIsing:
    """Quantize (h, J) to integers in [-R, R] with the given rounding scheme.

    ``bits`` overrides ``int_range`` with the b-bit fixed-point range.  The
    instance stays on the device of ``ising.h``.
    """
    int_range = _check(scheme, bits, int_range)
    if key is None and scheme != "deterministic":
        raise ValueError(f"scheme {scheme!r} needs a PRNG key")
    return _quantize_many(ising, [key], scheme, int_range)[0]


def quantize_ising_many(
    ising: IsingProblem,
    keys: Sequence[torch.Tensor],
    scheme: str = "stochastic",
    *,
    int_range: int = COBI_RANGE,
    bits: Optional[int] = None,
) -> list[QuantizedIsing]:
    """K independent roundings of ONE instance, one per key, in one batch:
    identical to ``[quantize_ising(ising, scheme, key=k) for k in keys]``.

    As the reference's vmapped launch: the keys split on the host in one
    numpy pass, h's and J's uniforms drawn for all K keys in one
    ``uniform_many`` each, and one host sync (the scale).  Each result's
    ``ising.h`` / ``ising.j`` is a view of a (K, n) / (K, n, n) stack on the
    device of ``ising.h``.
    """
    int_range = _check(scheme, bits, int_range)
    keys = list(keys)
    return _quantize_many(ising, keys, scheme, int_range) if keys else []
