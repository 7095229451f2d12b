"""Quantization / rounding of Ising coefficients (paper Sec. IV-A, C3).

COBI supports integer couplings ``h_i, J_ij in [-14, +14]``.  One joint scale
maps max(|h|, |J|) onto the integer range, then one of three schemes rounds:

  * ``deterministic``      -- round to nearest (half to even).
  * ``stochastic_5050``    -- floor/ceil with probability 1/2 each.
  * ``stochastic``         -- floor + Bernoulli(frac)  (unbiased SR).

J is rounded on the strict upper triangle and mirrored, as on the chip.  The
uniforms are drawn with :mod:`repro_torch.prng` at the reference's shapes
(``h.shape`` from the first half of ``split(key)``, ``(n, n)`` from the
second), so the same key rounds to the same integers bit for bit.
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


def _round(v: torch.Tensor, scheme: str, key: Optional[torch.Tensor]) -> torch.Tensor:
    if scheme == "deterministic":
        return torch.round(v)
    lo = torch.floor(v)
    frac = v - lo
    if scheme == "stochastic_5050":
        # Integer-valued entries stay put; otherwise 50/50 floor vs ceil.
        p_up = torch.where(frac > 0.0, 0.5, 0.0)
    else:
        p_up = frac
    up = prng.uniform(key, v.shape, device=v.device) < p_up
    return lo + up.to(v.dtype)


def _quantize_arrays(h, j, key, *, scheme: str, int_range: int):
    n = h.shape[-1]
    m = torch.maximum(h.abs().max(), j.abs().max())
    # A true float32 division: torch evaluates ``int / tensor`` as a
    # reciprocal times the int, which can round the scale differently.
    scale = torch.tensor(float(int_range), device=h.device) / torch.clamp(m, min=1e-12)
    kh, kj = prng.split(key) if scheme != "deterministic" else (None, None)
    h_q = torch.clamp(_round(h * scale, scheme, kh), -int_range, int_range)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=h.device), 1)
    j_q = torch.where(upper, _round(j * scale, scheme, kj), 0.0)
    j_q = torch.clamp(j_q + j_q.T, -int_range, int_range)
    return h_q, j_q, scale


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
    h_q, j_q, scale = _quantize_arrays(
        ising.h.to(torch.float32), ising.j.to(torch.float32), key,
        scheme=scheme, int_range=int_range,
    )
    return QuantizedIsing(ising=IsingProblem(h=h_q, j=j_q), scale=float(scale))


def quantize_ising_many(
    ising: IsingProblem,
    keys: Sequence[torch.Tensor],
    scheme: str = "stochastic",
    *,
    int_range: int = COBI_RANGE,
    bits: Optional[int] = None,
) -> list[QuantizedIsing]:
    """K independent roundings of ONE instance, one per key: identical to
    ``[quantize_ising(ising, scheme, key=k) for k in keys]``."""
    return [
        quantize_ising(ising, scheme, int_range=int_range, bits=bits, key=k)
        for k in keys
    ]
