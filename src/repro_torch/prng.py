"""Counter-based threefry2x32 PRNG, bit-compatible with ``jax.random``.

The reference draws every random number of the summarization pipeline from
``jax.random`` in its default mode (threefry2x32 with
``jax_threefry_partitionable=True``).  This module reproduces the four calls
the pipeline makes -- ``key``, ``split``, ``bits`` and ``uniform`` -- so that
the port, handed the same key words, rounds the same integer instances and
starts its anneals from the same phases, bit for bit.  :func:`uniform_many`
is ``jax.vmap(jax.random.uniform)`` over a stack of keys, as the chip farm
draws each job's phases.

A key is a ``(2,)`` int64 tensor on the CPU holding the two uint32 words of
``jax.random.key_data(key)``.  Keys are threaded explicitly through every
call; there is no global generator state.

The hash runs on int64 tensors masked to 32 bits (CPU ``uint32`` tensors have
no ``+`` or ``>>`` in torch), so the same code runs on CPU and CUDA tensors,
and on int64 numpy arrays (:func:`bits_host`).
``bits``, ``uniform`` and ``uniform_many`` draw on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` as raw words: ``[0, seed mod 2**32]``
    (32-bit seeding, the reference's default with x64 disabled)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on int64-held uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(k: torch.Tensor) -> tuple[int, int]:
    w = k.tolist()
    return int(w[0]), int(w[1])


def _iota(shape: Sequence[int], device) -> torch.Tensor:
    """The flat counter of ``shape`` (the partitionable iota: the high word
    is 0 below 2**32 elements, the low word is the flat index)."""
    size = math.prod(shape)
    if size >= 2**32:
        raise NotImplementedError("random draws of 2**32 or more elements")
    return torch.arange(size, dtype=torch.int64, device=device)


def _hash_iota(k: torch.Tensor, shape: Sequence[int], device) -> tuple:
    """Hash the flat counter of ``shape`` under one key."""
    lo = _iota(shape, device)
    k1, k2 = _words(k)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def bits_host(k: torch.Tensor, size: int) -> np.ndarray:
    """``jax.random.bits(key, (size,))`` as int64 numpy on the host: the
    same hash on numpy arrays, for draws too small to be worth torch ops."""
    k1, k2 = _words(k)
    b1, b2 = threefry2x32(k1, k2, np.zeros(size, np.int64), np.arange(size, dtype=np.int64))
    return b1 ^ b2


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) int64 key words."""
    b1, b2 = _hash_iota(k, (num,), "cpu")
    return torch.stack([b1, b2], dim=1)


def bits(k: torch.Tensor, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2**32),
    on ``device`` (``None``: the card)."""
    b1, b2 = _hash_iota(k, tuple(shape), resolve_device(device))
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(
    k: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    device=None,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    Same bit recipe as the reference: the top 23 bits fill the mantissa of a
    float in [1, 2), minus 1, scaled and shifted in float32, floored at
    ``minval``.
    """
    device = resolve_device(device)
    return _to_uniform(bits(k, shape, device=device), minval, maxval)


def _to_uniform(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=b.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=b.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform_many(
    keys: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    device=None,
) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, shape, float32, minval,
    maxval))(keys)`` for (K, 2) key words: (K, *shape), row k drawn from key
    k alone.  One threefry hash over (K, size): each key's words ride as
    (K, 1) columns."""
    device = resolve_device(device)
    keys = torch.as_tensor(keys, dtype=torch.int64).to(device)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys are (K, 2) words, got shape {tuple(keys.shape)}")
    lo = _iota(shape, device)[None]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return _to_uniform(b1 ^ b2, minval, maxval).reshape(keys.shape[0], *shape)
