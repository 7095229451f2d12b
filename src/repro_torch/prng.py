"""Counter-based threefry2x32 PRNG, bit-compatible with ``jax.random``.

The reference draws every random number of the summarization pipeline from
``jax.random`` in its default mode (threefry2x32 with
``jax_threefry_partitionable=True``).  This module reproduces the four calls
the system makes -- ``key``, ``split``, ``fold_in``, ``bits``, ``uniform``,
``randint``, ``bernoulli``, ``permutation`` and ``normal`` -- so that the
port, handed the same key words, rounds the same integer instances, starts
its anneals from the same phases and keys each served request the same way,
bit for bit (``normal`` within 2 ulp: see its docstring).
:func:`uniform_many` is ``jax.vmap(jax.random.uniform)`` over a stack of
keys, as the chip farm draws each job's phases and the rounding draws K
roundings' uniforms; :func:`split_host` is ``split`` of K keys at once, on
the host, and :func:`split_chain` walks a carried key chain there.

A key is a ``(2,)`` int64 tensor on the CPU holding the two uint32 words of
``jax.random.key_data(key)``.  Keys are threaded explicitly through every
call; there is no global generator state.

The hash runs on int64 tensors masked to 32 bits (CPU ``uint32`` tensors have
no ``+`` or ``>>`` in torch), so the same code runs on CPU and CUDA tensors,
and on int64 numpy arrays (:func:`bits_host`).
Every draw lands on the card unless the caller passes ``device="cpu"``.
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


def split_host(keys: Sequence[torch.Tensor], num: int = 2) -> np.ndarray:
    """``split(k, num)`` of every key at once, on the host: (K, num, 2)
    int64 numpy key words, row k split from ``keys[k]`` alone.  One numpy
    threefry pass over (K, num) counters, each key's words riding as a
    column, so splitting K keys costs no torch op and no device round trip."""
    words = np.stack([np.asarray(k, dtype=np.int64) for k in keys])  # (K, 2)
    lo = np.arange(num, dtype=np.int64)[None]
    b1, b2 = threefry2x32(words[:, :1], words[:, 1:], np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) int64 key words, hashed on
    the host."""
    return torch.from_numpy(split_host([k], num)[0])


def bits(k: torch.Tensor, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2**32),
    on ``device`` (``None``: the card)."""
    b1, b2 = _hash_iota(k, tuple(shape), resolve_device(device))
    return (b1 ^ b2).reshape(tuple(shape))


def bits_at(k: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The elements at flat ``index`` (int64, below 2**32) of any
    ``bits(k, shape)`` draw, on index's device: a block of a draw without
    the rest of it (a rank's shard of a sharded tensor's draw)."""
    k1, k2 = _words(k)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(index), index)
    return b1 ^ b2


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


def uniform_at(k: torch.Tensor, index: torch.Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """The elements at flat ``index`` of ``uniform(k, shape, minval,
    maxval)`` for any ``shape`` (see :func:`bits_at`)."""
    return _to_uniform(bits_at(k, index), minval, maxval)


def block_index(shape, block) -> torch.Tensor:
    """The flat indices (int64, on the CPU) of the block of a row-major
    ``shape`` given as one ``slice`` a dim."""
    index = torch.zeros((), dtype=torch.int64)
    stride = 1
    for d in reversed(range(len(shape))):
        coords = torch.arange(shape[d], dtype=torch.int64)[block[d]]
        index = index + (coords * stride).reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= shape[d]
    return index


def _to_uniform(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # Filled on the device: a host scalar copied there would sync the host.
    lo = torch.full((), minval, dtype=torch.float32, device=b.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=b.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def _key_rows(keys, device) -> torch.Tensor:
    """(K, 2) int64 key words on ``device``; from the CPU through pinned
    memory without blocking (a pageable copy syncs the host)."""
    keys = torch.as_tensor(keys, dtype=torch.int64)
    if device.type == "cuda" and keys.device.type == "cpu":
        keys = keys.pin_memory().to(device, non_blocking=True)
    else:
        keys = keys.to(device)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys are (K, 2) words, got shape {tuple(keys.shape)}")
    return keys


def _bits_rows(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.bits(k, shape))`` for (K, 2) key words
    on their device: one threefry hash over (K, size), each key's words
    riding as (K, 1) columns."""
    lo = _iota(shape, keys.device)[None]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(keys.shape[0], *shape)


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
    k alone, in one hash."""
    keys = _key_rows(keys, resolve_device(device))
    return _to_uniform(_bits_rows(keys, shape), minval, maxval)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``[0, data mod 2**32]`` (``threefry_2x32(key, threefry_seed(data))``),
    on the host."""
    k1, k2 = _words(k)
    b1, b2 = threefry2x32(k1, k2, 0, int(data) & _MASK)
    return torch.tensor([b1, b2], dtype=torch.int64)


def split_chain(k: torch.Tensor, steps: int, num: int) -> np.ndarray:
    """The keys a loop draws when each of its ``steps`` iterations does
    ``key, *subkeys = split(key, num)``: (steps, num - 1, 2) int64 numpy
    words, walked on the host in Python integers (the chain is sequential;
    one step costs ``num`` threefry hashes of scalars)."""
    k1, k2 = _words(k)
    out = np.empty((steps, num - 1, 2), np.int64)
    for t in range(steps):
        words = [threefry2x32(k1, k2, 0, i) for i in range(num)]
        (k1, k2), out[t] = words[0], words[1:]
    return out


def _randint_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                  maxval: int) -> torch.Tensor:
    """``jax.random.randint``'s int32 arithmetic on two 32-bit draws: the
    offset ``(hi % span) * (2**32 % span) + lo % span`` in wrapping uint32,
    modulo the span, masked to 32 bits after every product."""
    minval = max(int(minval), -(2**31))
    maxval = min(int(maxval), 2**31 - 1)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    return (minval + offset % span).to(torch.int32)


def randint_many(keys, shape: Sequence[int], minval: int, maxval: int, *,
                 device=None) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.randint(k, shape, minval, maxval))``
    for (K, 2) key words: (K, *shape) int32.  Each key splits in two on the
    host; its 32 higher and 32 lower bits a value come from one hash pass
    on ``device``."""
    device = resolve_device(device)
    halves = split_host(keys, 2)
    return _randint_bits(_bits_rows(_key_rows(halves[:, 0], device), shape),
                         _bits_rows(_key_rows(halves[:, 1], device), shape), minval, maxval)


def randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            *, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32)."""
    return randint_many(k[None], shape, minval, maxval, device=device)[0]


def bernoulli(k: torch.Tensor, p: float = 0.5, shape: Sequence[int] = (), *,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``): a float32
    uniform draw below ``p``, as bool."""
    u = uniform(k, shape, device=device)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def permutation_many(keys, n: int, *, device=None) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.permutation(k, n))`` for (K, 2) key
    words: (K, n) int64.  Each of ``ceil(3 ln n / ln(2**32 - 1))`` rounds
    (1 for any n below 2**32 ** (1/3)) splits every key and stable-sorts the
    running permutation by fresh 32-bit sort keys, as ``lax.sort_key_val``
    does."""
    device = resolve_device(device)
    keys = np.asarray(keys, dtype=np.int64)
    x = torch.arange(n, dtype=torch.int64, device=device).expand(keys.shape[0], n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        halves = split_host(keys, 2)
        keys = halves[:, 0]
        sort_keys = _bits_rows(_key_rows(halves[:, 1], device), (n,))
        x = torch.gather(x, -1, torch.sort(sort_keys, dim=-1, stable=True).indices)
    return x


def permutation(k: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffled ``arange(n)``."""
    return permutation_many(k[None], n, device=device)[0]


# XLA's single-precision erf_inv: Giles's polynomials in w = -log1p(-x*x),
# one for w < 5 (in w - 2.5) and one beyond (in sqrt(w) - 3), highest
# coefficient first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log1p: Cephes' rational approximation for |x| < sqrt(2) - 1
# (numerator and denominator, highest coefficient first) and log(1 + x)
# beyond, where XLA's CPU log is Cephes' logf (polynomial, highest first).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32, rounded once (the float64 product of two
    float32 values is exact): the fused multiply-add XLA's CPU code emits."""
    f64 = torch.float64
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, c)
    return p


def _logf(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log`` on positive normal float32: v = 2**e * m with m in
    [sqrt(1/2), sqrt(2)), log(m) by Cephes' degree-9 polynomial in t = m - 1
    evaluated in three parts, and e * ln 2 added in two pieces."""
    f32 = torch.float32
    b = v.view(torch.int32)
    m = ((b & ~0x7F800000) | 0x3F000000).view(f32)  # v's mantissa in [0.5, 1)
    e = 1.0 + ((b >> 23) - 127).to(f32)
    low = m < 0.707106781186547524
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(f32)
    t2 = t * t
    t3 = t2 * t
    p = _LOGF_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, t3, y1), t3, y2)
    y = _fma(y, t3, e * -2.12194440e-4)
    t = (t - 0.5 * t2) + y
    return t + e * 0.693359375


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` for x in (-1, 0] (erf_inv's argument)."""
    x2 = x * x
    small = x + _fma(-0.5, x2, (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)))
    big = _logf(torch.clamp(1.0 + x, min=torch.finfo(torch.float32).tiny))
    return torch.where(x.abs() < 0.41421356237309504880, small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` on float32 as XLA computes it on the CPU: Giles's
    polynomial in ``w = -log1p(-x*x)``, with XLA's ``log1p`` and each Horner
    step a fused multiply-add.  At +-1 the result is +-``finfo.max``, as
    XLA's.  ``torch.erfinv`` is another approximation, up to 64 ulp away."""
    f32 = torch.float32
    x = x.to(f32)
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(a, dtype=f32), torch.tensor(b, dtype=f32)).to(x.device)
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * torch.finfo(f32).max, p * x)


def normal(k: torch.Tensor, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) * erf_inv(u)``
    for u uniform in ``(nextafter(-1, 0), 1)``.  Within 2 ulp of the
    reference, and fewer than one draw in ten thousand differs at all:
    there XLA's compiler contracts or orders a step of its ``log`` otherwise
    than :func:`_logf` does.  Every other draw of this module is bit for
    bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, device=device)
    return torch.full((), np.sqrt(2.0), dtype=torch.float32, device=u.device) * erf_inv(u)
