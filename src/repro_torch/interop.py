"""State carried across from the JAX reference.

This system has no weights; what crosses is state: PRNG keys, as the raw
``(2,)`` uint32 words of ``jax.random.key_data(key)``, and problem instances
(``EsProblem``'s mu, beta, m, lam and ``IsingProblem``'s h, J) as numpy
arrays.  :func:`carry_across` turns them into the port's objects, so a test
can hand the same state to both packages.  Nothing here imports JAX: the
caller converts to numpy on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem, IsingProblem
from repro_torch.device import resolve_device


def carry_across(kind: str, *arrays, device=None, **fields):
    """The port's object for reference state given as numpy arrays:

      * ``carry_across("key", words)`` -> a ``(2,)`` int64 key tensor;
      * ``carry_across("es", mu, beta, m=..., lam=...)`` -> :class:`EsProblem`;
      * ``carry_across("ising", h, j)`` -> :class:`IsingProblem`.

    Keys live on the CPU, like every key of the port; problems go to
    ``device`` (``None``: the card; raises without one).
    """
    if kind == "key":
        (words,) = arrays
        words = np.asarray(words)
        if words.shape != (2,):
            raise ValueError(f"a key is two uint32 words, got shape {words.shape}")
        return torch.tensor(words.astype(np.uint32).astype(np.int64))
    device = resolve_device(device)
    tensors = [
        torch.tensor(np.asarray(a, np.float32), device=device) for a in arrays
    ]
    if kind == "es":
        mu, beta = tensors
        return EsProblem(mu=mu, beta=beta, m=int(fields["m"]), lam=float(fields["lam"]))
    if kind == "ising":
        h, j = tensors
        return IsingProblem(h=h, j=j)
    raise ValueError(f"unknown state kind {kind!r}; want 'key', 'es' or 'ising'")
