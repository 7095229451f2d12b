"""State carried across from the JAX reference.

What crosses: PRNG keys, as the raw ``(2,)`` uint32 words of
``jax.random.key_data(key)``; problem instances (``EsProblem``'s mu, beta,
m, lam and ``IsingProblem``'s h, J) as numpy arrays; a backbone's
weights (any model family), the reference's ``init_params`` tree as
nested dicts of numpy arrays; a serving ``CalibrationProfile`` as its
JSON text; and serving ``SelectionRequest``s as ``dataclasses.asdict``
dicts.
:func:`carry_across` turns them into the port's objects, so a test can hand
the same state to both packages.  Nothing here imports JAX: the caller
converts to numpy, text or dicts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem, IsingProblem
from repro_torch.device import resolve_device
from repro_torch.models.model import model_from_tree


def carry_across(kind: str, *arrays, device=None, **fields):
    """The port's object for reference state given as numpy arrays:

      * ``carry_across("key", words)`` -> a ``(2,)`` int64 key tensor;
      * ``carry_across("es", mu, beta, m=..., lam=...)`` -> :class:`EsProblem`;
      * ``carry_across("ising", h, j)`` -> :class:`IsingProblem`;
      * ``carry_across("params", tree, cfg=...)`` -> the port's
        ``models.Model`` (one module per index of each stacked axis; each
        leaf cast to its parameter's type);
      * ``carry_across("profile", json_text)`` -> the port's
        ``serving.CalibrationProfile`` (the reference's ``to_json()``);
      * ``carry_across("requests", dicts)`` -> a list of the port's
        ``serving.SelectionRequest`` (each the reference request's
        ``dataclasses.asdict``, its ``kofn`` a nested dict).

    Keys live on the CPU, like every key of the port, and so do profiles
    and requests (plain data); problems and models go to ``device``
    (``None``: the card; raises without one).
    """
    if kind == "key":
        (words,) = arrays
        words = np.asarray(words)
        if words.shape != (2,):
            raise ValueError(f"a key is two uint32 words, got shape {words.shape}")
        return torch.tensor(words.astype(np.uint32).astype(np.int64))
    if kind == "profile":
        from repro_torch.serving.calibration import CalibrationProfile

        (text,) = arrays
        return CalibrationProfile.from_json(text)
    if kind == "requests":
        from repro_torch.serving.api import KofnSpec, SelectionRequest

        (dicts,) = arrays
        return [SelectionRequest(**{**d, "kofn": KofnSpec(**d["kofn"])}) for d in dicts]
    device = resolve_device(device)
    if kind == "params":
        (tree,) = arrays
        return model_from_tree(fields["cfg"], tree, device)
    tensors = [
        torch.tensor(np.asarray(a, np.float32), device=device) for a in arrays
    ]
    if kind == "es":
        mu, beta = tensors
        return EsProblem(mu=mu, beta=beta, m=int(fields["m"]), lam=float(fields["lam"]))
    if kind == "ising":
        h, j = tensors
        return IsingProblem(h=h, j=j)
    raise ValueError(f"unknown state kind {kind!r}; want 'key', 'es', 'ising', 'params', "
                     "'profile' or 'requests'")
