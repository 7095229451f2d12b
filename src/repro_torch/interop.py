"""State carried across from the JAX reference.

What crosses: PRNG keys, as the raw ``(2,)`` uint32 words of
``jax.random.key_data(key)``; problem instances (``EsProblem``'s mu, beta,
m, lam and ``IsingProblem``'s h, J) as numpy arrays; a backbone's
weights (any model family), the reference's ``init_params`` tree as
nested dicts of numpy arrays; a prefill / decode cache, the reference's
``init_cache`` tree (after any prefill or decode steps), likewise; a
serving ``CalibrationProfile`` as its JSON text; and serving
``SelectionRequest``s as ``dataclasses.asdict`` dicts.
:func:`carry_across` turns them into the port's objects, so a test can hand
the same state to both packages.  Nothing here imports JAX: the caller
converts to numpy, text or dicts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem, IsingProblem
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache, model_from_tree


def carry_across(kind: str, *arrays, device=None, **fields):
    """The port's object for reference state given as numpy arrays:

      * ``carry_across("key", words)`` -> a ``(2,)`` int64 key tensor;
      * ``carry_across("es", mu, beta, m=..., lam=...)`` -> :class:`EsProblem`;
      * ``carry_across("ising", h, j)`` -> :class:`IsingProblem`;
      * ``carry_across("params", tree, cfg=...)`` -> the port's
        ``models.Model`` (one module per index of each stacked axis; each
        leaf cast to its parameter's type);
      * ``carry_across("cache", tree, cfg=..., dtype=None)`` -> the port's
        cache tree (the same nesting and stacked axes; each leaf in the
        type ``models.init_cache(cfg, ..., dtype)`` gives it, so bf16
        leaves may arrive as float32 arrays);
      * ``carry_across("profile", json_text)`` -> the port's
        ``serving.CalibrationProfile`` (the reference's ``to_json()``);
      * ``carry_across("requests", dicts)`` -> a list of the port's
        ``serving.SelectionRequest`` (each the reference request's
        ``dataclasses.asdict``, its ``kofn`` a nested dict).

    Keys live on the CPU, like every key of the port, and so do profiles
    and requests (plain data); problems, models and caches go to ``device``
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
    if kind == "cache":
        (tree,) = arrays
        return _cache_from_tree(fields["cfg"], tree, fields.get("dtype"), device)
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
                     "'cache', 'profile' or 'requests'")


def _cache_from_tree(cfg, tree: dict, dtype, device) -> dict:
    """The reference's cache tree as the port's: each leaf takes the type of
    its twin in ``init_cache`` (built on the meta device: no storage), and
    the trees must nest alike."""
    template = init_cache(cfg, 1, 1, dtype, device="meta")

    def walk(node, like, path):
        if isinstance(like, dict):
            if not isinstance(node, dict) or set(node) != set(like):
                raise ValueError(f"cache tree at {path or 'the root'}: keys "
                                 f"{sorted(node) if isinstance(node, dict) else node!r} "
                                 f"!= {sorted(like)}")
            return {k: walk(node[k], like[k], f"{path}.{k}".lstrip(".")) for k in like}
        leaf = torch.from_numpy(np.array(np.asarray(node)))
        return leaf.to(device=device, dtype=like.dtype)

    return walk(tree, template, "")
