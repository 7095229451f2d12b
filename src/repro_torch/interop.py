"""State carried across from the JAX reference.

What crosses: PRNG keys, as the raw ``(2,)`` uint32 words of
``jax.random.key_data(key)``; problem instances (``EsProblem``'s mu, beta,
m, lam and ``IsingProblem``'s h, J) as numpy arrays; a backbone's
weights (any model family), the reference's ``init_params`` tree as
nested dicts of numpy arrays; its optimizer state (``train.optimizer.init``
and the steps after it), likewise; a prefill / decode cache, the
reference's ``init_cache`` tree (after any prefill or decode steps),
likewise; a
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
from repro_torch.models.common import tree_items, tree_unflatten
from repro_torch.models.model import Model, init_cache, model_from_tree, param_tree


def carry_across(kind: str, *arrays, device=None, **fields):
    """The port's object for reference state given as numpy arrays:

      * ``carry_across("key", words)`` -> a ``(2,)`` int64 key tensor;
      * ``carry_across("es", mu, beta, m=..., lam=...)`` -> :class:`EsProblem`;
      * ``carry_across("ising", h, j)`` -> :class:`IsingProblem`;
      * ``carry_across("params", tree, cfg=...)`` -> the port's
        ``models.Model`` (one module per index of each stacked axis; each
        leaf cast to its parameter's type);
      * ``carry_across("opt", tree, cfg=...)`` -> the port's optimizer
        state: ``step`` and the master, mu and nu trees split into the
        port's per-layer tensors (``models.param_tree``'s structure), each
        leaf in its array's type (a bfloat16 array as bf16);
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
    and requests (plain data); problems, models, states and caches go to ``device``
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
    if kind == "opt":
        (tree,) = arrays
        return _opt_from_tree(fields["cfg"], tree, device)
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
                     "'opt', 'cache', 'profile' or 'requests'")


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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _opt_from_tree(cfg, tree: dict, device) -> dict:
    """The reference's optimizer state as the port's: each stacked leaf of
    master, mu and nu split along its stacked axes as ``param_tree`` of a
    model of ``cfg`` (built on the meta device: no storage) nests it."""
    with torch.device("meta"):
        template = param_tree(Model(cfg))
    template_items = tree_items(template)

    def split(a, like):
        if isinstance(like, list):
            return [split(a[i], part) for i, part in enumerate(like)]
        if a.shape != tuple(like.shape):
            raise ValueError(f"optimizer leaf of shape {a.shape} for {tuple(like.shape)}")
        return _tensor(a, device)

    state = {"step": _tensor(np.asarray(tree["step"]).astype(np.int32), device)}
    for name in ("master", "mu", "nu"):
        items = tree_items(tree[name])
        if [p for p, _ in items] != [p for p, _ in template_items]:
            raise ValueError(f"optimizer {name} tree does not nest as {cfg.name}'s parameters")
        state[name] = tree_unflatten(template, [
            split(np.asarray(a), like) for (_, a), (_, like) in zip(items, template_items)])
    return state
