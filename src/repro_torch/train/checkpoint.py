"""Fault-tolerant checkpointing: atomic, in the reference's format.

The twin of ``repro.train.checkpoint``, and its files are the reference's:
``arrays.npz`` with one array ``a{i}`` a leaf (bf16 stored as its uint16
bits) and ``manifest.json`` with ``step``, ``names`` (each leaf's tree path,
as ``jax.tree_util.tree_flatten_with_path`` prints it), ``dtypes``,
``config_hash`` and ``format: 1``.  A tree is saved in the reference's
structure: a model (``models.param_tree``) or a state tree stacks its
per-layer tensors into the reference's stacked leaves on save, and restore
splits them again, so a checkpoint crosses between the two packages both
ways.  Writes go to a temp dir renamed into place, so a preempted writer
never corrupts the latest checkpoint; ``keep`` prunes the oldest.

Restore loads the arrays as global values and places them on one device
(the card unless given one), or, given ``shardings`` built from a new mesh
(``distributed.sharding``), as ``DTensor``s of that mesh: the reference's
elastic restore.  A ``DTensor`` leaf is saved as its global value.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import leaf_parts, tree_items, tree_unflatten
from repro_torch.models.model import param_tree


def config_hash(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _modules_as_trees(tree):
    if isinstance(tree, torch.nn.Module):
        return param_tree(tree)
    if isinstance(tree, dict):
        return {k: _modules_as_trees(v) for k, v in tree.items()}
    return tree


def _flatten_with_names(tree):
    tree = _modules_as_trees(tree)
    items = tree_items(tree)
    names = ["/".join(f"[{k!r}]" for k in path) for path, _ in items]
    return names, [leaf for _, leaf in items], tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array the reference saves and its logical dtype: a
    list of per-layer tensors stacked, bf16 as its uint16 bits."""
    if isinstance(leaf, list):
        arrays, dtypes = zip(*(_to_numpy(part) for part in leaf))
        return np.stack(arrays), dtypes[0]
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):  # a DTensor: its global value
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(ckpt_dir: str | Path, step: int, tree, *, cfg=None, keep: int = 3) -> Path:
    """Atomically write checkpoint ``step``; prune to the newest ``keep``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    names, leaves, _ = _flatten_with_names(tree)
    arrays = {}
    logical_dtypes = []
    for i, leaf in enumerate(leaves):
        arrays[f"a{i}"], logical = _to_numpy(leaf)
        logical_dtypes.append(logical)

    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "names": names,
            "dtypes": logical_dtypes,
            "config_hash": config_hash(cfg) if cfg is not None else None,
            "format": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    maybe_remove_old(ckpt_dir, keep=keep)
    return final


def steps_available(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and (p / "manifest.json").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = steps_available(ckpt_dir)
    return steps[-1] if steps else None


def _from_numpy(a: np.ndarray, logical: str, like, device):
    """The stored array as ``like``'s leaf: its type, split into its list
    of per-layer tensors where it is one, on ``device``."""
    if isinstance(like, list):
        if a.shape[0] != len(like):
            raise ValueError(f"a stacked leaf of {a.shape[0]} where the tree has {len(like)}")
        return [_from_numpy(a[i], logical, part, device) for i, part in enumerate(like)]
    a = np.asarray(a)  # an index into a stack of scalars is a numpy scalar
    if logical == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.view(np.dtype(logical)))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for {tuple(like.shape)}")
    return t.to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str | Path, step: int, like, *, cfg=None, device=None,
            shardings=None):
    """Load checkpoint ``step`` into the structure of ``like`` (a tree of
    tensors, meta tensors welcome, and models), each leaf in its ``like``
    leaf's type, on ``device`` (``None``: the card, or with ``shardings``
    their mesh's device type; raises without one).  A model in ``like``
    comes back as its ``param_tree``: new tensors, the model itself
    untouched.  ``shardings`` (a tree of ``like``'s structure, as
    ``distributed.sharding.param_sharding`` gives it) places each leaf as
    the ``DTensor`` of its sharding: each rank keeps its own block."""
    if device is None and shardings is not None:
        device = leaf_parts(tree_items(shardings)[0][1])[0].mesh.device_type
    device = resolve_device(device)
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    if cfg is not None and manifest["config_hash"] not in (None, config_hash(cfg)):
        raise ValueError("checkpoint was written by a different model config")
    names, leaves, tree = _flatten_with_names(like)
    if names != manifest["names"]:
        raise ValueError("checkpoint tree structure mismatch")
    with np.load(path / "arrays.npz") as data:
        out = [_from_numpy(data[f"a{i}"], logical, leaf, device)
               for i, (leaf, logical) in enumerate(zip(leaves, manifest["dtypes"]))]
    restored = tree_unflatten(tree, out)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute_tree

        restored = distribute_tree(restored, shardings)
    return restored


def maybe_remove_old(ckpt_dir: str | Path, keep: int = 3) -> None:
    steps = steps_available(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)


def load_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a restored parameter tree into ``model``'s parameters in place."""
    with torch.no_grad():
        for (_, dst), (_, src) in zip(tree_items(param_tree(model)), tree_items(tree)):
            for d, s in zip(leaf_parts(dst), leaf_parts(src)):
                d.copy_(s)
    return model
