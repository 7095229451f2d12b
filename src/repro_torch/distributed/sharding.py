"""Sharding rules: the twin of ``repro.distributed.sharding`` on
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``.

2-D FSDP x TP weight sharding plus pod/data batch sharding.  Weights:
(in_dim, out_dim) matmuls shard ("data", "model") (column-parallel) or
("model", "data") (row-parallel: wo / w_out / out_proj), so the "data"
factor is gathered just in time inside a layer while the "model" factor
stays resident (Megatron-style TP).  Dims that do not divide their axes
are replicated (``_pad_spec``'s divisibility guard).

A spec is a tuple with one entry a tensor dim: ``None``, a mesh axis name,
or a tuple of names, so it compares equal to ``tuple(PartitionSpec)``.
:class:`NamedSharding` pairs it with a mesh, and gives the ``DTensor``
placements (``Shard(d)`` on every mesh dim that splits tensor dim d) and
the per-rank shape.

The port keeps stacked layers as lists of per-layer tensors
(``models.param_tree``).  The rules are applied to a leaf's stacked shape,
as the reference applies them to its stacked arrays; the stacked leading
axes, always replicated, are then dropped, so each per-layer tensor gets the
reference's spec without them.  Cache leaves keep their stacked axes
(``models.init_cache``), so their specs are the reference's as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import (
    leaf_parts,
    map_parts,
    stacked_shape,
    tree_items,
    tree_unflatten,
)

PyTree = Any

# Base spec per trailing param name (padded with None on the left per-rank).
_COL = ("data", "model")  # column-parallel: out-dim TP
_ROW = ("model", "data")  # row-parallel: in-dim TP
PARAM_RULES = {
    "wq": _COL, "wk": _COL, "wv": _COL,
    "wo": _ROW,
    "w_in": _COL, "w_gate": _COL,
    "w_out": _ROW,
    "in_proj": _COL, "out_proj": _ROW,
    "ffn_in": _COL, "ffn_out": _ROW,
    "w_gates": ("data", None),
    "router": ("data", None),
    "shared_gate": ("data", None),
    "embed": ("model", "data"),
    "unembed": ("data", "model"),
    "conv_w": (None, "model"),
    "r": (None, None, "model"),  # slstm recurrent (nh, dh, 4dh)
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "bias": ("model",),
    # replicated small leaves:
    "scale": (), "gate": (), "ffn_gate": (), "a_log": (), "d_skip": (),
    "dt_bias": (), "gate_bias": (),
}

# KV cache layout: "heads" shards kv-heads over model (classic TP) but
# replicates the cache when n_kv_heads < model axis; "seq" shards the cache
# sequence dim over model instead (context-parallel attention).  "auto"
# picks per config.
KV_CACHE_LAYOUT = "auto"

# Cache leaves (by name) -- batch on data axes, heads/features on model.
CACHE_RULES = {
    "k": ("batch", None, "model", None),
    "v": ("batch", None, "model", None),
    "k_seq": ("batch", "model", None, None),
    "v_seq": ("batch", "model", None, None),
    "pos": (),
    "conv": ("batch", None, "model"),
    "state": ("batch", "model", None, None),  # mamba (B,H,N,P) / mlstm heads
    "c": ("batch", "model"), "n": ("batch", "model"),
    "h": ("batch", "model"), "m": ("batch", "model"),
    "memory": ("batch", None, None),
}


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with
    ``axis_names`` and a ``shape`` tuple, as ``launch.mesh.HostMesh``)."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: JAX's ``NamedSharding`` for ``DTensor``."""

    mesh: Any
    spec: tuple

    def placements(self) -> list:
        """One ``DTensor`` placement a mesh dim: ``Shard(d)`` where the
        spec puts that axis on tensor dim d (a dim over ("pod", "data") is
        ``Shard(d)`` on both), else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        where = {ax: d for d, entry in enumerate(self.spec) for ax in _axes(entry)}
        return [Shard(where[ax]) if ax in where else Replicate()
                for ax in axis_names(self.mesh)]

    def local_shape(self, shape) -> tuple:
        """A rank's shape of a tensor of global ``shape`` (the rules only
        shard dims their axes divide)."""
        sizes = axis_sizes(self.mesh)
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        return tuple(n // math.prod(sizes[a] for a in _axes(entry))
                     for n, entry in zip(shape, spec))

    def distribute(self, t: torch.Tensor):
        """``t`` (the global value, the same on every rank) as a ``DTensor``
        of these placements: each rank keeps its own block, with no
        communication."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements())
        return distribute_tensor(t, self.mesh, self.placements(), src_data_rank=None)


def axes_entry(axes: tuple):
    """A spec entry of mesh axes: one axis as its name (``PartitionSpec``
    writes ("data",) as "data")."""
    return axes[0] if len(axes) == 1 else axes


def local_block(shape, mesh, placements) -> tuple[list, list]:
    """(this rank's shape, its offset in the global tensor) of a tensor of
    ``shape`` under ``Shard`` / ``Replicate`` placements that divide
    evenly, from the rank's mesh coordinates (no tensor op, so it runs
    under a fake tensor mode)."""
    local, offset = list(shape), [0] * len(shape)
    coords = mesh.get_coordinate()
    for i, p in enumerate(placements):
        d = getattr(p, "dim", None)
        if d is None:
            continue
        local[d] //= mesh.size(i)
        offset[d] += coords[i] * local[d]
    return local, offset


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _pad_spec(base, rank: int, mesh, batch_axes, shape=None) -> tuple:
    base = tuple(axes_entry(batch_axes) if a == "batch" else a for a in base)
    pad = rank - len(base)
    assert pad >= 0, (base, rank)
    spec = list((None,) * pad + base)
    if shape is not None:
        # Shardings must divide exactly; drop axes that don't (e.g. 4 mLSTM
        # heads over model=16 -> replicate that dim).
        sizes = axis_sizes(mesh)
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            if shape[i] % math.prod(sizes[a] for a in _axes(ax)) != 0:
                spec[i] = None
    return tuple(spec)


def _as_tree(params):
    from repro_torch.models.model import param_tree

    return param_tree(params) if isinstance(params, torch.nn.Module) else params


def _map_leaves(fn, tree):
    """``fn(path, leaf)`` on every leaf of a tree (a list of per-layer
    tensors is one leaf), keeping the structure."""
    items = tree_items(tree)
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in items])


def _per_part(mesh, spec: tuple, leaf):
    """A stacked leaf's spec as each of its tensors' spec (the stacked
    leading axes, always replicated, dropped)."""
    lead = len(stacked_shape(leaf)) - leaf_parts(leaf)[0].dim()
    assert all(a is None for a in spec[:lead]), spec
    sh = NamedSharding(mesh, spec[lead:])
    return map_parts(lambda _: sh, leaf)


def param_sharding(params: PyTree, mesh, *, serve: bool = False) -> PyTree:
    """A :class:`NamedSharding` for each tensor of a parameter (or
    optimizer-state) tree or a model, in the tree's structure.

    serve=True drops the FSDP ("data") factor from weights: at inference
    there is no optimizer state, so TP-only weights fit and the per-layer
    weight all-gathers disappear from the decode step.
    """
    batch = dp_axes(mesh)

    def spec(path, leaf):
        base = PARAM_RULES.get(path[-1] if path else None)
        if base is None:
            base = ()  # unknown -> replicated (safe default)
        if serve:
            base = tuple(None if a == "data" else a for a in base)
        shape = stacked_shape(leaf)
        if len(base) > len(shape):
            base = base[-len(shape):] if shape else ()
        return _per_part(mesh, _pad_spec(base, len(shape), mesh, batch, shape=shape), leaf)

    return _map_leaves(spec, _as_tree(params))


def cache_sharding(cache: PyTree, mesh, *, n_kv_heads: int = 0) -> PyTree:
    batch = dp_axes(mesh)
    model = axis_sizes(mesh).get("model", 1)
    seq_layout = KV_CACHE_LAYOUT == "seq" or (
        KV_CACHE_LAYOUT == "auto" and n_kv_heads and n_kv_heads % model != 0
    )

    def spec(path, leaf):
        name = path[-1] if path else None
        if seq_layout and name in ("k", "v"):
            name = name + "_seq"
        base = CACHE_RULES.get(name, ())
        if name == "state" and "mlstm" in path:
            # mLSTM matrix memory (B, NH, DK, DV): NH=4 won't divide model=16;
            # shard the key dim instead (column-parallel wq/wk match).
            base = ("batch", None, "model", None)
        # Cache leaves are stacked (groups, [inner], *base) -- pad left.
        shape = tuple(leaf.shape)
        if len(base) > len(shape):
            base = base[-len(shape):] if shape else ()
        return NamedSharding(mesh, _pad_spec(base, len(shape), mesh, batch, shape=shape))

    return _map_leaves(spec, cache)


def batch_sharding(mesh, rank: int = 2) -> NamedSharding:
    """Token batches: (B, S, ...) shard B over (pod, data)."""
    return NamedSharding(mesh, (axes_entry(dp_axes(mesh)),) + (None,) * (rank - 1))


def opt_state_sharding(opt_state: PyTree, params_sharding: PyTree, mesh) -> PyTree:
    """Optimizer state shardings.

    master/mu/nu mirror the param shardings, but on a multi-pod mesh the
    "data" factor widens to ("pod", "data") -- ZeRO-style: optimizer state
    is only touched once per step, so sharding it across pure-DP replicas
    costs one cross-pod gather per step and halves its memory per pod added.
    """
    if "pod" in axis_names(mesh):
        sizes = axis_sizes(mesh)
        wide = sizes["pod"] * sizes["data"]

        def widen(ns, part):
            return NamedSharding(mesh, tuple(
                ("pod", "data") if ax == "data" and part.shape[dim] % wide == 0 else ax
                for dim, ax in enumerate(ns.spec)))

        state_sh = tree_unflatten(params_sharding, [
            map_parts(lambda pair: widen(*pair), zip_parts(sh, leaf))
            for (_, sh), (_, leaf) in zip(tree_items(params_sharding),
                                          tree_items(opt_state["master"]))])
    else:
        state_sh = params_sharding
    return {
        "step": NamedSharding(mesh, ()),
        "master": state_sh,
        "mu": state_sh,
        "nu": state_sh,
    }


def zip_parts(a, b):
    """Two leaves of one list nesting as one leaf of pairs."""
    if isinstance(a, list):
        return [zip_parts(x, y) for x, y in zip(a, b)]
    return (a, b)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def distribute_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """Each tensor of ``tree`` as the ``DTensor`` its sharding gives (a new
    tree; the tensors are the global values, the same on every rank)."""
    return tree_unflatten(tree, [
        map_parts(lambda pair: pair[1].distribute(pair[0]), zip_parts(leaf, sh))
        for (_, leaf), (_, sh) in zip(tree_items(tree), tree_items(shardings))])
