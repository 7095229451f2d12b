"""Ambient mesh context for activation sharding constraints: the twin of
``repro.distributed.context``.

The 2-D FSDP x TP weight sharding gives the intended program only if
activations are pinned to batch sharding at layer boundaries; otherwise the
embedding's "data" axis lands on the feature dim and the batch is
replicated.  Model code calls ``constrain(x, ...)`` with LOGICAL axes;
without a mesh, or on a plain tensor, it returns ``x`` itself, so
single-device runs are unaffected.

Logical axes: "batch" -> ("pod", "data") (as present), "model" -> "model".

Under :func:`activation_mesh` of a ``DeviceMesh``, plain tensors that meet a
``DTensor`` (positions, masks, constants the model makes as it goes) count
as replicated (``DTensor``'s implicit replication).

The rest of the model's mesh code lives here too, each piece the identity
on plain tensors: :func:`fsdp_gathered` (a group's weights gathered over
the data axes for its span), :func:`split_heads`, :func:`merge_heads`, and
the local maps for
what ``DTensor`` has no rule for on every torch the port runs on, each
running the plain computation on a rank's own rows (and heads) and stating
its gradient's placements: :func:`on_local_heads` (attention),
:func:`lookup_rows` (the embedding), :func:`write_rows` (cache writes),
:func:`on_local_rows` (the MoE's routing and dispatch, Mamba2's scan) and
:func:`mixer_on_local_rows` (the xLSTM cells).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

from repro_torch.distributed import sharding as shd

_MESH: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None
)


@contextlib.contextmanager
def activation_mesh(mesh):
    token = _MESH.set(mesh)
    try:
        if hasattr(mesh, "mesh_dim_names"):  # a DeviceMesh
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def spec_for(shape, mesh, *axes) -> tuple:
    """The spec of logical ``axes`` ("batch", "model", None or a mesh axis
    name, one a dim) for a tensor of ``shape``; an axis whose size does not
    divide its dim is dropped."""
    sizes = shd.axis_sizes(mesh)
    dp = shd.dp_axes(mesh)
    spec = []
    for dim, a in enumerate(axes):
        if a is None:
            spec.append(None)
            continue
        names = dp if a == "batch" else ("model",) if a == "model" else (a,)
        if shape[dim] % math.prod(sizes[n] for n in names) != 0:
            spec.append(None)
        else:
            spec.append(names if len(names) > 1 else names[0])
    return tuple(spec)


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward places the gradient as ``placements``:
    a constraint holds for the cotangent too, as JAX's sharding constraint
    does (``DTensor``'s backward ops otherwise pick layouts its forward
    rules cannot take back)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a rank's
    local gradient goes back into a ``DTensor`` whose views need it dense."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(t, grad_placements):
    """A ``DTensor``'s local tensor, its gradient placed as
    ``grad_placements`` and kept dense."""
    t = t.to_local(grad_placements=grad_placements)
    return _DenseGrad.apply(t) if t.requires_grad and torch.is_grad_enabled() else t


def constrain(x, *axes):
    """Redistribute a ``DTensor`` to the placements of logical ``axes``
    (entries "batch", "model", None), and its gradient too; the identity
    without a mesh or on a plain tensor."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = shd.NamedSharding(mesh, spec_for(x.shape, mesh, *axes)).placements()
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradPlaced.apply(x, want)
    return x


def split_heads(x, heads: int, hd: int):
    """x (B, S, heads * hd) -> (B, S, heads, hd), constrained to ("batch",
    None, "model", None).  A ``DTensor`` is placed first as that view needs
    it: its feature dim stays split over "model" only where ``heads``
    divides (a split of the flat features is then a split of the heads),
    else it is gathered, as the reference's partitioner regathers it."""
    b, s = x.shape[:2]
    mesh = _MESH.get()
    if mesh is not None and hasattr(x, "placements"):
        spec = spec_for((b, s, heads, hd), mesh, "batch", None, "model", None)
        flat = shd.NamedSharding(mesh, spec[:2] + (spec[2],)).placements()
        if list(x.placements) != flat:
            x = x.redistribute(mesh, flat)
    return constrain(x.reshape(b, s, heads, hd), "batch", None, "model", None)


def merge_heads(x):
    """x (B, S, heads, hd) -> (B, S, heads * hd).  Over a mesh the
    gradient comes back placed as the output is: the reshape's backward
    splits the flat features into heads, which a split over "model" allows
    only where the heads divide it."""
    b, s = x.shape[:2]
    y = x.reshape(b, s, -1)
    if hasattr(y, "placements") and y.requires_grad and torch.is_grad_enabled():
        y = _GradPlaced.apply(y, list(y.placements))
    return y


def on_local_heads(fn, q, k, v, *rowwise):
    """``fn(q, k, v, *rowwise)``, an attention over (B, S, heads, hd)
    blocks, run on each rank's own rows and heads when ``q`` is a
    ``DTensor`` (``DTensor`` has no rule for the GQA repeat and the score
    products over heads on "model"; this is their ``local_map``).

    k and v are placed as q's rows and, where q's heads split over a mesh
    dim, split the same way if their heads divide it, else replicated there:
    each rank then picks the key/value heads its query heads read, and that
    dim's gradient of k and v is a partial sum.  ``rowwise`` tensors
    (positions, masks: batch first) are cut to the rank's rows.  Plain
    tensors go straight to ``fn``."""
    if not hasattr(q, "placements"):
        return fn(q, k, v, *rowwise)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    want, grad = [], []
    for i, p in enumerate(q.placements):
        if p == Shard(0):
            want.append(Shard(0))
            grad.append(Shard(0))
        elif p == Shard(2) and kv % mesh.size(i) == 0:
            want.append(Shard(2))
            grad.append(Shard(2))
        else:
            want.append(Replicate())
            grad.append(Partial() if p == Shard(2) else Replicate())
    k, v = (t.redistribute(mesh, want) if list(t.placements) != want else t for t in (k, v))
    shape, offset = shd.local_block(q.shape, mesh, q.placements)
    q_l = _local(q, q.placements)
    k_l, v_l = (_local(t, grad) for t in (k, v))
    if k_l.shape[2] == kv and shape[2] < h:  # replicated kv heads: this rank's share
        rep = h // kv
        idx = torch.arange(offset[2], offset[2] + shape[2], device=q_l.device) // rep
        if shape[2] % rep == 0:
            idx = idx[::rep]
        k_l, v_l = k_l.index_select(2, idx), v_l.index_select(2, idx)
    rows = slice(offset[0], offset[0] + shape[0])
    local = []
    for t in rowwise:
        if hasattr(t, "placements"):
            t = t.full_tensor()
        local.append(t[rows])
    out = fn(q_l, k_l, v_l, *local)
    gshape = tuple(q.shape[:3]) + (out.shape[-1],)
    stride = torch.empty(gshape, device="meta").stride()
    return DTensor.from_local(out.contiguous(), mesh, q.placements, run_check=False, shape=gshape,
                              stride=stride)


@contextlib.contextmanager
def fsdp_gathered(module, recurse: bool = True):
    """Inside the block, each ``DTensor`` parameter of ``module`` (of its
    own parameters only, without ``recurse``) reads as its value gathered
    over the (pod, data) axes: the FSDP factor restored just in time, the
    "model" (TP) factor kept.  The gather is differentiable, so gradients
    reach the sharded parameters (as a reduce-scatter).  Without a mesh, or
    on plain parameters, nothing changes."""
    mesh = _MESH.get()
    if mesh is None or module is None:
        yield
        return
    from torch.distributed.tensor import DTensor, Replicate

    dp = set(shd.dp_axes(mesh))
    names = shd.axis_names(mesh)
    swapped = []
    mods = module.modules() if recurse else [module]
    for mod in mods:
        for name, p in list(mod._parameters.items()):
            if not isinstance(p, DTensor):
                continue
            want = [Replicate() if ax in dp else pl for ax, pl in zip(names, p.placements)]
            if want != list(p.placements):
                swapped.append((mod, name, p))
                mod._parameters[name] = p.redistribute(mesh, want)
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def lookup_rows(table, ids):
    """``table[ids]``, an embedding lookup.  On a ``DTensor`` table each
    rank gathers the whole table and looks up its own ids' rows (``DTensor``
    has no rule for the gather's backward on every torch it runs on): the
    rows come out placed as the ids' batch, and the table's gradient is a
    partial sum over the mesh dims that split the ids."""
    if not hasattr(table, "placements"):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    full = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    if not hasattr(ids, "placements"):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = ids.redistribute(mesh, [Shard(0) if p == Shard(0) else Replicate()
                                  for p in ids.placements])
    grad = [Partial() if p == Shard(0) else Replicate() for p in ids.placements]
    rows = full.to_local(grad_placements=grad)[ids.to_local()]
    shape = tuple(ids.shape) + (table.shape[-1],)
    return DTensor.from_local(rows, mesh, ids.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def write_rows(dst, dim: int, index, src):
    """Write ``src``'s rows along ``dim`` into ``dst`` at ``index``, in
    place, and return ``dst``: ``index`` is a ``slice`` (``dst[..., a:b]
    = src``) or an int64 tensor of distinct rows (``index_copy_``).

    On a ``DTensor`` ``dst`` each rank writes its own block (``DTensor``
    has no rule for ``index_copy_`` on every torch it runs on): ``src`` is
    placed as ``dst`` but whole along ``dim``, then a slice writes the
    rows its block holds; a tensor index either names one row (the ranks
    whose block lacks it write the old row back: no host sync) or is a
    permutation of every row (each rank gathers its block's rows)."""
    if not hasattr(dst, "placements"):
        if isinstance(index, slice):
            dst[(slice(None),) * dim + (index,)] = src
            return dst
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = dst.device_mesh
    want = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    if not hasattr(src, "placements"):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, want).to_local().to(dst.dtype)
    local, offset = shd.local_block(dst.shape, mesh, dst.placements)
    lo, n = offset[dim], local[dim]
    dst_l = dst.to_local()
    if isinstance(index, slice):
        start, stop, _ = index.indices(dst.shape[dim])
        a, b = max(start, lo), min(stop, lo + n)
        if a < b:
            dst_l.narrow(dim, a - lo, b - a).copy_(src.narrow(dim, a - start, b - a))
        return dst
    index = index.full_tensor() if hasattr(index, "placements") else index
    if index.numel() == dst.shape[dim]:  # a permutation: gather this block's rows
        dst_l.copy_(src.index_select(dim, torch.argsort(index)[lo:lo + n]))
        return dst
    if index.numel() != 1:
        raise NotImplementedError("a sharded write of several rows that are not all of them")
    at = index - lo
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    shape = [1] * src.dim()
    shape[dim] = -1
    dst_l.index_copy_(dim, at, torch.where(inside.reshape(shape), src, dst_l.index_select(dim, at)))
    return dst


def on_local_rows(fn, *args, weights=()):
    """``fn(*args, *weights)`` for a computation that treats each batch row
    on its own (a row's outputs read only that row's inputs and the
    weights), run on each rank's rows when the first argument is a
    ``DTensor`` (the MoE's routing, scatter dispatch and gather back, which
    ``DTensor`` has no rule for).

    Every ``DTensor`` argument is placed as the rows: split where the first
    argument's batch is, whole elsewhere (a partial sum is reduced first);
    the outputs (a tensor or a tuple of them) take those placements, and so
    does each argument's gradient (the ranks that share rows compute the
    same values).  Each weight is gathered whole, and its gradient is a
    partial sum over the mesh dims that split the rows.  Plain tensors go
    straight to ``fn``."""
    first = args[0]
    if not hasattr(first, "placements"):
        return fn(*args, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = first.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in first.placements]
    local = []
    for a in args:
        if hasattr(a, "placements"):
            if list(a.placements) != rows:
                a = a.redistribute(mesh, rows)
            a = _local(a, rows)
        local.append(a)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p == Shard(0) else Replicate() for p in rows]
    for w in weights:
        local.append(_local(w.redistribute(mesh, whole), grad)
                     if hasattr(w, "placements") else w)
    out = fn(*local)
    b = first.shape[0]

    def wrap(t):
        shape = (b,) + tuple(t.shape[1:])
        return DTensor.from_local(t.contiguous(), mesh, rows, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def mixer_on_local_rows(apply_fn, module, cfg, x, *, mode, cache):
    """``apply_fn(module, cfg, x, mode=, cache=)`` -> (y, new cache), a
    recurrent mixer (the xLSTM cells: their gates and recurrences have no
    ``DTensor`` rules), run on each rank's rows when ``x`` is a ``DTensor``,
    with the module's weights gathered whole (:func:`on_local_rows`) and
    read as plain tensors.  The cache's leaves go in as rows and the new
    state comes back into the cache, written in place."""
    if not hasattr(x, "placements"):
        return apply_fn(module, cfg, x, mode=mode, cache=cache)
    params = [(mod, name, p) for mod in module.modules()
              for name, p in mod._parameters.items() if hasattr(p, "placements")]
    names = sorted(cache) if cache is not None else []

    def local(x_l, *rest):
        leaves, weights = rest[:len(names)], rest[len(names):]
        saved = [(mod, name, mod._parameters[name]) for mod, name, _ in params]
        for (mod, name, _), w in zip(params, weights):
            mod._parameters[name] = w
        try:
            y, new = apply_fn(module, cfg, x_l, mode=mode,
                              cache=dict(zip(names, leaves)) if cache is not None else None)
        finally:
            for mod, name, p in saved:
                mod._parameters[name] = p
        return (y,) + tuple(new[n] for n in names) if new is not None else y

    out = on_local_rows(local, x, *(cache[n] for n in names),
                        weights=[p for _, _, p in params])
    if not isinstance(out, tuple):
        return out, None
    for n, leaf in zip(names, out[1:]):
        cache[n].copy_(leaf)
    return out[0], cache
