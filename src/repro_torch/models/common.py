"""Shared neural building blocks: twins of ``repro.models.common``.

Weights are held as the reference holds them, (in, out) for ``x @ w``; the
modules of ``models/`` are containers of parameters and the functions here
and in ``attention``, ``mlp`` and ``model`` apply them, as the reference's
pure functions apply its pytrees.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """Truncated-normal (+-2 sigma) fan-in init from ``gen``, drawn on the
    generator's device.  The reference's distribution, not its numbers:
    carry its weights across (``interop.carry_across("params", ...)``) where
    the numbers must agree."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in**-0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def param(gen: Optional[torch.Generator], shape, dtype, scale: Optional[float] = None,
          fill=None) -> torch.nn.Parameter:
    """A frozen parameter: ``fill`` everywhere if it is a number, or
    ``fill``'s values (a tensor of ``shape``); else ``dense_init`` from
    ``gen``, else uninitialised (for weights carried across).  Frozen
    (``requires_grad=False``) outside a train step, so inference builds no
    graph: ``launch.steps.make_train_step``'s step turns gradients on for
    its backward passes and off again, leaving no ``.grad`` behind."""
    device = gen.device if gen is not None else None
    if isinstance(fill, torch.Tensor):
        t = fill.to(dtype=dtype, device=device).reshape(shape)
    elif fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif gen is not None:
        t = dense_init(gen, shape, dtype, scale)
    else:
        t = torch.empty(shape, dtype=dtype)
    return torch.nn.Parameter(t, requires_grad=False)


class RMSNorm(torch.nn.Module):
    def __init__(self, dim: int, dtype, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = param(gen, (dim,), dtype, fill=1.0)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square norm in float32, back in ``x``'s type."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dtype)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
        "relu2": lambda x: torch.square(F.relu(x)),  # nemotron/minitron
        "tanh": torch.tanh,
    }[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute token positions."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Classic transformer absolute embeddings (whisper-style frontends)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    # The rate in float32, as the reference's -jnp.log(10000.0) / dim is.
    rate = -torch.log(torch.tensor(10000.0, device=device)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * rate)
    emb = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(pos * div)
    emb[:, 1::2] = torch.cos(pos * div)
    return emb.to(dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).  Returns (y, new_state):
    ``state`` (B, K - 1, C) is the left pad (zeros when None), and
    ``new_state`` the last K - 1 rows of the padded input, the next call's
    pad (zeros at K = 1)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:], dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y, new_state


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nested dict (a cache tree)."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, sub) for name, sub in tree.items()}
    return fn(tree)


def stack_tree(tree, n: int):
    """The tree with a new leading axis of n copies of each leaf (fresh
    storage), as the reference stacks ``[x] * n``."""
    return tree_map(lambda x: torch.stack([x] * n), tree)


def index_tree(tree, i: int):
    """The i-th entry of each leaf's leading axis: views, so that a layer
    writes its own slice of the stacked cache in place."""
    return None if tree is None else tree_map(lambda x: x[i], tree)


def write_cache(cache: Optional[dict], new: dict) -> dict:
    """Copy ``new``'s leaves into ``cache``'s in place and return ``cache``;
    with no cache, ``new`` itself."""
    if cache is None:
        return new
    for name, leaf in new.items():
        cache[name].copy_(leaf)
    return cache


# ---------------------------------------------------------------------------
# Parameter trees (``models.param_tree``): nested dicts whose leaves are
# tensors, or where the reference stacks a leaf, nested lists of the port's
# per-index tensors, one list level for each stacked axis.
# ---------------------------------------------------------------------------


def tree_items(tree, path=()) -> list:
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, as ``jax.tree.flatten`` orders them; a list is one leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_items(tree[k], path + (k,))]
    return [(path, tree)]


def tree_unflatten(like, leaves):
    """``like``'s dict structure holding ``leaves`` in :func:`tree_items`'
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def leaf_parts(leaf) -> list:
    """The tensors of a leaf, row-major over its stacked axes."""
    if isinstance(leaf, list):
        return [t for part in leaf for t in leaf_parts(part)]
    return [leaf]


def map_parts(fn, leaf):
    """``fn`` on each tensor of a leaf, keeping its list nesting."""
    if isinstance(leaf, list):
        return [map_parts(fn, part) for part in leaf]
    return fn(leaf)


def stacked_shape(leaf) -> tuple:
    """The reference's shape of a leaf: its stacked axes, then a part's."""
    if isinstance(leaf, list):
        return (len(leaf),) + stacked_shape(leaf[0])
    return tuple(leaf.shape)
