"""AdamW with float32 master weights, global-norm clipping, a cosine
schedule, and optional int8 stochastic-rounding gradient compression: the
twin of ``repro.train.optimizer``.

Trees are nested dicts of tensors, as ``models.param_tree`` gives a model's
parameters: where the reference stacks a leaf over layers, the port keeps a
list of per-layer tensors, and that list is one leaf here.  Every random
draw is the reference's: one key a leaf (``split(fold_in(key(17), step),
n_leaves)`` in the reference's flatten order), drawn over the leaf's stacked
shape, so the stochastic rounding and the compression match it bit for bit.

The update is in place: :func:`apply_updates` writes the new master weights,
moments and step into the state it is handed and the new weights into the
parameters, and returns both (a model's optimizer state is 14 bytes a
parameter; a second copy of it would be a step's peak).

The leaves may be ``DTensor``s of one placement each (a sharded train step:
``launch.steps.make_train_step`` over a ``DeviceMesh``): the grad norm is
then the global norm, and each shard's stochastic-rounding bits are the
ones its global elements draw unsharded (``prng.bits_at`` of their flat
indices), so a sharded bf16 state is the unsharded one's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.models.common import (
    leaf_parts,
    map_parts,
    stacked_shape,
    tree_items,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.model import param_tree

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 stochastic-rounding compression
    # bf16 optimizer state with stochastic rounding: 8 bytes a parameter
    # for master and moments where float32 takes 12; the rounding keeps the
    # tiny updates unbiased.
    state_dtype: str = "float32"  # "bfloat16" -> SR-rounded bf16 state


def _tree(params):
    return param_tree(params) if isinstance(params, torch.nn.Module) else params


def _round_sr(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 by adding the low 16 of ``bits`` (int64-held uint32
    draws) below the bf16 mantissa and truncating, in uint32 arithmetic."""
    raw = v.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK
    rounded = (raw + (bits & 0xFFFF)) & 0xFFFF0000
    signed = torch.where(rounded >= 2**31, rounded - 2**32, rounded).to(torch.int32)
    return signed.view(torch.float32).to(torch.bfloat16)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def _round_sr_any(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """:func:`_round_sr` of a tensor or, shard by shard, of a ``DTensor``
    (the rounding is elementwise; ``bits`` is of ``v``'s placements)."""
    if not _is_dtensor(v):
        return _round_sr(v, bits)
    from torch.distributed.tensor import DTensor

    if list(v.placements) != list(bits.placements):
        v = v.redistribute(bits.device_mesh, bits.placements)
    return DTensor.from_local(_round_sr(v.to_local(), bits.to_local()), bits.device_mesh,
                              bits.placements, run_check=False, shape=v.shape,
                              stride=v.stride())


def sr_to_bf16(v: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding float32 -> bf16 via the mantissa bit trick, with
    ``jax.random.bits(key, v.shape)``'s bits: the reference's, bit for bit.
    Unbiased."""
    return _round_sr(v, prng.bits(key, v.shape, device=v.device))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``min_lr`` at
    ``total_steps`` (float32, on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: Optional[OptConfig] = None) -> dict:
    """The state of a parameter tree (or a model): step 0 (int32, on the
    parameters' device), master weights and zero moments in
    ``cfg.state_dtype``, each a tree of the parameters' structure."""
    dt = getattr(torch, (cfg or OptConfig()).state_dtype)
    tree = _tree(params)
    device = leaf_parts(tree_items(tree)[0][1])[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda leaf: map_parts(
            lambda p: p.detach().to(dt, copy=True), leaf), tree),
        "mu": tree_map(lambda leaf: map_parts(lambda p: torch.zeros_like(p, dtype=dt), leaf),
                       tree),
        "nu": tree_map(lambda leaf: map_parts(lambda p: torch.zeros_like(p, dtype=dt), leaf),
                       tree),
    }


def global_norm(tree) -> torch.Tensor:
    parts = [t for _, leaf in tree_items(tree) for t in leaf_parts(leaf)]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in parts))


def _leaf_draws(draw, key, leaf) -> list:
    """One draw of ``draw(key, shape, device)`` over the leaf's stacked
    shape, split into its parts (row-major, as the reference's stacked leaf
    lays them out)."""
    parts = leaf_parts(leaf)
    whole = draw(key, stacked_shape(leaf), device=parts[0].device)
    return list(whole.reshape((len(parts),) + tuple(parts[0].shape)))


# Elements of a stochastic-rounding draw hashed at once.  A draw holds its
# words as int64 and the hash makes a few more arrays of its size, ~48 bytes
# an element at its peak: a whole stacked leaf of xlstm-1.3b (6 x 7 x 4096 x
# 4096, 705 M elements) peaks at 33.8 GB (NVIDIA H100 80GB HBM3, 700.00 W),
# beside the state.
DRAW_ELEMENTS = 1 << 27


def _leaf_bits(key, leaf):
    """The parts of ``_leaf_draws(prng.bits, key, leaf)``, in order: the
    stacked draw's flat indices hashed a run of whole parts at a time (at
    most DRAW_ELEMENTS elements, or one part), each run when it is reached;
    for ``DTensor`` parts each rank hashes only its own block's flat
    indices of the stacked draw."""
    parts = leaf_parts(leaf)
    if not _is_dtensor(parts[0]):
        numel, shape, device = parts[0].numel(), tuple(parts[0].shape), parts[0].device
        run = max(1, DRAW_ELEMENTS // max(numel, 1))
        for i0 in range(0, len(parts), run):
            n = min(run, len(parts) - i0)
            index = torch.arange(i0 * numel, (i0 + n) * numel, dtype=torch.int64, device=device)
            yield from prng.bits_at(key, index).reshape((n,) + shape)
        return
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_block

    numel = parts[0].numel()
    for i, p in enumerate(parts):
        local_shape, offset = local_block(p.shape, p.device_mesh, p.placements)
        block = [slice(o, o + n) for o, n in zip(offset, local_shape)]
        index = (i * numel + prng.block_index(p.shape, block)).to(p.to_local().device)
        yield DTensor.from_local(prng.bits_at(key, index.reshape(local_shape)),
                                 p.device_mesh, p.placements, run_check=False,
                                 shape=p.shape, stride=p.stride())


def compress_int8(grads, key: torch.Tensor):
    """Per-leaf int8 quantization with stochastic rounding (unbiased), then
    dequantization: a compressed all-reduce payload.  A new tree."""
    items = tree_items(grads)
    keys = prng.split(key, len(items))
    out = []
    for (_, leaf), k in zip(items, keys):
        parts = [g.to(torch.float32) for g in leaf_parts(leaf)]
        top = torch.max(torch.stack([torch.max(torch.abs(g)) for g in parts]))
        scale = torch.clamp(top, min=1e-12) / 127.0
        us = iter(_leaf_draws(prng.uniform, k, leaf))

        def one(g):
            v = g.to(torch.float32) / scale
            lo = torch.floor(v)
            q = lo + (next(us) < (v - lo))
            return torch.clamp(q, -127, 127) * scale

        out.append(map_parts(one, leaf))
    return tree_unflatten(grads, out)


def apply_updates(
    params,
    grads,
    state: dict,
    cfg: OptConfig,
    *,
    compress_key: Optional[torch.Tensor] = None,
) -> Tuple[object, dict, dict]:
    """One AdamW step, in place: (params, state, {"grad_norm", "lr"}).

    ``params`` is a tree or a model (its ``param_tree``); ``grads`` a tree of
    its structure.  The state's step, master weights and moments, and the
    parameters (the master cast to their type), are overwritten."""
    tree = _tree(params)
    sharded = _is_dtensor(leaf_parts(tree_items(tree)[0][1])[0])
    with _replicating(sharded):
        return _apply_updates(tree, params, grads, state, cfg, compress_key)


def _replicating(on: bool):
    """``DTensor``'s implicit replication (plain scalars beside sharded
    leaves) when ``on``."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _apply_updates(tree, params, grads, state, cfg, compress_key):
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = tree_map(lambda leaf: map_parts(lambda g: g.to(torch.float32) * scale, leaf), grads)
    if cfg.compress_grads and compress_key is not None:
        grads = compress_int8(grads, compress_key)

    step = state["step"] + 1
    step_l = _local(step)  # a replicated DTensor step: the scalars stay plain
    lr = schedule(cfg, step_l)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=step_l.device) ** step_l.to(
        torch.float32)
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=step_l.device) ** step_l.to(
        torch.float32)
    sr = cfg.state_dtype == "bfloat16"

    leaves = [tree_items(t) for t in (state["mu"], state["nu"], grads, state["master"], tree)]
    if not all(len(x) == len(leaves[0]) for x in leaves):
        raise ValueError("params, grads and state are trees of different structure")
    if sr:  # deterministic per-leaf, per-step keys (SR must differ across steps)
        base = prng.fold_in(prng.key(17), int(step_l))
        keys = prng.split(base, len(leaves[0]))
    with torch.no_grad():
        for i, items in enumerate(zip(*leaves)):
            m_leaf, v_leaf, g_leaf, w_leaf, p_leaf = (leaf for _, leaf in items)
            if sr:
                k1, k2, k3 = prng.split(keys[i], 3)
                noise = [iter(_leaf_bits(k, m_leaf)) for k in (k1, k2, k3)]
            for m, v, g, master, p in zip(*(leaf_parts(x) for x in
                                            (m_leaf, v_leaf, g_leaf, w_leaf, p_leaf))):
                m32 = b1 * m.to(torch.float32) + (1 - b1) * g
                v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
                mhat = m32 / bc1
                vhat = v32 / bc2
                w32 = master.to(torch.float32)
                new_master = w32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                         + cfg.weight_decay * w32)
                if sr:
                    m32, v32, new_master = (_round_sr_any(x, next(n))
                                            for x, n in zip((m32, v32, new_master), noise))
                m.copy_(m32)
                v.copy_(v32)
                master.copy_(new_master)
                p.copy_(new_master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
