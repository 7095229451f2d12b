"""Model assembly, every family of the registry: twins of
``repro.models.model``'s ``init_params``, ``init_cache``, ``forward``,
``train_loss``, ``prefill``, ``decode_step``, ``encode`` and
``embed_sentences``.

The reference stacks its layers as pytrees with a leading ``n_groups``
axis (and a second axis for a group's repeated sub-blocks) and scans over
them; here each group is a module in an ``nn.ModuleList``, a group's
repeated sub-blocks a nested ``nn.ModuleList``, and the forward pass walks
them in order.  A group per family, as the reference's ``_group_init``:

  * dense, moe, encdec: one transformer :class:`Block` (MoE in place of the
    MLP for moe; self-attention, then cross-attention over the encoder's
    states, for the encdec decoder);
  * vlm: g - 1 self-attention blocks, then one gated cross-attention block
    over the frontend embeddings;
  * hybrid: g Mamba2 blocks, then the one shared attention block
    (``model.shared["attn"]``, with its MLP), reapplied after every group;
  * ssm: g - 1 mLSTM blocks, then one sLSTM block.

The modules hold parameters; the functions apply them, so one model serves
several configs that differ only in how they compute (``attn_impl``,
``moe_impl``).

The cache keeps the reference's tree and its stacked axes: every leaf under
``cache["layers"]`` has a leading ``n_groups`` axis, and a group's repeated
sub-blocks (vlm ``self``, hybrid ``mamba``, ssm ``mlstm``) a second one.
Each layer reads and writes its own view of those tensors in place, so a
decode step allocates no cache: ``prefill`` and ``decode_step`` consume the
cache they are given and return it, updated (clone it first to keep the
old one).

Entry points:
  init_params(cfg, seed, device=None) -> Model
  init_cache(cfg, batch, max_len, dtype=None, device=None) -> cache
  forward(cfg, model, tokens, positions=None, mode="train", cache=None,
          frontend=None, return_hidden=False) -> (logits or hidden, cache, aux)
  train_loss(cfg, model, batch) -> (loss + aux, loss)
  prefill(cfg, model, tokens, cache, frontend=None) -> (logits, cache)
  decode_step(cfg, model, tokens, positions, cache) -> (last logits, cache)
  encode(cfg, model, frontend) -> encoder states (encdec)
  embed_sentences(cfg, model, tokens, seg_ids, n_segments, frontend=None)
  param_tree(model) -> the parameters nested as the reference's tree

The reference's ``_dummy_cache`` and ``_train_cache_len`` exist for its
scan's signature; train mode here takes no cache, so they have no twin.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.context import constrain, fsdp_gathered, lookup_rows
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssd, xlstm
from repro_torch.models.common import (
    RMSNorm,
    index_tree,
    param,
    rmsnorm,
    stack_tree,
)

# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Block(torch.nn.Module):
    """One transformer block: attn_norm, attn, mlp_norm, then moe (with
    ``use_moe``) or mlp (if d_ff).  ``cross``: the attention itself is the
    vlm's gated cross-attention, and the block's FFN has its own tanh gate
    ffn_gate (float32, zero at init); ``with_cross``: an encdec decoder
    block, cross_norm and cross_attn after the self-attention."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None, *, cross: bool = False,
                 use_moe: bool = False, with_cross: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        self.attn = attn.Attention(cfg, gen, cross=cross)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        if with_cross:
            self.cross_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
            self.cross_attn = attn.Attention(cfg, gen)
        if use_moe:
            self.moe = mlp_mod.Moe(cfg, gen)
        elif cfg.d_ff:
            self.mlp = mlp_mod.Mlp(cfg, gen)
        if cross:
            self.ffn_gate = param(gen, (), torch.float32, fill=0.0)


def _attn_block_apply(p: Block, cfg, x, positions, *, mode="train", cache=None, memory=None,
                      cross=False, causal=True):
    """(x, aux): the block's residual update and its router aux loss.  In
    prefill and decode the self-attention writes ``cache`` (this block's
    views) in place; a cross layer keeps none (memory is static), and a
    non-causal block (the encoder's) runs in train mode unless decoding."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p.attn_norm.scale, x, eps=cfg.norm_eps)
    if cross:
        a = attn.cross_attention(p.attn, cfg, h, memory, gated=True)
    else:
        mode_eff = "train" if (not causal and mode != "decode") else mode
        a, _ = attn.self_attention(p.attn, cfg, h, positions, mode=mode_eff, cache=cache,
                                   causal=causal)
    # Over a mesh each sub-layer's output (a partial sum over the model
    # axis after its row-parallel projection) is reduced onto the batch
    # layout before the residual add, so the residual stream keeps one
    # layout through the block.
    x = x + constrain(a, "batch", None, None)
    if hasattr(p, "cross_attn"):  # enc-dec decoder block
        h = rmsnorm(p.cross_norm.scale, x, eps=cfg.norm_eps)
        x = x + constrain(attn.cross_attention(p.cross_attn, cfg, h, memory), "batch", None, None)
    h = rmsnorm(p.mlp_norm.scale, x, eps=cfg.norm_eps)
    if hasattr(p, "moe"):
        m, aux = mlp_mod.moe_apply(p.moe, cfg, h)
    elif hasattr(p, "mlp"):
        m = mlp_mod.mlp_apply(p.mlp, cfg, h)
    else:
        m = torch.zeros_like(h)
    if cross:
        m = torch.tanh(p.ffn_gate).to(m.dtype) * m
    return x + constrain(m, "batch", None, None), aux


class MixerBlock(torch.nn.Module):
    """norm, then a sequence mixer under the reference's name for it:
    ``mixer`` (Mamba2, mLSTM) or ``cell`` (sLSTM)."""

    def __init__(self, cfg, gen: Optional[torch.Generator], name: str, mixer_cls):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        setattr(self, name, mixer_cls(cfg, gen))


def _mixer_block_apply(p: MixerBlock, cfg, x, name: str, apply_fn, *, mode, cache):
    """The mixer's residual update; in prefill and decode the mixer writes
    ``cache`` (its views) in place."""
    h = rmsnorm(p.norm.scale, x, eps=cfg.norm_eps)
    y, _ = apply_fn(getattr(p, name), cfg, h, mode=mode, cache=cache)
    return x + constrain(y, "batch", None, None)


# ---------------------------------------------------------------------------
# Super-block (group) definitions per family
# ---------------------------------------------------------------------------


class Group(torch.nn.Module):
    """One super-block of a heterogeneous family; its sub-block lists and
    blocks carry the reference's names (``self`` and ``cross`` for vlm,
    ``mamba`` for hybrid, ``mlstm`` and ``slstm`` for ssm)."""

    def __init__(self, parts: dict):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


def _group_init(cfg, gen):
    fam, g = cfg.family, cfg.group_size
    if fam in ("dense", "moe", "encdec"):
        if g != 1:
            raise ValueError(f"{cfg.name}: a {fam} group is one block, not {g}")
        return Block(cfg, gen, use_moe=cfg.moe is not None, with_cross=fam == "encdec")
    if fam == "vlm":
        return Group({"self": torch.nn.ModuleList(Block(cfg, gen) for _ in range(g - 1)),
                      "cross": Block(cfg, gen, cross=True)})
    if fam == "hybrid":
        return Group({"mamba": torch.nn.ModuleList(
            MixerBlock(cfg, gen, "mixer", ssd.Mamba2) for _ in range(g))})
    if fam == "ssm":  # xlstm
        return Group({"mlstm": torch.nn.ModuleList(
                          MixerBlock(cfg, gen, "mixer", xlstm.Mlstm) for _ in range(g - 1)),
                      "slstm": MixerBlock(cfg, gen, "cell", xlstm.Slstm)})
    raise ValueError(f"unknown model family {fam!r}")


def _group_apply(cfg, gp, shared, x, positions, *, mode, cache, memory):
    """Apply one super-block: (x, aux).  ``cache`` is this group's views
    (None in train mode); each sub-block takes its own.  Over a mesh the
    group's weights are gathered over the data axes for the group's span
    (inside the remat boundary, so the recomputation gathers them again)."""
    with fsdp_gathered(gp), fsdp_gathered(shared):
        return _group_body(cfg, gp, shared, x, positions, mode=mode, cache=cache,
                           memory=memory)


def _group_body(cfg, gp, shared, x, positions, *, mode, cache, memory):
    fam = cfg.family
    # Pin activations to batch sharding at every super-block boundary so the
    # 2-D weight sharding resolves to FSDP gathers, not batch replication.
    x = constrain(x, "batch", None, None)
    if fam in ("dense", "moe", "encdec"):
        return _attn_block_apply(gp, cfg, x, positions, mode=mode, cache=cache, memory=memory)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    parts = {} if cache is None else cache
    if fam == "vlm":
        for j, blk in enumerate(gp.self):
            x, a = _attn_block_apply(blk, cfg, x, positions, mode=mode,
                                     cache=index_tree(parts.get("self"), j))
            aux = aux + a
        x, a = _attn_block_apply(gp.cross, cfg, x, positions, mode=mode,
                                 cache=parts.get("cross"), memory=memory, cross=True)
        return x, aux + a
    if fam == "hybrid":
        for j, blk in enumerate(gp.mamba):
            x = _mixer_block_apply(blk, cfg, x, "mixer", ssd.mamba2_apply, mode=mode,
                                   cache=index_tree(parts.get("mamba"), j))
        # Shared attention block (zamba2): one weight set reused per group,
        # each group with its own cache.
        x, a = _attn_block_apply(shared["attn"], cfg, x, positions, mode=mode,
                                 cache=parts.get("shared_attn"))
        return x, aux + a
    if fam == "ssm":
        for j, blk in enumerate(gp.mlstm):
            x = _mixer_block_apply(blk, cfg, x, "mixer", xlstm.mlstm_apply, mode=mode,
                                   cache=index_tree(parts.get("mlstm"), j))
        x = _mixer_block_apply(gp.slstm, cfg, x, "cell", xlstm.slstm_apply, mode=mode,
                               cache=parts.get("slstm"))
        return x, aux
    raise ValueError(f"unknown model family {fam!r}")


# ---------------------------------------------------------------------------
# Cache construction (mirrors the group structure; leading axis n_groups)
# ---------------------------------------------------------------------------


def _group_cache_init(cfg, batch, max_len, dtype, device):
    fam, g = cfg.family, cfg.group_size
    if fam in ("dense", "moe", "encdec"):
        return attn.init_cache(cfg, batch, max_len, dtype, device)
    if fam == "vlm":
        return {"self": stack_tree(attn.init_cache(cfg, batch, max_len, dtype, device), g - 1),
                "cross": torch.zeros((0,), dtype=dtype, device=device)}  # cacheless
    if fam == "hybrid":
        return {"mamba": stack_tree(ssd.mamba2_cache_init(cfg, batch, dtype, device), g),
                "shared_attn": attn.init_cache(cfg, batch, max_len, dtype, device)}
    if fam == "ssm":
        return {"mlstm": stack_tree(xlstm.mlstm_cache_init(cfg, batch, dtype, device), g - 1),
                "slstm": xlstm.slstm_cache_init(cfg, batch, dtype, device)}
    raise ValueError(f"unknown model family {fam!r}")


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """An empty prefill / decode cache for ``batch`` rows of up to
    ``max_len`` tokens (a ring of ``sliding_window`` slots where the config
    has one), of ``dtype`` (default the config's; SSM states float32) on
    ``device`` (``None``: the card; raises without one).  vlm and encdec
    also keep the frontend or encoder states, ``memory`` (B, T, d)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    one = _group_cache_init(cfg, batch, max_len, dtype, device)
    cache = {"layers": stack_tree(one, cfg.n_groups)}
    if cfg.family in ("vlm", "encdec"):
        cache["memory"] = torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype,
                                      device=device)
    return cache


# ---------------------------------------------------------------------------
# Whisper encoder (non-causal self-attention over frontend embeddings)
# ---------------------------------------------------------------------------


class Encoder(torch.nn.Module):
    """blocks (``encoder_layers`` transformer blocks) and a final norm."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = torch.nn.ModuleList(Block(cfg, gen) for _ in range(cfg.encoder_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.dtype, gen)


def encode(cfg, model: "Model", frontend: torch.Tensor) -> torch.Tensor:
    """frontend: (B, T, d) stub conv/patch embeddings -> encoder states.
    At T = 1500 (whisper) the sequence does not tile into the flash
    kernel's blocks, so every route takes the naive softmax, as in the
    reference."""
    b, t, _ = frontend.shape
    positions = torch.arange(t, device=frontend.device)[None].expand(b, t)
    x = frontend
    for blk in model.encoder.blocks:
        with fsdp_gathered(blk):
            x, _ = _attn_block_apply(blk, cfg, x, positions, causal=False)
    return rmsnorm(model.encoder.norm.scale, x, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Top-level model
# ---------------------------------------------------------------------------


class Model(torch.nn.Module):
    """embed (padded vocab, d), final_norm, layers (one group each), and
    unembed (d, padded vocab) unless the embeddings are tied; ``shared``
    (hybrid: the shared attention block) and ``encoder`` (encdec): the
    reference's parameter tree."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = param(gen, (cfg.padded_vocab, cfg.d_model), cfg.dtype, scale=1.0)
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        self.layers = torch.nn.ModuleList(_group_init(cfg, gen) for _ in range(cfg.n_groups))
        if not cfg.tie_embeddings:
            self.unembed = param(gen, (cfg.d_model, cfg.padded_vocab), cfg.dtype)
        self.shared = (torch.nn.ModuleDict({"attn": Block(cfg, gen)})
                       if cfg.family == "hybrid" else None)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, gen)


def init_params(cfg, seed: int, device=None) -> Model:
    """A freshly initialised model on ``device`` (``None``: the card; raises
    without one), drawn from a ``torch.Generator`` seeded with ``seed``.  The
    reference's shapes and dtypes; its numbers only through
    ``interop.carry_across("params", ...)``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model(cfg, gen)


def _logits(cfg, model: Model, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(model.final_norm.scale, x, eps=cfg.norm_eps)
    with fsdp_gathered(model, recurse=False):
        logits = x @ (model.embed.T if cfg.tie_embeddings else model.unembed)
    logits = constrain(logits, "batch", None, "model")
    # Mask padded vocab columns so they never win.
    pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(pad_mask, logits.to(torch.float32), -1e30)


MODES = ("train", "prefill", "decode")


def forward(
    cfg,
    model: Model,
    tokens: torch.Tensor,  # (B, S) int
    positions: Optional[torch.Tensor] = None,  # (B, S)
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    frontend: Optional[torch.Tensor] = None,  # (B, T, d) vlm / audio stub embeddings
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """(logits (B, S, padded vocab) float32, or the last group's hidden
    states (B, S, d) with ``return_hidden``; the cache, updated in place,
    in prefill and decode (None in train mode); aux, the summed router aux
    loss of the MoE layers, float32).  vlm / encdec memory comes from the
    frontend (encoded, for encdec) in train and prefill, where prefill also
    stores it in the cache, and from ``cache["memory"]`` in decode."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
    if mode != "train" and cache is None:
        raise ValueError(f"{mode} needs a cache from init_cache")
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    # The scale is rounded to the working type first, as the reference's
    # jnp.asarray(d_model**0.5, dtype) is (27.71 -> 27.75 in bf16); a CPU
    # 0-dim tensor is passed to the kernel as a scalar (no copy to the card).
    with fsdp_gathered(model, recurse=False):
        x = lookup_rows(model.embed, tokens.long()) * torch.tensor(cfg.d_model**0.5,
                                                                    dtype=cfg.dtype)
    x = constrain(x, "batch", None, None)
    memory = None
    if cfg.family in ("vlm", "encdec"):
        if mode == "decode":
            memory = cache["memory"]
        else:
            if frontend is None:
                raise ValueError(f"{cfg.name}: vlm/encdec need frontend embeddings")
            memory = encode(cfg, model, frontend) if cfg.family == "encdec" else frontend
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # The reference's jax.checkpoint(group_fn): under grad, a group keeps only
    # its input and recomputes its activations in the backward pass.
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i, group in enumerate(model.layers):
        gc = None if mode == "train" else index_tree(cache["layers"], i)
        if remat:
            x, a = checkpoint(_group_apply, cfg, group, model.shared, x, positions, mode=mode,
                              cache=None, memory=memory, use_reentrant=False)
        else:
            x, a = _group_apply(cfg, group, model.shared, x, positions, mode=mode, cache=gc,
                                memory=memory)
        aux = aux + a
    new_cache = None
    if mode != "train":
        new_cache = cache
        if memory is not None:
            cache["memory"] = memory
    if return_hidden:
        return x, new_cache, aux
    return _logits(cfg, model, x), new_cache, aux


def train_loss(cfg, model: Model, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross-entropy over the float32 logits: (loss + the routers'
    aux loss, loss).  batch: tokens (B, S), targets (B, S) with -1 at masked
    positions, and frontend (B, T, d) where the family needs one."""
    logits, _, aux = forward(cfg, model, batch["tokens"], mode="train",
                             frontend=batch.get("frontend"))
    targets = batch["targets"]
    mask = targets >= 0
    safe = torch.clamp(targets, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return loss + aux, loss


def prefill(cfg, model: Model, tokens: torch.Tensor, cache: dict, *,
            frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Run the prompt tokens (B, S) at positions 0..S-1 into ``cache``
    (consumed: written in place and returned): (logits (B, S, V), cache)."""
    logits, cache, _ = forward(cfg, model, tokens, mode="prefill", cache=cache,
                               frontend=frontend)
    return logits, cache


def decode_step(cfg, model: Model, tokens: torch.Tensor, positions: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """tokens (B, 1) at positions (B, 1), the absolute position of the new
    token (one for the batch): (logits of the last position (B, V), cache,
    consumed: written in place and returned)."""
    logits, cache, _ = forward(cfg, model, tokens, positions, mode="decode", cache=cache)
    return logits[:, -1], cache


def embed_sentences(cfg, model: Model, tokens: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int, *, frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-pool hidden states per sentence segment -> (B, n_segments, d)
    float32.  seg_ids: (B, S) sentence id per token, -1 for padding (a zero
    one-hot row, as ``jax.nn.one_hot(-1, G)`` gives)."""
    hidden, _, _ = forward(cfg, model, tokens, mode="train", frontend=frontend,
                           return_hidden=True)
    segs = torch.arange(n_segments, device=seg_ids.device)
    onehot = (seg_ids[..., None] == segs).to(torch.float32)  # (B, S, G)
    sums = torch.einsum("bsd,bsg->bgd", hidden.to(torch.float32), onehot)
    counts = torch.clamp(onehot.sum(dim=1), min=1.0)  # (B, G)
    return sums / counts[..., None]


def model_from_tree(cfg, tree: dict, device=None) -> Model:
    """The port's model holding the reference's ``init_params`` tree, given
    as nested dicts of numpy arrays.  A leaf under a stacked part carries
    that part's axes in front: ``layers`` (n_groups), and within a group
    ``self``, ``mamba`` and ``mlstm`` (the group's sub-blocks);
    ``encoder.blocks`` (encoder_layers).  Each is split one module per
    index; ``shared`` and ``encoder.norm`` are unstacked.  Each leaf takes
    its own parameter's type (float32 routers, gates and SSM constants in a
    bf16 model; bf16 leaves may arrive as float32 arrays)."""
    device = resolve_device(device)
    model = Model(cfg)
    state = {}

    def walk(module, node, prefix, index):
        for name, sub in node.items():
            child = getattr(module, name, None)
            if isinstance(child, torch.nn.ModuleList):
                for i, part in enumerate(child):
                    walk(part, sub, f"{prefix}{name}.{i}.", index + (i,))
            elif isinstance(sub, dict):
                walk(child, sub, f"{prefix}{name}.", index)
            else:
                leaf = torch.from_numpy(np.array(np.asarray(sub)[index]))
                state[prefix + name] = (leaf.to(child.dtype) if isinstance(child, torch.Tensor)
                                        else leaf)

    walk(model, tree, "", ())
    model.load_state_dict(state, strict=True)
    return model.to(device)


def param_tree(module: torch.nn.Module) -> dict:
    """The module's parameters nested as the reference's ``init_params``
    tree: dicts by name, and where the reference stacks a leaf (over
    ``layers``' groups, a group's ``self`` / ``mamba`` / ``mlstm``
    sub-blocks, ``encoder.blocks``) a list of the port's per-index tensors,
    one level of list for each stacked axis.  The inverse of
    :func:`model_from_tree`'s split; the leaves are the model's own
    parameters (no copy)."""
    tree = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            tree[name] = _stack_trees([param_tree(part) for part in child])
        else:
            tree[name] = param_tree(child)
    return tree


def _stack_trees(trees: list) -> dict:
    """Trees of one shape as one tree whose leaves are the lists of theirs."""
    first = trees[0]
    return {k: (_stack_trees([t[k] for t in trees]) if isinstance(first[k], dict)
                else [t[k] for t in trees]) for k in first}
