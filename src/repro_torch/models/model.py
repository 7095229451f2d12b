"""Model assembly for the dense family: twins of ``repro.models.model``'s
``init_params``, ``forward`` (train mode) and ``embed_sentences``.

The reference stacks its layers as one pytree with a leading ``n_groups``
axis and scans over it; here each layer is a :class:`Block` in an
``nn.ModuleList`` and the forward pass walks them in order.  The modules
hold parameters; the functions apply them, so one model serves several
configs that differ only in how they compute (``attn_impl``).

Entry points:
  init_params(cfg, seed, device=None) -> Model
  forward(cfg, model, tokens, positions=None, mode="train",
          return_hidden=False) -> (logits or hidden, None, aux)
  embed_sentences(cfg, model, tokens, seg_ids, n_segments) -> (B, G, d)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import RMSNorm, not_ported, param, rmsnorm


class Block(torch.nn.Module):
    """One transformer block: attn_norm, attn, mlp_norm, mlp (if d_ff)."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        self.attn = attn.Attention(cfg, gen)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        if cfg.d_ff:
            self.mlp = mlp_mod.Mlp(cfg, gen)


class Model(torch.nn.Module):
    """embed (padded vocab, d), final_norm, layers, and unembed (d, padded
    vocab) unless the embeddings are tied: the reference's parameter tree,
    one :class:`Block` per layer."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        check_ported(cfg)
        self.embed = param(gen, (cfg.padded_vocab, cfg.d_model), cfg.dtype, scale=1.0)
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, gen)
        self.layers = torch.nn.ModuleList(Block(cfg, gen) for _ in range(cfg.n_groups))
        if not cfg.tie_embeddings:
            self.unembed = param(gen, (cfg.d_model, cfg.padded_vocab), cfg.dtype)


def check_ported(cfg, mode: str = "train") -> None:
    """Raise for what the port's model stack cannot run yet."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise not_ported(f"model family {cfg.family!r} of {cfg.name}",
                         "queue 1: the other model families")
    if mode != "train":
        raise not_ported(f"mode {mode!r}", "queue 1: prefill and decode caches")


def init_params(cfg, seed: int, device=None) -> Model:
    """A freshly initialised model on ``device`` (``None``: the card; raises
    without one), drawn from a ``torch.Generator`` seeded with ``seed``.  The
    reference's shapes and dtypes; its numbers only through
    ``interop.carry_across("params", ...)``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model(cfg, gen)


def _attn_block_apply(p: Block, cfg, x, positions, *, causal=True):
    h = rmsnorm(p.attn_norm.scale, x, eps=cfg.norm_eps)
    x = x + attn.self_attention(p.attn, cfg, h, positions, causal=causal)
    h = rmsnorm(p.mlp_norm.scale, x, eps=cfg.norm_eps)
    m = mlp_mod.mlp_apply(p.mlp, cfg, h) if cfg.d_ff else torch.zeros_like(h)
    return x + m


def _logits(cfg, model: Model, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(model.final_norm.scale, x, eps=cfg.norm_eps)
    logits = x @ (model.embed.T if cfg.tie_embeddings else model.unembed)
    # Mask padded vocab columns so they never win.
    pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return torch.where(pad_mask, logits.to(torch.float32), -1e30)


def forward(
    cfg,
    model: Model,
    tokens: torch.Tensor,  # (B, S) int
    positions: Optional[torch.Tensor] = None,  # (B, S)
    *,
    mode: str = "train",
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, None, torch.Tensor]:
    """(logits (B, S, padded vocab) float32, or the last layer's hidden
    states (B, S, d) with ``return_hidden``; no cache; aux = 0)."""
    check_ported(cfg, mode)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    # The scale is rounded to the working type first, as the reference's
    # jnp.asarray(d_model**0.5, dtype) is (27.71 -> 27.75 in bf16).
    x = model.embed[tokens.long()] * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype,
                                                   device=tokens.device)
    for block in model.layers:
        x = _attn_block_apply(block, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, None, aux
    return _logits(cfg, model, x), None, aux


def embed_sentences(cfg, model: Model, tokens: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    """Mean-pool hidden states per sentence segment -> (B, n_segments, d)
    float32.  seg_ids: (B, S) sentence id per token, -1 for padding (a zero
    one-hot row, as ``jax.nn.one_hot(-1, G)`` gives)."""
    hidden, _, _ = forward(cfg, model, tokens, mode="train", return_hidden=True)
    segs = torch.arange(n_segments, device=seg_ids.device)
    onehot = (seg_ids[..., None] == segs).to(torch.float32)  # (B, S, G)
    sums = torch.einsum("bsd,bsg->bgd", hidden.to(torch.float32), onehot)
    counts = torch.clamp(onehot.sum(dim=1), min=1.0)  # (B, G)
    return sums / counts[..., None]


def model_from_tree(cfg, tree: dict, device=None) -> Model:
    """The port's model holding the reference's ``init_params`` tree, given
    as nested dicts of numpy arrays: each leaf of ``layers`` has a leading
    ``n_groups`` axis, split one layer per :class:`Block`; leaves are cast
    to the config's type (bf16 leaves may arrive as float32 arrays)."""
    device = resolve_device(device)
    model = Model(cfg)
    state = {}

    def walk(node, prefix):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.")
            elif prefix.startswith("layers."):
                for i in range(cfg.n_groups):
                    state[f"layers.{i}.{prefix[7:]}{name}"] = torch.tensor(leaf[i])
            else:
                state[f"{prefix}{name}"] = torch.tensor(leaf)

    walk(tree, "")
    state = {k: v.to(cfg.dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model.to(device)
