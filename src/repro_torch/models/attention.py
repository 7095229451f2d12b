"""Attention: twins of ``repro.models.attention`` (GQA / MQA, QKV bias,
sliding window, RoPE, cross-attention gated or not, full and ring-buffer
KV caches).

Self-attention takes three routes in train and prefill mode, chosen as the
reference chooses them (``self_attention``): the flash kernel
(``cfg.attn_impl == "flash"``, ``kernels/ops.py``; train mode only, as in
the reference), the chunked online softmax (``_sdpa_chunked``, "auto" at S
a multiple of ``cfg.attn_chunk`` above it), and the naive softmax
(``_sdpa``).  Decode attends with the naive softmax over every cache slot.
Cross-attention takes the naive softmax with no mask, as the reference's
does.

Cache protocol: a dict {"k": (B, S_c, KV, hd), "v": ..., "pos": (S_c,)
int32 absolute position per slot, -1 = empty}.  Full caches have S_c =
max_len; sliding-window caches are rings of S_c = min(max_len, window)
slots.  Prefill and decode write the cache given in place and return it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.context import merge_heads, on_local_heads, split_heads, write_rows
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, param

NEG_INF = -1e30


class Attention(torch.nn.Module):
    """wq (d, H hd), wk and wv (d, KV hd), wo (H hd, d); bq, bk, bv with
    ``cfg.qkv_bias``; with ``cross`` the float32 scalar tanh gate of the
    vlm's cross-attention layers (zero at init)."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None, cross: bool = False):
        super().__init__()
        d, h, kv, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.dtype
        self.wq = param(gen, (d, h * hd), dt)
        self.wk = param(gen, (d, kv * hd), dt)
        self.wv = param(gen, (d, kv * hd), dt)
        self.wo = param(gen, (h * hd, d), dt, scale=(h * hd) ** -0.5)
        if cfg.qkv_bias:
            self.bq = param(gen, (h * hd,), dt, fill=0.0)
            self.bk = param(gen, (kv * hd,), dt, fill=0.0)
            self.bv = param(gen, (kv * hd,), dt, fill=0.0)
        if cross:
            self.gate = param(gen, (), torch.float32, fill=0.0)


def init_cache(cfg, batch: int, max_len: int, dtype, device=None) -> dict:
    """An empty cache on ``device`` (``None``: the card): k and v zeros of
    ``dtype``, every slot's position -1."""
    device = resolve_device(device)
    s_c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, s_c, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((s_c,), -1, dtype=torch.int32, device=device),
    }


def _project_qkv(p: Attention, cfg, x, kv_src):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.wq
    k = kv_src @ p.wk
    v = kv_src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_heads(q, h, hd)
    k = split_heads(k, kv, hd)
    v = split_heads(v, kv, hd)
    return q, k, v


def _sdpa(q, k, v, mask, scale, probs_dtype=None):
    """q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd), mask: (B,Sq,Skv) bool or None.
    The logits are taken in the working type and then widened to float32,
    as the reference's einsum does."""
    h, kv = q.shape[2], k.shape[2]
    rep = h // kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(probs_dtype or q.dtype), v)


def _sdpa_chunked(q, k, v, positions, scale, *, causal, window, chunk, probs_dtype=None):
    """Online-softmax attention over KV blocks of ``chunk`` (the reference's
    ``lax.scan``): the (Sq, Skv) score matrix never exists at once."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    if skv % chunk:
        raise ValueError(f"{skv} keys are not blocks of {chunk}")
    q32 = q.to(torch.float32)
    q_pos = positions[:, :, None]  # (B, Sq, 1)
    if positions.shape[1] == skv:
        k_pos_all = positions[:, :skv]
    else:
        k_pos_all = torch.arange(skv, device=q.device)[None].expand(b, skv)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, chunk):
        kk, vv = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
        if rep > 1:
            kk, vv = kk.repeat_interleave(rep, dim=2), vv.repeat_interleave(rep, dim=2)
        k_pos = k_pos_all[:, k0:k0 + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kk.to(torch.float32)) * scale
        mask = torch.ones((b, sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[:, None, :] <= q_pos
        if window is not None:
            mask &= k_pos[:, None, :] > q_pos - window
        s = torch.where(mask[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(probs_dtype or q.dtype), vv).to(torch.float32)
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def self_attention(p: Attention, cfg, x, positions, *, mode: str = "train",
                   cache: Optional[dict] = None, causal: bool = True):
    """Self-attention of x (B, S, d) at positions (B, S): (out, new_cache).

    ``mode`` is train, prefill or decode.  Prefill writes the sequence's
    keys and values into ``cache`` (when given) and returns it: at slot 0
    on, or with a window and S >= S_c the last S_c at slots ``pos % S_c``
    (the ring's tail); decode (S = 1, one position for the batch) writes
    slot ``pos % S_c`` (window) or ``pos``, clamped into the cache as
    ``dynamic_update_slice`` clamps it, and attends over every valid slot.
    The slot is computed on the device: no host sync.  Train mode returns
    no cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = cfg.hd**-0.5
    w = cfg.sliding_window
    probs_dtype = torch.bfloat16 if cfg.attn_probs_bf16 else None
    chunk = cfg.attn_chunk
    impl = cfg.attn_impl

    if mode in ("train", "prefill"):
        # The flash kernel: train mode only (it derives positions from block
        # indices, which matches the contiguous positions of train/encode
        # calls but not a prefill continuation), and the sequence must tile
        # into its blocks; the encoder stage's power-of-two length buckets
        # satisfy both by construction.
        if impl == "flash" and mode == "train" and s % min(128, s) == 0 and q.shape[-1] <= 128:
            out = ops.flash_attention(q, k, v, causal=causal, window=w)
        elif impl != "sdpa" and chunk and s % chunk == 0 and s > chunk:
            out = on_local_heads(
                lambda q, k, v, pos: _sdpa_chunked(q, k, v, pos, scale, causal=causal,
                                                   window=w, chunk=chunk,
                                                   probs_dtype=probs_dtype),
                q, k, v, positions)
        else:
            q_pos = positions[:, :, None]  # (B, S, 1)
            k_pos = positions[:, None, :]  # (B, 1, S)
            if causal:
                mask = k_pos <= q_pos
            else:
                mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device)
            if w is not None and causal:
                mask &= k_pos > q_pos - w
            out = on_local_heads(
                lambda q, k, v, mask: _sdpa(q, k, v, mask, scale, probs_dtype=probs_dtype),
                q, k, v, mask.expand(b, s, s))
        new_cache = None
        if mode == "prefill" and cache is not None:
            s_c = cache["k"].shape[1]
            if w is not None and s >= s_c:
                # Keep the last S_c keys, slot = pos % S_c.
                tail_pos = positions[0, -s_c:]
                slots = (tail_pos % s_c).long()
                write_rows(cache["k"], 1, slots, k[:, -s_c:].to(cache["k"].dtype))
                write_rows(cache["v"], 1, slots, v[:, -s_c:].to(cache["v"].dtype))
                write_rows(cache["pos"], 0, slots, tail_pos.to(torch.int32))
            else:
                if s > s_c:
                    raise ValueError(f"a prefill of {s} tokens does not fit a cache of {s_c} "
                                     "slots without a sliding window")
                write_rows(cache["k"], 1, slice(0, s), k)
                write_rows(cache["v"], 1, slice(0, s), v)
                write_rows(cache["pos"], 0, slice(0, s), positions[0])
            new_cache = cache
        return merge_heads(out) @ p.wo, new_cache

    # ---- decode: s == 1, write kv at slot, attend over the cache ----
    if mode != "decode" or cache is None or s != 1:
        raise ValueError(f"self_attention: mode {mode!r} with S {s} "
                         f"{'and' if cache is not None else 'without'} a cache")
    s_c = cache["k"].shape[1]
    pos0 = positions[0, :1]  # (1,): one position for the whole batch (batched serve)
    slot = (pos0 % s_c if w is not None else torch.clamp(pos0, 0, s_c - 1)).long()
    write_rows(cache["k"], 1, slot, k.to(cache["k"].dtype))
    write_rows(cache["v"], 1, slot, v.to(cache["v"].dtype))
    write_rows(cache["pos"], 0, slot, pos0.to(torch.int32))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos0)
    if w is not None:
        valid &= cpos > pos0 - w
    mask = valid[None, None, :].expand(b, 1, s_c)
    out = on_local_heads(
        lambda q, k, v, mask: _sdpa(q, k, v, mask, scale, probs_dtype=probs_dtype),
        q, cache["k"], cache["v"], mask)
    return merge_heads(out) @ p.wo, cache


def cross_attention(p: Attention, cfg, x, memory, *, gated: bool = False) -> torch.Tensor:
    """Attention of x (B, S, d) over memory (B, T, d), frontend or encoder
    states, with no mask; scaled by tanh(gate) when ``gated``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, memory)
    out = on_local_heads(lambda q, k, v: _sdpa(q, k, v, None, cfg.hd**-0.5), q, k, v)
    out = merge_heads(out) @ p.wo
    if gated and hasattr(p, "gate"):
        out = torch.tanh(p.gate).to(out.dtype) * out
    return out
