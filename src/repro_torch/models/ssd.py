"""Chunked state-space / linear-attention core (the Mamba2 SSD algorithm)
and the Mamba2 block (zamba2's backbone): twins of ``repro.models.ssd``'s
``chunked_linear_attention``, ``linear_attention_step``, ``mamba2_init``
(the :class:`Mamba2` module), ``mamba2_apply`` and ``mamba2_cache_init``.

The SSD recurrence  S_t = exp(a_t) S_{t-1} + k_t (x) v_t,  y_t = q_t . S_t
is evaluated chunk-parallel: quadratic attention-like products inside a
chunk, and a loop over the chunks' states between them; a decode step takes
it one token at a time.  The same core drives the mLSTM (``xlstm.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.context import constrain, on_local_rows
from repro_torch.models.common import RMSNorm, causal_conv1d, param, rmsnorm, write_cache


def chunked_linear_attention(
    q: torch.Tensor,  # (B, S, H, N)
    k: torch.Tensor,  # (B, S, H, N)
    v: torch.Tensor,  # (B, S, H, P)
    log_a: torch.Tensor,  # (B, S, H) per-step log decay, <= 0
    *,
    chunk: int = 64,
    state0: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in v's type, final state (B, H, N, P)
    float32).  Exact (no approximation)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    L = min(chunk, s)
    s_orig = s
    if s % L:
        # Pad with identity steps: decay 1 (log 0), k = v = 0 add nothing.
        pad = L - s % L
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        s = s + pad
    c = s // L

    f32 = torch.float32
    qc = q.to(f32).reshape(b, c, L, h, n)
    kc = k.to(f32).reshape(b, c, L, h, n)
    vc = v.to(f32).reshape(b, c, L, h, p)
    ac = log_a.to(f32).reshape(b, c, L, h)

    cum = torch.cumsum(ac, dim=2)  # inclusive within-chunk cumulative decay
    total = cum[:, :, -1]  # (B, C, H)

    # Intra-chunk: M_ij = (q_i . k_j) exp(cum_i - cum_j) for i >= j, masked
    # before the exp so that a masked entry is exp(-inf) = 0, never inf.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, C, L, L, H) i, j
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, diff, float("-inf")))
    scores = torch.einsum("bclhn,bcmhn->bclmh", qc, kc) * decay
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores, vc)

    # Chunk state contributions: sum_j exp(total - cum_j) k_j (x) v_j.
    rem = torch.exp(total[:, :, None] - cum)  # (B, C, L, H)
    s_chunk = torch.einsum("bclh,bclhn,bclhp->bchnp", rem, kc, vc)

    # Inter-chunk: the recurrence S_c = exp(total_c) S_{c-1} + s_chunk_c
    # (S_{-1} = state0) in closed form, S_i = sum_{j <= i} exp(sum_{j < k <=
    # i} total_k) s_chunk_j + exp(sum_{k <= i} total_k) state0: one product
    # over the chunks where a loop takes a few launches a chunk (and more
    # in its backward).  The segment sums are masked running sums, never
    # differences of running sums.
    tot = total.permute(0, 2, 1)  # (B, H, C)
    ones = torch.ones((c, c), dtype=torch.bool, device=q.device)
    below = torch.tril(ones, diagonal=-1)
    seg = torch.cumsum(tot[..., :, None].expand(b, h, c, c).masked_fill(~below, 0.0), dim=-2)
    chain = torch.exp(seg.masked_fill(~torch.tril(ones), float("-inf")))  # (B, H, C, C)
    after = torch.einsum("bhij,bjhnp->bihnp", chain, s_chunk)  # S_i: (B, C, H, N, P)
    if state0 is None:
        first = torch.zeros((b, 1, h, n, p), dtype=f32, device=q.device)
    else:
        first = state0.to(f32)[:, None]
        after = after + torch.exp(torch.cumsum(total, dim=1))[..., None, None] * first
    prev_states = torch.cat([first, after[:, :-1]], dim=1)  # the state entering each chunk
    state = after[:, -1]

    y_inter = torch.einsum("bclhn,bchnp,bclh->bclhp", qc, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(v.dtype), state


def linear_attention_step(
    q: torch.Tensor,  # (B, H, N)
    k: torch.Tensor,  # (B, H, N)
    v: torch.Tensor,  # (B, H, P)
    log_a: torch.Tensor,  # (B, H)
    state: torch.Tensor,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the same recurrence: (y (B, H, P) in v's type, the
    new state float32)."""
    f32 = torch.float32
    state = torch.exp(log_a.to(f32))[..., None, None] * state.to(f32) + torch.einsum(
        "bhn,bhp->bhnp", k.to(f32), v.to(f32))
    y = torch.einsum("bhn,bhnp->bhp", q.to(f32), state)
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


class Mamba2(torch.nn.Module):
    """in_proj (d, 2 d_in + 2 N + H), conv_w (K, d_in + 2 N), a_log, d_skip
    and dt_bias (H,) float32, norm over d_in, out_proj (d_in, d)."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        ssm, d, dt = cfg.ssm, cfg.d_model, cfg.dtype
        d_in = ssm.expand * d
        n = ssm.d_state
        h = d_in // ssm.head_dim
        conv_dim = d_in + 2 * n  # x, B, C all convolved (ngroups = 1)
        self.in_proj = param(gen, (d, 2 * d_in + 2 * n + h), dt)
        self.conv_w = param(gen, (ssm.d_conv, conv_dim), dt, scale=0.5)
        self.a_log = param(gen, (h,), torch.float32, fill=torch.log(torch.linspace(1.0, 16.0, h)))
        self.d_skip = param(gen, (h,), torch.float32, fill=1.0)
        self.dt_bias = param(gen, (h,), torch.float32, fill=0.0)
        self.norm = RMSNorm(d_in, dt, gen)
        self.out_proj = param(gen, (d_in, d), dt, scale=d_in**-0.5)


def mamba2_apply(p: Mamba2, cfg, x: torch.Tensor, *, mode: str = "train",
                 cache: Optional[dict] = None):
    """Mamba2 mixer of x (B, S, D): (out, new_cache).  The conv state is
    read in decode only (prefill pads with zeros); decode (S = 1) steps the
    recurrence from ``cache["state"]``.  Prefill and decode return the new
    {"conv", "state"}, written into ``cache`` in place when given."""
    ssm = cfg.ssm
    b, s, d = x.shape
    d_in = ssm.expand * d
    n = ssm.d_state
    h = d_in // ssm.head_dim
    ph = ssm.head_dim

    proj = constrain(x @ p.in_proj, "batch", None, "model")  # (B, S, 2 d_in + 2 N + H)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    conv_state = cache["conv"] if (cache is not None and mode == "decode") else None
    xbc, new_conv = causal_conv1d(xbc, p.conv_w, state=conv_state)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0), with no threshold (F.softplus
    # returns x above 20).
    dt_act = torch.logaddexp(dt_raw.to(torch.float32) + p.dt_bias,
                             torch.zeros((), device=x.device))  # (B, S, H)
    a = -torch.exp(p.a_log)[None, None, :] * dt_act  # log decay <= 0

    xh = xs.reshape(b, s, h, ph)
    v = xh * dt_act[..., None].to(xh.dtype)
    k = bmat[:, :, None, :].expand(b, s, h, n)  # ngroups = 1: shared by the heads
    q = cmat[:, :, None, :].expand(b, s, h, n)
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError(f"mamba2 decode takes one token and a cache, got S {s}")
        y1, new_state = on_local_rows(linear_attention_step, q[:, 0], k[:, 0], v[:, 0],
                                      a[:, 0], cache["state"])
        y = y1[:, None]
    else:  # row by row (each rank's rows over a mesh)
        y, new_state = on_local_rows(
            lambda q, k, v, a: chunked_linear_attention(q, k, v, a, chunk=ssm.chunk), q, k, v, a)

    y = y + p.d_skip[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(b, s, d_in)
    y = rmsnorm(p.norm.scale, y * F.silu(z), eps=cfg.norm_eps)
    out = y @ p.out_proj
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = write_cache(cache, {"conv": new_conv, "state": new_state})
    return out, new_cache


def mamba2_cache_init(cfg, batch: int, dtype, device=None) -> dict:
    """conv (B, K - 1, d_in + 2 N) of ``dtype``, state (B, H, N, P) float32,
    zeros, on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    n = ssm.d_state
    h = d_in // ssm.head_dim
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, d_in + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, n, ssm.head_dim), dtype=torch.float32, device=device),
    }
