"""xLSTM blocks: twins of ``repro.models.xlstm``'s mLSTM (matrix memory,
chunk-parallel through the SSD core, one step at a time in decode;
``mlstm_init`` is the :class:`Mlstm` module, ``mlstm_apply``,
``mlstm_cache_init``) and sLSTM (scalar memory with a hidden-to-hidden
recurrence, one scan op over time, ``ops.slstm_scan``; :class:`Slstm`,
``slstm_apply``, ``slstm_cache_init``).

As in the reference, the mLSTM input gate is a clipped exponential and
the normalizer rides the same chunked recurrence as an extra value column
(exact).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.context import mixer_on_local_rows
from repro_torch.kernels import ops
from repro_torch.models.common import (
    RMSNorm,
    activation,
    causal_conv1d,
    param,
    rmsnorm,
    write_cache,
)
from repro_torch.models.ssd import chunked_linear_attention, linear_attention_step

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class Mlstm(torch.nn.Module):
    """in_proj (d, 2 d_in) for x_inner and the z gate, conv_w (4, d_in),
    wq / wk / wv (d_in, d_in), w_gates (d_in, 2 NH) and gate_bias (2 NH,)
    float32 (input and forget gate per head; forget bias 3), norm over
    d_in, out_proj (d_in, d); d_in = 2 d."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        d, nh, dt = cfg.d_model, cfg.n_heads, cfg.dtype
        d_in = 2 * d
        self.in_proj = param(gen, (d, 2 * d_in), dt)
        self.conv_w = param(gen, (4, d_in), dt, scale=0.5)
        self.wq = param(gen, (d_in, d_in), dt)
        self.wk = param(gen, (d_in, d_in), dt)
        self.wv = param(gen, (d_in, d_in), dt)
        self.w_gates = param(gen, (d_in, 2 * nh), torch.float32)
        self.gate_bias = param(gen, (2 * nh,), torch.float32,
                               fill=torch.cat([torch.zeros(nh), torch.full((nh,), 3.0)]))
        self.norm = RMSNorm(d_in, dt, gen)
        self.out_proj = param(gen, (d_in, d), dt, scale=d_in**-0.5)


def _mlstm_qkv_gates(p: Mlstm, cfg, x, conv_state=None):
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = 2 * d // nh
    x_in, z = torch.chunk(x @ p.in_proj, 2, dim=-1)
    xc, new_conv = causal_conv1d(x_in, p.conv_w, state=conv_state)
    xc = F.silu(xc)
    q = (xc @ p.wq).reshape(b, s, nh, dh)
    k = (xc @ p.wk).reshape(b, s, nh, dh) * (dh**-0.5)
    v = (x_in @ p.wv).reshape(b, s, nh, dh)
    gates = x_in.to(torch.float32) @ p.w_gates + p.gate_bias
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)  # (B, S, NH)
    log_f = F.logsigmoid(f_raw)  # <= 0, exact
    i_gate = torch.exp(torch.clamp(i_raw, -15.0, 5.0))  # clipped exponential gate
    return q, k, v, z, log_f, i_gate, new_conv


def mlstm_apply(p: Mlstm, cfg, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[dict] = None):
    """mLSTM mixer of x (B, S, D): (out, new_cache).  Train and prefill run
    one chunk of min(2048, S) from a zero state; ``"prefill_resume"`` from
    ``cache["state"]`` (no new cache, as in the reference); decode (S = 1)
    steps from ``cache`` (its conv state the pad).  Prefill and decode
    return the new {"conv", "state"}, written into ``cache`` in place when
    given.  Over a mesh, each rank's rows (``mixer_on_local_rows``)."""
    if hasattr(x, "placements"):
        return mixer_on_local_rows(mlstm_apply, p, cfg, x, mode=mode, cache=cache)
    b, s, d = x.shape
    d_in = 2 * d
    dh = d_in // cfg.n_heads
    conv_state = cache["conv"] if (cache is not None and mode == "decode") else None
    q, k, v, z, log_f, i_gate, new_conv = _mlstm_qkv_gates(p, cfg, x, conv_state)

    # Fold the input gate into k; a ones column on v carries the normalizer.
    k = k * i_gate[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError(f"mlstm decode takes one token and a cache, got S {s}")
        y_aug, new_state = linear_attention_step(q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0],
                                                 cache["state"])
        y_aug = y_aug[:, None]
    else:
        state0 = cache["state"] if (cache is not None and mode == "prefill_resume") else None
        y_aug, new_state = chunked_linear_attention(q, k, v_aug, log_f, chunk=min(2048, s),
                                                    state0=state0)

    num, den = y_aug[..., :dh], y_aug[..., dh:]
    y = num / torch.clamp(torch.abs(den), min=1.0)
    y = y.reshape(b, s, d_in)
    y = rmsnorm(p.norm.scale, y, eps=cfg.norm_eps) * F.silu(z)
    out = y @ p.out_proj
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = write_cache(cache, {"conv": new_conv, "state": new_state})
    return out, new_cache


def mlstm_cache_init(cfg, batch: int, dtype, device=None) -> dict:
    """conv (B, 3, d_in) of ``dtype``, state (B, NH, dh, dh + 1) float32,
    zeros, on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    d_in = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = d_in // nh
    return {
        "conv": torch.zeros((batch, 3, d_in), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, dh, dh + 1), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class Slstm(torch.nn.Module):
    """w_in (d, 4 d) for z, i, f, o stacked; r (NH, dh, 4 dh) block-diagonal
    recurrent weights (drawn stacked, so fan-in NH, as the reference draws
    them); bias (4 d,) float32 (forget bias 3); norm; the post-FFN ffn_in
    (d, f) and ffn_out (f, d), f = 4 d / 3 rounded up to 128."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        d, nh, dt = cfg.d_model, cfg.n_heads, cfg.dtype
        dh = d // nh
        f_ff = int(4 * d / 3 + 127) // 128 * 128  # xLSTM pf = 4/3, tile-rounded
        self.w_in = param(gen, (d, 4 * d), dt)
        self.r = param(gen, (nh, dh, 4 * dh), dt)
        self.bias = param(gen, (4 * d,), torch.float32, fill=torch.cat(
            [torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)]))
        self.norm = RMSNorm(d, dt, gen)
        self.ffn_in = param(gen, (d, f_ff), dt)
        self.ffn_out = param(gen, (f_ff, d), dt, scale=f_ff**-0.5)


def slstm_apply(p: Slstm, cfg, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[dict] = None):
    """sLSTM of x (B, S, D): (out, new_cache).  The hidden-to-hidden
    recurrence is one call of ``ops.slstm_scan`` (the custom op
    ``repro_torch::slstm_scan``: one kernel launch on the card, a fake
    implementation under the dry run), in float32, from the cached {c, n,
    h, m} in decode and from zeros (n at 1e-6) otherwise.  Prefill and
    decode return the final state, written into ``cache`` in place when
    given.  Over a mesh, each rank's rows (``mixer_on_local_rows``)."""
    if hasattr(x, "placements"):
        return mixer_on_local_rows(slstm_apply, p, cfg, x, mode=mode, cache=cache)
    b, s, d = x.shape
    wx = (x @ p.w_in).to(torch.float32)  # (B, S, 4D)
    if cache is not None and mode == "decode":
        state = cache
    else:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = {"c": zeros, "n": zeros + 1e-6, "h": zeros, "m": zeros}
    hs, st = ops.slstm_scan(wx, p.r.to(torch.float32), p.bias, state)
    y = hs.to(x.dtype)  # (B, S, D)
    y = rmsnorm(p.norm.scale, y, eps=cfg.norm_eps)
    y = y + activation("gelu")(y @ p.ffn_in) @ p.ffn_out
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = write_cache(cache, st)
    return y, new_cache


def slstm_cache_init(cfg, batch: int, dtype, device=None) -> dict:
    """c, h, m zeros and n 1e-6, each (B, d) float32, on ``device``
    (``None``: the card); ``dtype`` is unused, as in the reference."""
    device = resolve_device(device)
    zeros = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": zeros, "n": zeros + 1e-6, "h": zeros.clone(), "m": zeros.clone()}
