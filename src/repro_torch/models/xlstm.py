"""xLSTM blocks in train mode: twins of ``repro.models.xlstm``'s mLSTM
(matrix memory, chunk-parallel through the SSD core; ``mlstm_init`` is the
:class:`Mlstm` module, ``mlstm_apply``) and sLSTM (scalar memory with a
hidden-to-hidden recurrence, a loop over time; :class:`Slstm`,
``slstm_apply``).

As in the reference, the mLSTM input gate is a clipped exponential and
the normalizer rides the same chunked recurrence as an extra value column
(exact).  The caches wait for ROADMAP queue 1 (prefill and decode caches).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import RMSNorm, activation, causal_conv1d, param, rmsnorm
from repro_torch.models.ssd import chunked_linear_attention

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


def _mlstm_qkv_gates(p: Mlstm, cfg, x):
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = 2 * d // nh
    x_in, z = torch.chunk(x @ p.in_proj, 2, dim=-1)
    xc = F.silu(causal_conv1d(x_in, p.conv_w))
    q = (xc @ p.wq).reshape(b, s, nh, dh)
    k = (xc @ p.wk).reshape(b, s, nh, dh) * (dh**-0.5)
    v = (x_in @ p.wv).reshape(b, s, nh, dh)
    gates = x_in.to(torch.float32) @ p.w_gates + p.gate_bias
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)  # (B, S, NH)
    log_f = F.logsigmoid(f_raw)  # <= 0, exact
    i_gate = torch.exp(torch.clamp(i_raw, -15.0, 5.0))  # clipped exponential gate
    return q, k, v, z, log_f, i_gate


def mlstm_apply(p: Mlstm, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train-mode mLSTM mixer of x (B, S, D): one chunk of min(2048, S)."""
    b, s, d = x.shape
    d_in = 2 * d
    dh = d_in // cfg.n_heads
    q, k, v, z, log_f, i_gate = _mlstm_qkv_gates(p, cfg, x)

    # Fold the input gate into k; a ones column on v carries the normalizer.
    k = k * i_gate[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y_aug, _ = chunked_linear_attention(q, k, v_aug, log_f, chunk=min(2048, s))

    num, den = y_aug[..., :dh], y_aug[..., dh:]
    y = num / torch.clamp(torch.abs(den), min=1.0)
    y = y.reshape(b, s, d_in)
    y = rmsnorm(p.norm.scale, y, eps=cfg.norm_eps) * F.silu(z)
    return y @ p.out_proj


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


def slstm_apply(p: Slstm, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train-mode sLSTM of x (B, S, D): the hidden-to-hidden recurrence is
    serial, a Python loop over S in float32."""
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    wx = (x @ p.w_in).to(torch.float32)  # (B, S, 4D)
    r = p.r.to(torch.float32)
    c = h = m = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    n = c + 1e-6
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, dh), r).reshape(b, 4 * d)
        pre = wx[:, t] + rec + p.bias
        z_r, i_r, f_r, o_r = torch.chunk(pre, 4, dim=-1)
        z = torch.tanh(z_r)
        log_f = F.logsigmoid(f_r)
        m_new = torch.maximum(log_f + m, i_r)
        i_g = torch.exp(i_r - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, D)
    y = rmsnorm(p.norm.scale, y, eps=cfg.norm_eps)
    return y + activation("gelu")(y @ p.ffn_in) @ p.ffn_out
