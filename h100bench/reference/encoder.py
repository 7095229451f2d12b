"""Plain PyTorch forward of the dense causal sentence encoder, in float32
with TF32 off: byte tokens packed with separators, the whole stack, then
per-sentence mean pooling of the last layer's states, unit rows.

It follows the configuration file: token embedding times sqrt(d) (rounded
to the serving type, as the model defines it), then per layer RMSNorm ->
q, k, v -> rotary positions -> causal softmax attention -> output
projection, residual; RMSNorm -> SiLU-gated MLP, residual.  No final norm
before pooling.

``quant`` is the control: the same forward with every tensor the model
holds in its serving type (weights, the residual stream, each norm's,
projection's and attention's output) rounded one precision lower: to
float8 e4m3 under one scale a tensor (``"fp8"``, below bf16), or to
bfloat16 (``"bf16"``, below float32).  Softmax, norms and sums stay float32,
as the model computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4
E4M3_MAX = 448.0


def pack_sentences(sentences, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, segment ids) of one document, unpadded: BOS, then each
    sentence's UTF-8 bytes (offset by the 4 special ids) and a SEP; segment
    -1 on the specials; cut at ``max_len`` tokens, so sentences past the cut
    get no tokens."""
    toks, segs = [BOS], [-1]
    for si, s in enumerate(sentences):
        ids = [b + N_SPECIAL for b in s.encode("utf-8")]
        toks.extend(ids + [SEP])
        segs.extend([si] * len(ids) + [-1])
    return np.asarray(toks[:max_len], np.int64), np.asarray(segs[:max_len], np.int64)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its absolute max to
    448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (S, H, D), halves rotated."""
    s, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed_document(sizes: dict, weights: dict, sentences, quant: str | None = None
                   ) -> torch.Tensor:
    """(len(sentences), d) unit-norm float32 embeddings of one document; a
    sentence the context cut off entirely gets a zero row."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _embed(sizes, weights, sentences, quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _embed(sizes, weights, sentences, quant):
    d, h = sizes["hidden_size"], sizes["num_attention_heads"]
    hd, eps, theta = d // h, sizes["layer_norm_eps"], sizes["rope_theta"]
    rounders = {None: lambda t: t, "fp8": _fp8,
                "bf16": lambda t: t.to(torch.bfloat16).to(torch.float32)}
    if quant not in rounders:
        raise ValueError(f"unknown control precision {quant!r}")
    hold = rounders[quant]

    def w(name):
        return hold(weights[name].to(torch.float32))

    device = weights["embed"].device
    tokens, segs = pack_sentences(sentences, sizes["max_len"])
    tokens = torch.from_numpy(tokens).to(device)
    # sqrt(d) in the serving type, as the model takes it (27.75 in bf16 at d 768).
    scale = float(torch.tensor(math.sqrt(d), dtype=getattr(torch, sizes["dtype"])))
    x = hold(w("embed")[tokens] * scale)
    s = x.shape[0]
    causal = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    for i in range(sizes["num_hidden_layers"]):
        p = f"layers.{i}."
        hn = hold(_rmsnorm(x, eps))
        q = hold(_rope(hold(hn @ w(p + "wq")).view(s, h, hd), theta))
        k = hold(_rope(hold(hn @ w(p + "wk")).view(s, h, hd), theta))
        v = hold(hn @ w(p + "wv")).view(s, h, hd)
        logits = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
        probs = torch.softmax(logits.masked_fill(~causal, -math.inf), dim=-1)
        attn = hold(torch.einsum("hqk,khd->qhd", probs, v).reshape(s, d))
        x = hold(x + hold(attn @ w(p + "wo")))
        hn = hold(_rmsnorm(x, eps))
        gated = hold(hold(torch.nn.functional.silu(hold(hn @ w(p + "w_gate"))))
                     * hold(hn @ w(p + "w_in")))
        x = hold(x + hold(gated @ w(p + "w_out")))
    segs = torch.from_numpy(segs).to(device)
    n = len(sentences)
    onehot = (segs[:, None] == torch.arange(n, device=device)).to(torch.float32)
    pooled = (onehot.T @ x) / onehot.sum(0).clamp(min=1.0)[:, None]
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)
