"""Blocked online-softmax attention: the CUDA kernel's wrapper and its plain
version.

Port of ``repro.kernels.flash_attention.flash_attention`` (the Pallas kernel
``_fa_kernel``): causal mask, sliding window and GQA head mapping, q
(B, Sq, H, D) against k and v (B, Skv, KV, D), heads third as in the
reference, float32 or bfloat16.

  * :func:`flash_attention_plain` follows ``_fa_kernel`` block for block:
    kv blocks of ``block_k`` in order, m, l and acc in float32, scores as a
    float32 product times ``D**-0.5``, masked scores at ``NEG_INF`` (not
    -inf), p rounded to v's type before the PV product, the output
    ``acc / max(l, 1e-30)`` in q's type.  Query blocks do not enter: each
    query row's state is its own, so all rows are done at once.
  * :func:`flash_attention_cuda` launches one of the two kernels of
    ``csrc/flash_attention.cu`` on a CUDA tensor (or raises) and runs the
    plain version on a CPU tensor; :func:`route` picks the kernel from the
    type and head dim.  bf16 at a padded D of 64 or 128 takes
    ``flash_attention_wgmma`` (tensor cores, 128-key tiles: the plain
    version's blocks, so the two differ only in float32 rounding: the
    products' summation order, exp as the card's exp2 of a score scaled by
    log2 e, and the output scaled by the reciprocal of l);
    float32, and bf16 at D 16 or 32, take ``flash_attention_tf32``, the
    tensor cores' TF32 ``mma.sync`` with float32 operands split in three
    products (big·big + big·small + small·big, CUTLASS's 3xTF32), which
    keep float32's grade; bf16 is exact in TF32 and takes one.  Its tiles
    are 128 keys at D 16 and 32 (the plain version's blocks, so bf16's p
    is rounded against the same running max) and 64 at D 64 and 128.  It
    counts its launches in ``.launches`` and, by route, in
    ``.route_launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the kernels'; other D <= 128 (zamba2's 80) pad up to one
WGMMA_HEAD_DIMS = (64, 128)
# The kernels' names as a profiler reports them (substrings of the mangled
# names), one per route: "tf32", then "wgmma".
KERNEL_NAMES = ("flash_attention_tf32_kernel", "flash_attention_wgmma_kernel")


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run at: the least of HEAD_DIMS >= d."""
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"head dim {d} > {HEAD_DIMS[-1]}: the kernels hold at most 128")
    return next(x for x in HEAD_DIMS if x >= d)


def route(dtype, d: int) -> str:
    """The kernel that takes q of this type and head dim: "wgmma" for bf16
    at a padded D of 64 or 128, else "tf32" (float32 at any D, as three
    TF32 products an operand pair, and bf16 at D 16 or 32, as one)."""
    dp = padded_head_dim(d)
    return "wgmma" if dtype == torch.bfloat16 and dp in WGMMA_HEAD_DIMS else "tf32"


def _blocks(q, k, v, block_q: int, block_k: int) -> tuple[int, int]:
    """The reference's preconditions; returns (bq, bk)."""
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    skv, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads do not share {kvh} kv heads evenly")
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"sequence lengths ({sq}, {skv}) do not tile into blocks ({bq}, {bk})")
    return bq, bk


def flash_attention_plain(q, k, v, *, causal=True, window=None, block_q=128, block_k=128):
    """Plain version: (B, Sq, H, D) in q's type, kv block by kv block."""
    _, bk = _blocks(q, k, v, block_q, block_k)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = d**-0.5
    qf = q.to(torch.float32).reshape(b, sq, kvh, rep, d).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # (B, KV, 1, Skv, D)
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((b, kvh, rep, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, rep, sq, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    for k0 in range(0, skv, bk):
        s = torch.matmul(qf, kf[..., k0:k0 + bk, :].transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
        mask = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          vt[..., k0:k0 + bk, :].to(torch.float32))
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal=True, window=None):
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, KV, D): the kernel on
    a CUDA tensor, the plain version on a CPU tensor.  Both hold the
    reference's preconditions at its default 128-row tiles."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_cuda launches its kernel on CUDA tensors and runs its plain "
            f"version on CPU tensors; got a {q.device.type} tensor"
        )
    _blocks(q, k, v, 128, 128)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16) or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"kernel wants float32 or bfloat16 q, k, v of one type; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must lie on one device")
    dp = padded_head_dim(d)
    if dp != d:  # zero columns change no dot product; the output's are cut off
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    # Both kernels read rows in 16-byte pieces: a view that starts off that
    # alignment is copied.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    window_args = (int(window is not None), int(window) if window is not None else 0, d**-0.5)
    kind = route(dt, d)
    if kind == "wgmma":
        err = lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, dp,
            int(causal), *window_args, _build.stream_of(q))
    else:
        err = lib.flash_attention_tf32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, dp,
            int(dt == torch.bfloat16), int(causal), *window_args, _build.stream_of(q))
    _build.check(err, f"flash_attention ({kind})")
    _build.count_launch(flash_attention_cuda, kind)
    return out[..., :d] if dp != d else out


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = {"tf32": 0, "wgmma": 0}
