"""MLPs (SwiGLU / GeGLU / plain) and Mixture-of-Experts with GShard-style
capacity dispatch: twins of ``repro.models.mlp``'s ``mlp_init`` (the
:class:`Mlp` module), ``mlp_apply``, ``moe_init`` (the :class:`Moe`
module), ``_route``, ``_expert_ffn`` and ``moe_apply`` (both dispatch
routes, ``cfg.moe_impl``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain, on_local_rows
from repro_torch.models.common import activation, param


class Mlp(torch.nn.Module):
    """w_in (d, f), w_out (f, d), and w_gate (d, f) when ``cfg.gated_mlp``."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None, d_ff: Optional[int] = None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        f = d_ff if d_ff is not None else cfg.d_ff
        self.w_in = param(gen, (d, f), dt)
        self.w_out = param(gen, (f, d), dt, scale=f**-0.5)
        if cfg.gated_mlp:
            self.w_gate = param(gen, (d, f), dt)


def mlp_apply(p: Mlp, cfg, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    h = constrain(x @ p.w_in, "batch", None, "model")
    if cfg.gated_mlp:
        h = act(x @ p.w_gate) * h
    else:
        h = act(h)
    return h @ p.w_out


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


class Moe(torch.nn.Module):
    """router (d, E) float32; the experts' w_in, w_gate (E, d, fe) and w_out
    (E, fe, d) stacked; with ``d_ff_shared`` a shared :class:`Mlp` and its
    gate shared_gate (d, 1).  The reference draws each expert alone (fan-in
    d, not E), so the stacked leaves take d's scale explicitly."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.moe
        d, fe, e, dt = cfg.d_model, m.d_ff_expert, m.num_experts, cfg.dtype
        self.router = param(gen, (d, e), torch.float32)
        self.w_in = param(gen, (e, d, fe), dt, scale=d**-0.5)
        self.w_gate = param(gen, (e, d, fe), dt, scale=d**-0.5)
        self.w_out = param(gen, (e, fe, d), dt, scale=fe**-0.5)
        if m.d_ff_shared:
            self.shared = Mlp(cfg, gen, d_ff=m.d_ff_shared)
            self.shared_gate = param(gen, (d, 1), dt)


def _route(p: Moe, cfg, x):
    """Shared router: (gate_vals, expert_idx, pos, keep, onehot, cap, aux).

    Each batch row routes its own tokens (capacity and slot positions count
    within the row), so a row's outputs never depend on its batch-mates
    (over a mesh each rank routes its own rows); the aux loss reads the
    whole batch."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    cap = int(m.capacity_factor * k * x.shape[1] / e) or 1
    probs, gate_vals, expert_idx, pos, keep, onehot = on_local_rows(
        lambda x, router: _route_rows(cfg, x, router, cap), x, weights=(p.router,))
    density = torch.mean(onehot.sum(2), dim=(0, 1))
    router_mean = torch.mean(probs, dim=(0, 1))
    aux = m.router_aux_weight * e * torch.sum(density / k * router_mean)
    return gate_vals, expert_idx, pos, keep, onehot, cap, aux


def _route_rows(cfg, x, router, cap):
    """The router's per-token part: (probs, gate_vals, expert_idx, pos,
    keep, onehot)."""
    b, s, _ = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = x.to(torch.float32) @ router  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; torch.topk promises
    # no order for ties, a stable descending sort does.
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]  # (B, S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(expert_idx, e).to(torch.float32)  # (B, S, k, E)
    flat = onehot.reshape(b, s * k, e)  # choices in priority order
    pos_in_e = torch.cumsum(flat, dim=1) - flat  # (B, S*k, E), exact integers
    pos = torch.sum(pos_in_e * flat, dim=-1).reshape(b, s, k).to(torch.int64)
    keep = pos < cap
    gate_vals = gate_vals * keep
    return probs, gate_vals, expert_idx, pos, keep, onehot


def _expert_ffn(p: Moe, cfg, xe):
    """xe: (B, E, C, D) -> (B, E, C, D) through per-expert gated MLP."""
    act = activation(cfg.act)
    hidden = act(torch.einsum("becd,edf->becf", xe, p.w_gate)) * torch.einsum(
        "becd,edf->becf", xe, p.w_in)
    hidden = constrain(hidden, "batch", None, None, "model")
    return torch.einsum("becf,efd->becd", hidden, p.w_out)


def _slots(expert_idx, pos, cap):
    """(batch row, expert, slot) index tensors of every choice (B, S, k);
    dropped choices point at slot cap - 1."""
    b = expert_idx.shape[0]
    bi = torch.arange(b, device=expert_idx.device)[:, None, None].expand(expert_idx.shape)
    return bi, expert_idx, torch.clamp(pos, max=cap - 1)


def _dispatch(x, slots, keep, e, cap):
    """Scatter each kept token into its (expert, slot) of a (B, E, cap, d)
    buffer in x's type.  Each slot receives one kept token (positions are
    a per-expert cumsum); a dropped choice adds x * 0, an exact zero, into
    slot cap - 1.  So the accumulating scatter's order, which CUDA does not
    fix, cannot change a sum."""
    b, _, d = x.shape
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    contrib = x[:, :, None, :] * keep[..., None].to(x.dtype)  # (B, S, k, D)
    return buf.index_put_(slots, contrib, accumulate=True)


def _combine(ye, slots, gate_vals, keep, dtype):
    """Gather each choice's expert output back and mix by its gate."""
    back = ye.to(torch.float32)[slots]  # (B, S, k, D)
    return torch.einsum("bskd,bsk->bsd", back, gate_vals * keep).to(dtype)


def moe_apply(p: Moe, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Two dispatch routes (``cfg.moe_impl``), as in the reference:
      * "scatter": tokens move by an accumulating scatter into the
        (B, E, C, D) buffer and a gather back; no dispatch products.
      * "einsum": GShard one-hot dispatch and combine products.
    """
    e = cfg.moe.num_experts
    gate_vals, expert_idx, pos, keep, onehot, cap, aux = _route(p, cfg, x)
    if cfg.moe_impl == "scatter":
        # Row by row (each rank's rows over a mesh).
        xe = on_local_rows(lambda x, i, q, kp: _dispatch(x, _slots(i, q, cap), kp, e, cap),
                           x, expert_idx, pos, keep)
        ye = _expert_ffn(p, cfg, xe)
        y = on_local_rows(lambda ye, i, q, g, kp: _combine(ye, _slots(i, q, cap), g, kp, x.dtype),
                          ye, expert_idx, pos, gate_vals, keep)
    else:
        pos_oh = F.one_hot(torch.clamp(pos, max=cap - 1), cap).to(torch.float32)
        pos_oh = pos_oh * keep[..., None]  # jax.nn.one_hot gives a zero row past cap
        dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_oh)
        combine = torch.einsum("bsec,bsk,bske->bsec", dispatch, gate_vals, onehot)
        xe = torch.einsum("bsd,bsec->becd", x.to(torch.float32), dispatch).to(x.dtype)
        xe = constrain(xe, "batch", None, None, None)
        ye = _expert_ffn(p, cfg, xe)
        y = torch.einsum("becd,bsec->bsd", ye.to(torch.float32), combine).to(x.dtype)
    if cfg.moe.d_ff_shared:
        sg = on_local_rows(lambda x, w: torch.sigmoid(x @ w).to(x.dtype), x,
                           weights=(p.shared_gate,))
        # Over a mesh the shared MLP's output (a partial sum over the model
        # axis) is reduced onto the batch layout first.
        y = y + sg * constrain(mlp_apply(p.shared, cfg, x), "batch", None, None)
    return y, aux
