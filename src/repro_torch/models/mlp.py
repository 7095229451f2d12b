"""MLPs (SwiGLU / GeGLU / plain): twins of ``repro.models.mlp``'s
``mlp_init`` (the :class:`Mlp` module) and ``mlp_apply``.  Mixture-of-experts
is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

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
    h = x @ p.w_in
    if cfg.gated_mlp:
        h = act(x @ p.w_gate) * h
    else:
        h = act(h)
    return h @ p.w_out
