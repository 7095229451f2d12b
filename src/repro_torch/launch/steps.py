"""Step functions of the port: twins of ``repro.launch.steps``'s
``make_prefill_step``, ``make_decode_step`` and ``make_embed_step`` on one
device (``mesh=None``).

Each maker returns a plain function over the model and its inputs, as the
reference's return functions that ``jax.jit`` takes.  The steps run without
autograd; a prefill or decode step consumes the cache it is handed (written
in place) and returns it.

  prefill_step(model, tokens, cache, frontend=None) -> (logits, cache)
  decode_step(model, tokens, positions, cache) -> (next_token int32 (B,),
                                                   logits (B, V), cache)
  embed_step(model, tokens, seg_ids) -> (B, n_segments, d) float32

A mesh (the reference's sharded steps) raises, naming its ROADMAP item;
the train and Ising-solve steps are not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.common import not_ported


def _one_device(mesh, what: str) -> None:
    if mesh is not None:
        raise not_ported(f"{what} over a mesh", "queue 3: mesh")


def make_prefill_step(cfg, mesh=None):
    _one_device(mesh, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(model, tokens, cache, frontend=None):
        return M.prefill(cfg, model, tokens, cache, frontend=frontend)

    return prefill_step


def make_decode_step(cfg, mesh=None):
    """Greedy decoding: the next token is the argmax of the last logits."""
    _one_device(mesh, "make_decode_step")

    @torch.no_grad()
    def decode_step(model, tokens, positions, cache):
        logits, cache = M.decode_step(cfg, model, tokens, positions, cache)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


def make_embed_step(cfg, n_segments: int, mesh=None):
    """The paper's bridge: backbone -> per-sentence embeddings (mu/beta feed)."""
    _one_device(mesh, "make_embed_step")

    @torch.no_grad()
    def embed_step(model, tokens, seg_ids):
        return M.embed_sentences(cfg, model, tokens, seg_ids, n_segments)

    return embed_step

