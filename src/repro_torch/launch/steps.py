"""Step functions of the port: twins of ``repro.launch.steps``'s
``make_train_step``, ``make_prefill_step``, ``make_decode_step``,
``make_embed_step`` and ``make_ising_solve_step`` on one device
(``mesh=None``, or ``launch.mesh.make_host_mesh()``'s one-card stand-in).

Each maker returns a plain function over the model and its inputs, as the
reference's return functions that ``jax.jit`` takes.

  train_step(model, opt_state, batch) -> (model, opt_state,
                                          {"loss", "grad_norm", "lr"})
  prefill_step(model, tokens, cache, frontend=None) -> (logits, cache)
  decode_step(model, tokens, positions, cache) -> (next_token int32 (B,),
                                                   logits (B, V), cache)
  embed_step(model, tokens, seg_ids) -> (B, n_segments, d) float32
  ising_solve_step(h (D, N), j (D, N, N), phi0 (D, R, N))
      -> (best spins (D, N) int8, best energies (D,))

The train step updates the model and the optimizer state in place and
returns them; the prefill, decode and embed steps run without autograd, and
a prefill or decode step consumes the cache it is handed (written in place)
and returns it.  A mesh of more than one device (the reference's sharded
steps) raises, naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import MESH_ITEM, HostMesh
from repro_torch.models import model as M
from repro_torch.models.common import (
    leaf_parts,
    map_parts,
    not_ported,
    tree_items,
    tree_unflatten,
)
from repro_torch.train import optimizer as opt


def _one_device(mesh, what: str) -> None:
    if mesh is not None and not isinstance(mesh, HostMesh):
        raise not_ported(f"{what} over a mesh", MESH_ITEM)


@contextlib.contextmanager
def _trainable(params: list):
    """Gradients on for ``params`` inside the block, and off again after it
    (the model's weights stay frozen for inference)."""
    try:
        for p in params:
            p.requires_grad_(True)
        yield
    finally:
        for p in params:
            p.requires_grad_(False)


def make_train_step(cfg, opt_cfg: opt.OptConfig, mesh=None):
    """Microbatched (gradient-accumulation) train step: ``cfg.microbatch``
    slices of the batch's rows, each's gradients added in float32 as
    ``g / microbatch`` (and its loss as ``loss / microbatch``), then one
    AdamW update.  The batch (numpy or tensors: tokens, targets, and
    frontend where the family takes one) moves to the model's device.
    Gradients come from ``torch.autograd.grad``, so no ``.grad`` is left on
    the model."""
    _one_device(mesh, "make_train_step")

    def train_step(model, opt_state, batch):
        tree = M.param_tree(model)
        leaves = [p for _, leaf in tree_items(tree) for p in leaf_parts(leaf)]
        device = leaves[0].device
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        mb = cfg.microbatch
        rows = batch["tokens"].shape[0]
        if rows % mb:
            raise ValueError(f"a batch of {rows} rows does not split into {mb} microbatches")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        size = rows // mb
        with _trainable(leaves):
            for i in range(mb):
                part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                loss, _ = M.train_loss(cfg, model, part)
                grads = torch.autograd.grad(loss, leaves)
                for a, g in zip(acc, grads):
                    a.add_(g.to(torch.float32) / mb)
                loss_acc = loss_acc + loss.detach() / mb
        it = iter(acc)
        grads = tree_unflatten(tree, [map_parts(lambda _: next(it), leaf)
                                      for _, leaf in tree_items(tree)])
        model, opt_state, metrics = opt.apply_updates(model, grads, opt_state, opt_cfg)
        metrics["loss"] = loss_acc
        return model, opt_state, metrics

    return train_step


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


def make_ising_solve_step(*, steps: int = 1000, dt: float = 0.35, ks_max: float = 1.2):
    """Fleet-scale COBI simulation: D documents' instances, R oscillator
    anneals each, on the given h and J (no normalisation, as the
    reference's step).  Two launches a call, where the reference runs plain
    XLA: the batched trajectory kernel (``ops.cobi_trajectory_batch``),
    then the spins' sign and the batched energy kernel
    (``ops.ising_energy``); each document's best read is its first argmin.
    The reference shards documents over (pod, data) and replicas over
    model (ROADMAP's mesh item); here they run on h's device."""

    @torch.no_grad()
    def ising_solve_step(h, j, phi0):
        phi = ops.cobi_trajectory_batch(j, h, phi0, steps=steps, dt=dt, ks_max=ks_max)
        spins = kref.ref_cobi_spins(phi)  # (D, R, N) int8
        e = ops.ising_energy(spins, h, j)  # (D, R)
        best = torch.argmin(e, dim=1)  # the first of equal minima
        docs = torch.arange(h.shape[0], device=h.device)
        return spins[docs, best], e[docs, best]

    return ising_solve_step
