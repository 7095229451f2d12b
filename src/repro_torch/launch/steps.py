"""Step functions of the port and their input specs and shardings: twins of
``repro.launch.steps``.

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
and returns it.

``mesh=None`` or ``launch.mesh.make_host_mesh()`` runs on one device.  A
``DeviceMesh`` (``launch.mesh.make_mesh`` / ``make_production_mesh``) runs
the step sharded, as the reference's ``jax.jit`` with ``step_shardings``
does: the step distributes the model's parameters (in place: they become
``DTensor`` parameters), the optimizer state and the cache (their leaves
replaced in their dicts) and the batch by those shardings, then runs its
body under ``distributed.context.activation_mesh(mesh)``.  Inputs arrive
as global values, the same on every rank; the train step's metrics come
back as plain replicated tensors, the other steps' outputs as ``DTensor``s.

``params_spec``, ``opt_state_spec``, ``cache_spec`` and ``input_specs`` are
the reference's ``ShapeDtypeStruct`` stand-ins: trees of ``meta`` tensors,
with shapes and dtypes and no storage.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import activation_mesh, constrain
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import model as M
from repro_torch.models.common import (
    leaf_parts,
    map_parts,
    tree_items,
    tree_unflatten,
)
from repro_torch.train import optimizer as opt


def _device_mesh(mesh, what: str):
    """The ``DeviceMesh`` to shard over, or None for one device."""
    if mesh is None or isinstance(mesh, HostMesh):
        return None
    if hasattr(mesh, "mesh_dim_names"):
        return mesh
    raise TypeError(f"{what}: a mesh is None, a HostMesh or a DeviceMesh, not "
                    f"{type(mesh).__name__}")


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


# ---------------------------------------------------------------------------
# Placing a step's inputs on a mesh
# ---------------------------------------------------------------------------


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _placed(t, sh: shd.NamedSharding):
    """``t`` as the ``DTensor`` of ``sh`` (itself if it already is one)."""
    if _is_dtensor(t) and list(t.placements) == sh.placements():
        return t
    return sh.distribute(t)


def distribute_model(model: torch.nn.Module, mesh, *, serve: bool = False) -> torch.nn.Module:
    """Replace each parameter of ``model`` by the ``DTensor`` parameter of
    its ``param_sharding`` (frozen, as the model's parameters are), in
    place; parameters already so placed are kept.  Returns the model."""
    tree = M.param_tree(model)
    shardings = shd.param_sharding(tree, mesh, serve=serve)
    by_param = {id(p): s for (_, leaf), (_, sh) in zip(tree_items(tree), tree_items(shardings))
                for p, s in zip(leaf_parts(leaf), leaf_parts(sh))}
    for module in model.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            placed = _placed(p if _is_dtensor(p) else p.data, by_param[id(p)])
            if placed is not p:
                setattr(module, name, torch.nn.Parameter(placed, requires_grad=False))
    return model


def place_tree(tree: dict, shardings: dict) -> dict:
    """Replace each tensor of a dict tree (an optimizer state, a cache) by
    the ``DTensor`` of its sharding, in place (the dicts are kept; tensors
    already so placed are kept); returns the tree."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            place_tree(sub, shardings[name])
        else:
            tree[name] = map_parts(lambda pair: _placed(*pair), shd.zip_parts(sub, shardings[name]))
    return tree


def _batch_sharding(mesh, rows: int, rank: int) -> shd.NamedSharding:
    """Rows over (pod, data) where they divide, else replicated."""
    if rows % shd.dp_size(mesh) == 0:
        return shd.batch_sharding(mesh, rank)
    return shd.NamedSharding(mesh, (None,) * rank)


def _strip_batch(sh: shd.NamedSharding) -> shd.NamedSharding:
    return shd.NamedSharding(sh.mesh, tuple(
        None if p in (("pod", "data"), ("data",), "data") else p for p in sh.spec))


def _cache_shardings(cfg, cache: dict, mesh, rows: int) -> dict:
    c_sh = shd.cache_sharding(cache, mesh, n_kv_heads=cfg.n_kv_heads)
    if rows % shd.dp_size(mesh):
        # Replicate the cache's batch dims too; only model-axis sharding survives.
        c_sh = tree_unflatten(c_sh, [_strip_batch(s) for _, s in tree_items(c_sh)])
    return c_sh


def _full(t):
    """A ``DTensor``'s global value as a plain tensor (others as they are)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg, opt_cfg: opt.OptConfig, mesh=None):
    """Microbatched (gradient-accumulation) train step: ``cfg.microbatch``
    slices of the batch's rows, each's gradients added in float32 as
    ``g / microbatch`` (and its loss as ``loss / microbatch``), then one
    AdamW update.  The batch (numpy or tensors: tokens, targets, and
    frontend where the family takes one) moves to the model's device.
    Gradients come from ``torch.autograd.grad``, so no ``.grad`` is left on
    the model.  Over a ``DeviceMesh`` each microbatch's rows shard over
    (pod, data) where they divide, and each gradient is placed as its
    parameter before it is added."""
    dmesh = _device_mesh(mesh, "make_train_step")

    def train_step(model, opt_state, batch):
        if dmesh is not None:
            distribute_model(model, dmesh)
        tree = M.param_tree(model)
        if dmesh is not None:
            place_tree(opt_state, shd.opt_state_sharding(
                opt_state, shd.param_sharding(tree, dmesh), dmesh))
        leaves = [p for _, leaf in tree_items(tree) for p in leaf_parts(leaf)]
        device = (leaves[0].to_local() if dmesh is not None else leaves[0]).device
        batch = {k: torch.as_tensor(_full(v), device=device) for k, v in batch.items()}
        mb = cfg.microbatch
        rows = batch["tokens"].shape[0]
        if rows % mb:
            raise ValueError(f"a batch of {rows} rows does not split into {mb} microbatches")
        size = rows // mb
        with activation_mesh(dmesh):
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss_acc = torch.zeros((), dtype=torch.float32, device=device)
            with _trainable(leaves):
                for i in range(mb):
                    part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                    if dmesh is not None:
                        part = {k: _batch_sharding(dmesh, size, v.dim()).distribute(v)
                                for k, v in part.items()}
                    loss, _ = M.train_loss(cfg, model, part)
                    if dmesh is not None:  # one value on every rank before the backward
                        loss = loss.redistribute(dmesh, shd.replicated(dmesh).placements())
                    grads = torch.autograd.grad(loss, leaves)
                    for a, g, p in zip(acc, grads, leaves):
                        if dmesh is not None:
                            g = g.redistribute(dmesh, p.placements)
                        a.add_(g.to(torch.float32) / mb)
                    loss_acc = loss_acc + loss.detach() / mb
            it = iter(acc)
            grads = tree_unflatten(tree, [map_parts(lambda _: next(it), leaf)
                                          for _, leaf in tree_items(tree)])
            model, opt_state, metrics = opt.apply_updates(model, grads, opt_state, opt_cfg)
        metrics["loss"] = loss_acc
        return model, opt_state, {k: _full(v) for k, v in metrics.items()}

    return train_step


def place_inference_inputs(cfg, dmesh, model, serve_params, tokens, cache=None, extra=()):
    """Place an inference step's model, tokens (and ``extra`` tensors of
    the same rows) and cache on the mesh: [tokens, *extra] as ``DTensor``s
    (the model and the cache in place)."""
    distribute_model(model, dmesh, serve=serve_params)
    device = leaf_parts(tree_items(M.param_tree(model))[0][1])[0].to_local().device
    tokens = torch.as_tensor(_full(tokens), device=device)
    rows = tokens.shape[0]
    placed = [_placed(tokens, _batch_sharding(dmesh, rows, tokens.dim()))]
    for t in extra:
        t = torch.as_tensor(_full(t), device=device)
        placed.append(_placed(t, _batch_sharding(dmesh, rows, t.dim())))
    if cache is not None:
        place_tree(cache, _cache_shardings(cfg, cache, dmesh, rows))
    return placed


def make_prefill_step(cfg, mesh=None, *, serve_params: bool = False):
    """``serve_params``: TP-only weights over a mesh (the reference's
    ``step_shardings(serve_params=True)``)."""
    dmesh = _device_mesh(mesh, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(model, tokens, cache, frontend=None):
        if dmesh is not None:
            extra = () if frontend is None else (frontend,)
            tokens, *rest = place_inference_inputs(cfg, dmesh, model, serve_params, tokens, cache,
                                              extra)
            frontend = rest[0] if rest else None
        with activation_mesh(dmesh):
            return M.prefill(cfg, model, tokens, cache, frontend=frontend)

    return prefill_step


def make_decode_step(cfg, mesh=None, *, serve_params: bool = False):
    """Greedy decoding: the next token is the argmax of the last logits."""
    dmesh = _device_mesh(mesh, "make_decode_step")

    @torch.no_grad()
    def decode_step(model, tokens, positions, cache):
        if dmesh is not None:
            tokens, positions = place_inference_inputs(cfg, dmesh, model, serve_params, tokens,
                                                  cache, (positions,))
        with activation_mesh(dmesh):
            logits, cache = M.decode_step(cfg, model, tokens, positions, cache)
            # The argmax reads whole rows: over a mesh the vocab is gathered.
            next_token = torch.argmax(constrain(logits, "batch", None), dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


def make_embed_step(cfg, n_segments: int, mesh=None, *, serve_params: bool = False):
    """The paper's bridge: backbone -> per-sentence embeddings (mu/beta feed)."""
    dmesh = _device_mesh(mesh, "make_embed_step")

    @torch.no_grad()
    def embed_step(model, tokens, seg_ids):
        if dmesh is not None:
            tokens, seg_ids = place_inference_inputs(cfg, dmesh, model, serve_params, tokens,
                                                extra=(seg_ids,))
        with activation_mesh(dmesh):
            return M.embed_sentences(cfg, model, tokens, seg_ids, n_segments)

    return embed_step


def make_ising_solve_step(*, steps: int = 1000, dt: float = 0.35, ks_max: float = 1.2,
                          mesh=None):
    """Fleet-scale COBI simulation: D documents' instances, R oscillator
    anneals each, on the given h and J (no normalisation, as the
    reference's step).  Two launches a call, where the reference runs plain
    XLA: the batched trajectory kernel (``ops.cobi_trajectory_batch``),
    then the spins' sign and the batched energy kernel
    (``ops.ising_energy``); each document's best read is its first argmin.
    With a ``DeviceMesh`` the step is ``distributed.fleet``'s solver:
    documents over (pod, data), replicas over model, the cross-replica
    reduction and the gather by explicit collectives."""
    dmesh = _device_mesh(mesh, "make_ising_solve_step")
    if dmesh is not None:
        from repro_torch.distributed.fleet import make_fleet_solver

        return make_fleet_solver(dmesh, steps=steps, dt=dt, ks_max=ks_max)

    @torch.no_grad()
    def ising_solve_step(h, j, phi0):
        phi = ops.cobi_trajectory_batch(j, h, phi0, steps=steps, dt=dt, ks_max=ks_max)
        spins = kref.ref_cobi_spins(phi)  # (D, R, N) int8
        e = ops.ising_energy(spins, h, j)  # (D, R)
        best = torch.argmin(e, dim=1)  # the first of equal minima
        docs = torch.arange(h.shape[0], device=h.device)
        return spins[docs, best], e[docs, best]

    return ising_solve_step


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; no storage)
# ---------------------------------------------------------------------------


def params_spec(cfg) -> dict:
    """The model's parameter tree (``models.param_tree``) on ``meta``."""
    with torch.device("meta"):
        return M.param_tree(M.Model(cfg))


def opt_state_spec(cfg, opt_cfg: Optional[opt.OptConfig] = None) -> dict:
    return opt.init(params_spec(cfg), opt_cfg)


def cache_spec(cfg, batch: int, max_len: int) -> dict:
    return M.init_cache(cfg, batch, max_len, device="meta")


def input_specs(cfg, cell: ShapeCell, opt_cfg: Optional[opt.OptConfig] = None) -> dict:
    """All step inputs for one (arch x shape) cell, as ``meta`` tensors."""
    b, s = cell.global_batch, cell.seq_len

    def tok(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    def frontend():
        return torch.empty((b, cfg.n_frontend_tokens, cfg.d_model), dtype=cfg.dtype,
                           device="meta")

    out = {"params": params_spec(cfg)}
    if cell.kind == "train":
        batch = {"tokens": tok((b, s)), "targets": tok((b, s))}
        if cfg.n_frontend_tokens:
            batch["frontend"] = frontend()
        out.update(opt_state=opt_state_spec(cfg, opt_cfg), batch=batch)
    elif cell.kind == "prefill":
        out.update(tokens=tok((b, s)), cache=cache_spec(cfg, b, s))
        if cfg.n_frontend_tokens:
            out["frontend"] = frontend()
    elif cell.kind == "decode":
        out.update(tokens=tok((b, 1)), positions=tok((b, 1)), cache=cache_spec(cfg, b, s))
    else:
        raise ValueError(cell.kind)
    return out


def step_shardings(cfg, cell: ShapeCell, mesh, *, serve_params: bool = False,
                   opt_cfg: Optional[opt.OptConfig] = None):
    """(in_shardings, out_shardings) trees per cell kind, of
    :class:`distributed.sharding.NamedSharding`: the reference's, with each
    stacked parameter leaf a list of its per-layer tensors' shardings."""
    specs = input_specs(cfg, cell, opt_cfg)
    p_sh = shd.param_sharding(specs["params"], mesh,
                              serve=serve_params and cell.kind != "train")
    rep = shd.replicated(mesh)
    batch_ok = cell.global_batch % shd.dp_size(mesh) == 0

    def bs(rank):
        return _batch_sharding(mesh, cell.global_batch, rank)

    if cell.kind == "train":
        o_sh = shd.opt_state_sharding(specs["opt_state"], p_sh, mesh)
        batch_sh = {"tokens": bs(2), "targets": bs(2)}
        if "frontend" in specs["batch"]:
            batch_sh["frontend"] = bs(3)
        return (p_sh, o_sh, batch_sh), (p_sh, o_sh, {"loss": rep, "grad_norm": rep, "lr": rep})
    c_sh = _cache_shardings(cfg, specs["cache"], mesh, cell.global_batch)
    dp = shd.axes_entry(shd.dp_axes(mesh)) if batch_ok else None
    if cell.kind == "prefill":
        in_sh = [p_sh, bs(2), c_sh]
        if "frontend" in specs:
            in_sh.append(bs(3))
        return tuple(in_sh), (shd.NamedSharding(mesh, (dp, None, "model")), c_sh)
    # decode
    logits_sh = shd.NamedSharding(mesh, (dp, "model"))
    return (p_sh, bs(2), bs(2), c_sh), (shd.NamedSharding(mesh, (dp,)), logits_sh, c_sh)
