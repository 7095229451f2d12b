"""The port's training path through the model on the CPU, held against the
JAX package: ``train_loss`` and every gradient leaf of every registered
config at ``.reduced()`` against ``jax.value_and_grad`` of the reference's,
``launch.steps.make_train_step`` over three steps from the same weights and
optimizer state, remat against no remat, and the flash route's refusal
under grad.  Weights cross with ``carry_across("params")`` (the
zero-initialised gates, biases and ``dt_bias`` drawn non-zero first, as in
test_torch_families.py), optimizer state with ``carry_across("opt")``.

Bars: loss and gradients within 2e-4 in float32 (the reference's own
flash-vs-sdpa bound, as for ``forward``), the MoE routers' choices equal;
the train step's loss, grad norm, weights and state within 2e-4 and its
``lr`` equal; remat's gradients bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.launch import steps as tsteps
from repro_torch.models import mlp as tmlp
from repro_torch.models import param_tree, train_loss
from repro_torch.models.common import (
    leaf_parts,
    map_parts,
    stacked_shape,
    tree_items,
    tree_unflatten,
)
from repro_torch.train import optimizer as topt

NAMES = sorted(REGISTRY)
TOL = 2e-4
B, S = 2, 32
ZERO_AT_INIT = ("gate", "ffn_gate", "bq", "bk", "bv", "dt_bias")


def _pair(name, seed=1, **replace):
    """(reference cfg, params), (port cfg, model) on the same weights, the
    zero-initialised leaves drawn non-zero."""
    jcfg = jget_config(name).reduced().replace(**replace)
    tcfg = get_config(name).reduced().replace(**replace)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if path[-1].key not in ZERO_AT_INIT:
            return x
        return jnp.asarray(0.7 * rng.standard_normal(x.shape) + 0.3, x.dtype)

    jparams = jax.tree_util.tree_map_with_path(perturb, jinit_params(jcfg, jax.random.key(seed)))
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    return (jcfg, jparams), (tcfg, carry_across("params", tree, cfg=tcfg, device="cpu"))


def _batch(cfg, rows=B, seed=2):
    """tokens and targets (a masked tail of -1 in the last row), and the
    frontend where the family takes one."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(np.int32)
    targets = tokens[:, 1:].copy()
    targets[-1, -5:] = -1
    batch = {"tokens": tokens[:, :-1], "targets": targets}
    if cfg.n_frontend_tokens:
        batch["frontend"] = rng.standard_normal(
            (rows, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _stacked(tree):
    """A port parameter tree as the reference's: (name, stacked numpy)."""
    return [("/".join(path), np.stack([t.detach().numpy() for t in leaf_parts(leaf)]).reshape(
        stacked_shape(leaf))) for path, leaf in tree_items(tree)]


def _reference_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), np.asarray(x, np.float32)) for path, x in flat]


def _close_trees(got, want, tol=TOL):
    got, want = _stacked(got), _reference_leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a.astype(np.float32), b, rtol=tol, atol=tol, err_msg=key)


def _port_grads(cfg, model, batch):
    """(loss + aux, loss, the gradient tree) of the port's train_loss."""
    tree = param_tree(model)
    leaves = [p for _, leaf in tree_items(tree) for p in leaf_parts(leaf)]
    with tsteps._trainable(leaves):
        total, loss = train_loss(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    return total.detach(), loss.detach(), tree_unflatten(
        tree, [map_parts(lambda _: next(it), leaf) for _, leaf in tree_items(tree)])


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_grads_match_reference(name, monkeypatch):
    """train_loss and the gradient of (loss + aux) with respect to every
    leaf, the routers' choices equal (taken from the reference's traced
    scan by a debug callback)."""
    (jcfg, jparams), (tcfg, model) = _pair(name)
    batch = _batch(tcfg)
    j_seen, t_seen = [], []
    j_route, t_route = jmlp._route, tmlp._route

    def j_spy(p, c, x):
        res = j_route(p, c, x)
        jax.debug.callback(lambda idx: j_seen.append(np.asarray(idx)), res[1])
        return res

    def t_spy(p, c, x):
        res = t_route(p, c, x)
        t_seen.append(res[1].numpy().copy())
        return res

    monkeypatch.setattr(jmlp, "_route", j_spy)
    monkeypatch.setattr(tmlp, "_route", t_spy)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_total, j_loss), j_grads = jax.value_and_grad(
        lambda p: jmodel.train_loss(jcfg, p, jbatch), has_aux=True)(jparams)
    jax.effects_barrier()
    total, loss, grads = _port_grads(tcfg, model, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(total), float(j_total), rtol=TOL, atol=TOL)
    _close_trees(grads, j_grads)
    assert len(t_seen) == len(j_seen)
    for a, b in zip(t_seen, j_seen):
        np.testing.assert_array_equal(a, b)
    if tcfg.moe:
        assert t_seen and float(total) > float(loss)  # the aux loss is added


def test_train_step_matches_reference_over_three_steps():
    """make_train_step with microbatch 2, three steps from the same weights
    and optimizer state (the reference's carried across): loss, grad norm,
    lr, weights and every state leaf."""
    (jcfg, jparams), (tcfg, model) = _pair("tinyllama-1.1b", microbatch=2)
    opt_cfg = jopt.OptConfig(warmup_steps=2, total_steps=10, peak_lr=1e-2)
    jstate = jopt.init(jparams)
    state = carry_across("opt", jax.tree.map(np.asarray, jstate), cfg=tcfg, device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, opt_cfg))
    step = tsteps.make_train_step(tcfg, topt.OptConfig(warmup_steps=2, total_steps=10,
                                                       peak_lr=1e-2))
    for i in range(3):
        batch = _batch(tcfg, rows=4, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, m = step(model, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=TOL,
                                   atol=TOL)
        assert float(m["lr"]) == float(jm["lr"])
    _close_trees(param_tree(model), jparams)
    for name in ("master", "mu", "nu"):
        _close_trees(state[name], jstate[name])
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert not any(p.requires_grad or p.grad is not None for p in model.parameters())


def test_remat_gives_the_same_gradients_bitwise():
    """cfg.remat (torch.utils.checkpoint around each group) recomputes the
    same numbers: every gradient bit for bit."""
    (_, _), (tcfg, model) = _pair("tinyllama-1.1b")
    batch = _batch(tcfg)
    off = _port_grads(tcfg.replace(remat=False), model, batch)
    on = _port_grads(tcfg.replace(remat=True), model, batch)
    assert torch.equal(off[0], on[0])
    for (_, a), (_, b) in zip(tree_items(off[2]), tree_items(on[2])):
        for x, y in zip(leaf_parts(a), leaf_parts(b)):
            assert torch.equal(x, y)


def test_flash_under_grad_raises():
    """The flash kernel has no backward (nor has the reference's): a train
    step with attn_impl="flash" raises instead of detaching the attention;
    without grad the route runs."""
    (_, _), (tcfg, model) = _pair("tinyllama-1.1b", attn_impl="flash")
    step = tsteps.make_train_step(tcfg, topt.OptConfig())
    state = topt.init(model)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        step(model, state, _batch(tcfg, rows=4))
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        total, _ = train_loss(tcfg, model, {k: torch.from_numpy(v)
                                            for k, v in _batch(tcfg).items()})
    assert torch.isfinite(total)
