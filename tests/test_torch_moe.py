"""The port's Mixture-of-Experts (``models/mlp.py``) on the CPU, held
against the JAX package's ``models/mlp.py`` on weights carried across from
the reference's ``init_params`` (reduced mixtral-8x22b and
qwen2-moe-a2.7b: 8 experts top-2, qwen's shared expert and its gate).

Bars: the router's choices, slot positions, keeps and capacity equal; its
gates, its aux loss and ``moe_apply`` under both dispatch routes within
2e-5 in float32, where only the summation order of the products differs;
the scatter route against the einsum route inside the port within the
reference's own bound for the pair (tests/test_perf_variants.py: 2e-5 on
the logits, 1e-6 on the aux).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import mlp as jmlp
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.models import forward
from repro_torch.models import mlp as tmlp

MOE = ["mixtral-8x22b", "qwen2-moe-a2.7b"]
LAYER_TOL = 2e-5


def _cfgs(name, capacity_factor=None, **replace):
    """The reduced (reference, port) configs, at ``capacity_factor`` if given."""
    cfgs = []
    for cfg in (jget_config(name).reduced(), get_config(name).reduced()):
        if capacity_factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
        cfgs.append(cfg.replace(**replace))
    return cfgs


def _pair(name, seed=1, **replace):
    """(reference cfg, params), (port cfg, model) on the same weights."""
    jcfg, tcfg = _cfgs(name, **replace)
    jparams = jinit_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    return (jcfg, jparams), (tcfg, carry_across("params", tree, cfg=tcfg, device="cpu"))


def _moe0(jparams):
    return jax.tree.map(lambda x: x[0], jparams["layers"]["moe"])


def _x(seed, b=2, s=32, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])  # 0.25 drops tokens
@pytest.mark.parametrize("name", MOE)
def test_route_matches_reference(name, capacity_factor):
    (jcfg, jparams), (tcfg, model) = _pair(name, capacity_factor=capacity_factor)
    x = _x(2)
    jg, ji, jpos, jkeep, _, jcap, jaux = jmlp._route(_moe0(jparams), jcfg, jnp.asarray(x))
    tg, ti, tpos, tkeep, _, tcap, taux = tmlp._route(model.layers[0].moe, tcfg,
                                                     torch.from_numpy(x))
    assert tcap == jcap
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if capacity_factor < 1:
        assert not bool(tkeep.all())  # the capacity drops some choices
    _close(tg, jg, LAYER_TOL)
    _close(taux, jaux, LAYER_TOL)


def test_route_breaks_ties_toward_the_lower_index():
    """Equal probabilities (x = 0: every logit 0) pick experts 0..k-1 in
    order, as jax.lax.top_k does."""
    (jcfg, jparams), (tcfg, model) = _pair("mixtral-8x22b")
    x = np.zeros((1, 8, 64), np.float32)
    _, ji, jpos, _, _, _, _ = jmlp._route(_moe0(jparams), jcfg, jnp.asarray(x))
    _, ti, tpos, _, _, _, _ = tmlp._route(model.layers[0].moe, tcfg, torch.from_numpy(x))
    k = tcfg.moe.top_k
    assert ti.tolist() == [[list(range(k))] * 8]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference(name, impl, capacity_factor):
    (jcfg, jparams), (tcfg, model) = _pair(name, moe_impl=impl, capacity_factor=capacity_factor)
    x = _x(3)
    want, jaux = jmlp.moe_apply(_moe0(jparams), jcfg, jnp.asarray(x))
    got, taux = tmlp.moe_apply(model.layers[0].moe, tcfg, torch.from_numpy(x))
    assert got.shape == (2, 32, 64) and got.dtype == torch.float32
    _close(got, want, LAYER_TOL)
    _close(taux, jaux, LAYER_TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_scatter_matches_einsum_in_the_port(name):
    """The reference's own equivalence of its two dispatch routes
    (tests/test_perf_variants.py), inside the port, through ``forward``."""
    (_, _), (tcfg, model) = _pair(name, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 64)).astype(np.int32))
    le, _, auxe = forward(tcfg.replace(moe_impl="einsum"), model, tokens)
    ls, _, auxs = forward(tcfg.replace(moe_impl="scatter"), model, tokens)
    np.testing.assert_allclose(le.numpy(), ls.numpy(), atol=2e-5)
    assert abs(float(auxe - auxs)) < 1e-6
    assert float(auxs) > 0  # forward sums the routers' aux losses


def test_scatter_dispatch_is_exact():
    """Every kept token lands in its (expert, slot) unchanged and every other
    slot stays zero: a dropped choice adds an exact zero."""
    (_, _), (cfg, model) = _pair("qwen2-moe-a2.7b", capacity_factor=0.25)
    x = torch.from_numpy(_x(4))
    gate_vals, expert_idx, pos, keep, _, cap, _ = tmlp._route(model.layers[0].moe, cfg, x)
    slots = tmlp._slots(expert_idx, pos, cap)
    buf = tmlp._dispatch(x, slots, keep, cfg.moe.num_experts, cap)
    want = torch.zeros_like(buf)
    for b, s, j in keep.nonzero().tolist():
        want[b, expert_idx[b, s, j], pos[b, s, j]] = x[b, s]
    assert not bool(keep.all())
    assert torch.equal(buf, want)


def test_rows_route_alone():
    """A row's routing and output depend on its own tokens only (capacity
    counts within the row): row 0 alone equals row 0 of a batch of two."""
    (_, _), (tcfg, model) = _pair("qwen2-moe-a2.7b")
    x = torch.from_numpy(_x(5))
    moe = model.layers[0].moe
    both = tmlp._route(moe, tcfg, x)
    alone = tmlp._route(moe, tcfg, x[:1])
    for got, want in zip(alone[1:4], both[1:4]):
        assert torch.equal(got, want[:1])
    y2, _ = tmlp.moe_apply(moe, tcfg, x)
    y1, _ = tmlp.moe_apply(moe, tcfg, x[:1])
    np.testing.assert_allclose(y1.numpy(), y2[:1].numpy(), rtol=1e-6, atol=1e-6)
