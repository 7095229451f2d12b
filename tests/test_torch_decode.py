"""The port's prefill and decode caches on the CPU, every registered config at
``.reduced()``, held against the JAX package's ``init_cache`` / ``prefill``
/ ``decode_step`` and ``launch.steps``' step makers on weights carried
across from the reference (the zero-initialised gates, biases and
``dt_bias`` drawn non-zero first, as in test_torch_families.py).

Bars: logits at every step and every float cache leaf within 2e-4 in
float32 (the reference's own flash-vs-sdpa bound, as for ``forward``); the
slots' positions ``pos`` and the greedy tokens bit for bit; the port's own
decode against its teacher-forced ``forward`` within the reference's bars
(1e-3; MoE 0.5, tests/test_arch_smoke.py); the SSM step, the conv's state
and the resumed mLSTM prefill within 2e-5.  The reference side of each
config runs once per module (``_reference``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import ssd as jssd
from repro.models import xlstm as jxlstm
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models import ssd as tssd
from repro_torch.models import xlstm as txlstm

NAMES = sorted(REGISTRY)
TOL, LAYER_TOL = 2e-4, 2e-5
B, S_PRE, STEPS = 2, 16, 4
ZERO_AT_INIT = ("gate", "ffn_gate", "bq", "bk", "bv", "dt_bias")


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _leaves(tree[k], f"{prefix}.{k}")]
    return [(prefix.lstrip("."), tree)]


def _cache_close(got, want, tol=TOL):
    """Every leaf of the port's cache against the reference's: pos bit for
    bit, the rest within tol; the same nesting, shapes and types."""
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, key
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), key
        if key.endswith("pos"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol, err_msg=key)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


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


def _inputs(cfg, total, seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, total)).astype(np.int32)
    frontend = None
    if cfg.n_frontend_tokens:
        frontend = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return tokens, frontend


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _pos(t):
    return np.full((B, 1), t, np.int32)


def _run_reference(jcfg, jparams, tokens, frontend, s_pre, n_steps, max_len):
    """The reference's prefill of s_pre tokens and n_steps greedy decode
    steps (its step makers), fed the given tokens: logits, next tokens and
    the cache (numpy) after the prefill and after the last step."""
    prefill_step = jax.jit(jsteps.make_prefill_step(jcfg))
    step = jax.jit(jsteps.make_decode_step(jcfg))
    cache = jinit_cache(jcfg, B, max_len)
    lg, cache = prefill_step(jparams, jnp.asarray(tokens[:, :s_pre]), cache, _j(frontend))
    out = {"prefill_logits": np.asarray(lg), "prefill_cache": _np_tree(cache),
           "logits": [], "next": []}
    for t in range(s_pre, s_pre + n_steps):
        nt, lg, cache = step(jparams, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(_pos(t)), cache)
        out["logits"].append(np.asarray(lg))
        out["next"].append(np.asarray(nt))
    out["cache"] = _np_tree(cache)
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    tokens, frontend = _inputs(tcfg, S_PRE + STEPS)
    ref = _run_reference(jcfg, jparams, tokens, frontend, S_PRE, STEPS, S_PRE + STEPS)
    return tcfg, model, tokens, frontend, ref


# ------------------------------------------------------------ every config


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    """init_cache -> prefill of 16 -> 4 decode_steps: logits at every step
    and the cache after the prefill and after the last step."""
    cfg, model, tokens, frontend, ref = _reference(name)
    cache = init_cache(cfg, B, S_PRE + STEPS, device="cpu")
    _cache_close(cache, _np_tree(jinit_cache(jget_config(name).reduced(), B, S_PRE + STEPS)))
    lg, out = prefill(cfg, model, torch.from_numpy(tokens[:, :S_PRE]), cache,
                      frontend=_t(frontend))
    assert out is cache  # consumed and returned, written in place
    _close(lg, ref["prefill_logits"])
    _cache_close(cache, ref["prefill_cache"])
    for i, t in enumerate(range(S_PRE, S_PRE + STEPS)):
        step_logits, cache = decode_step(cfg, model, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.from_numpy(_pos(t)), cache)
        assert step_logits.shape == (B, cfg.padded_vocab)
        _close(step_logits, ref["logits"][i])
    _cache_close(cache, ref["cache"])


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_teacher_forcing(name):
    """The port's twin of the reference's check: prefill + decode against
    the teacher-forced forward over the same 20 tokens."""
    cfg, model, tokens, frontend, _ = _reference(name)
    tk = torch.from_numpy(tokens)
    full, _, _ = forward(cfg, model, tk, mode="train", frontend=_t(frontend))
    cache = init_cache(cfg, B, S_PRE + STEPS, device="cpu")
    lg, cache = prefill(cfg, model, tk[:, :S_PRE], cache, frontend=_t(frontend))
    errs = [float((lg[:, -1] - full[:, S_PRE - 1]).abs().max())]
    for t in range(S_PRE, S_PRE + STEPS):
        step_logits, cache = decode_step(cfg, model, tk[:, t:t + 1],
                                         torch.from_numpy(_pos(t)), cache)
        errs.append(float((step_logits - full[:, t]).abs().max()))
    # MoE capacity dropping differs between the batched train and the
    # decode paths, so MoE configs get the reference's looser bar.
    tol = 0.5 if cfg.moe else 1e-3
    assert max(errs) < tol, errs


@pytest.mark.parametrize("name", NAMES)
def test_carry_across_cache(name):
    """The reference's cache after its prefill, carried across, equals the
    port's own after the same prefill; decode steps from it give the
    reference's logits."""
    cfg, model, tokens, frontend, ref = _reference(name)
    carried = carry_across("cache", ref["prefill_cache"], cfg=cfg, device="cpu")
    own = init_cache(cfg, B, S_PRE + STEPS, device="cpu")
    prefill(cfg, model, torch.from_numpy(tokens[:, :S_PRE]), own, frontend=_t(frontend))
    _cache_close(carried, ref["prefill_cache"], tol=0)
    _cache_close(own, tcommon.tree_map(lambda x: x.numpy(), carried))
    cache = carried
    for i, t in enumerate(range(S_PRE, S_PRE + STEPS)):
        step_logits, cache = decode_step(cfg, model, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.from_numpy(_pos(t)), cache)
        _close(step_logits, ref["logits"][i])


@pytest.mark.parametrize("name", NAMES)
def test_step_makers_match_reference(name):
    """make_prefill_step / make_decode_step: greedy tokens bit for bit, as
    int32, and the logits within the bar."""
    cfg, model, tokens, frontend, ref = _reference(name)
    prefill_step, step = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    cache = init_cache(cfg, B, S_PRE + STEPS, device="cpu")
    _, cache = prefill_step(model, torch.from_numpy(tokens[:, :S_PRE]), cache, _t(frontend))
    for i, t in enumerate(range(S_PRE, S_PRE + STEPS)):
        nt, lg, cache = step(model, torch.from_numpy(tokens[:, t:t + 1]),
                             torch.from_numpy(_pos(t)), cache)
        assert nt.dtype == torch.int32 and nt.shape == (B,)
        np.testing.assert_array_equal(nt.numpy(), ref["next"][i])
        _close(lg, ref["logits"][i])


def test_step_makers_raise_for_a_mesh():
    """The inference step makers take a DeviceMesh and raise for anything
    that is not a mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_config("tinyllama-1.1b").reduced()
    for make in (tsteps.make_prefill_step, tsteps.make_decode_step):
        with pytest.raises(TypeError, match="a mesh is None, a HostMesh or a DeviceMesh"):
            make(cfg, mesh=object())
    with pytest.raises(TypeError, match="a mesh is None, a HostMesh or a DeviceMesh"):
        tsteps.make_embed_step(cfg, 4, mesh=object())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        for make in (tsteps.make_prefill_step, tsteps.make_decode_step):
            assert callable(make(cfg, mesh=mesh))
        assert callable(tsteps.make_embed_step(cfg, 4, mesh=mesh))
    finally:
        dist.destroy_process_group()


def test_embed_step_matches_embed_sentences():
    from repro_torch.models import embed_sentences

    cfg, model, tokens, _, _ = _reference("tinyllama-1.1b")
    seg = np.repeat(np.arange(4), 5)[None].repeat(B, 0).astype(np.int32)
    got = tsteps.make_embed_step(cfg, 4)(model, torch.from_numpy(tokens), torch.from_numpy(seg))
    want = embed_sentences(cfg, model, torch.from_numpy(tokens), torch.from_numpy(seg), 4)
    assert torch.equal(got, want)


# ----------------------------------------------------- ring and clamp


@pytest.mark.parametrize("s_pre,n_steps", [(40, 8), (16, 20)])
def test_sliding_window_ring(s_pre, n_steps):
    """mixtral at the reduced window of 32 (cache of 32 slots): a prefill of
    40 tokens takes the ring's tail branch, one of 16 the leading write;
    each is followed by decode steps that wrap the ring."""
    (jcfg, jparams), (cfg, model) = _pair("mixtral-8x22b")
    assert cfg.sliding_window == 32
    total = s_pre + n_steps
    tokens, _ = _inputs(cfg, total, seed=5)
    ref = _run_reference(jcfg, jparams, tokens, None, s_pre, n_steps, 64)
    cache = init_cache(cfg, B, 64, device="cpu")
    assert cache["layers"]["k"].shape[2] == 32
    lg, cache = prefill(cfg, model, torch.from_numpy(tokens[:, :s_pre]), cache)
    _close(lg, ref["prefill_logits"])
    _cache_close(cache, ref["prefill_cache"])
    for i, t in enumerate(range(s_pre, total)):
        step_logits, cache = decode_step(cfg, model, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.from_numpy(_pos(t)), cache)
        _close(step_logits, ref["logits"][i])
    _cache_close(cache, ref["cache"])
    assert int(cache["layers"]["pos"].max()) == total - 1


def test_decode_past_max_len_clamps_as_the_reference():
    """A full cache of 20 slots: the step at position 20 writes the last slot
    and stamps it 20 (dynamic_update_slice clamps its start), in both."""
    (jcfg, jparams), (cfg, model) = _pair("tinyllama-1.1b")
    tokens, _ = _inputs(cfg, 22, seed=6)
    ref = _run_reference(jcfg, jparams, tokens, None, 16, 6, 20)
    cache = init_cache(cfg, B, 20, device="cpu")
    _, cache = prefill(cfg, model, torch.from_numpy(tokens[:, :16]), cache)
    for i, t in enumerate(range(16, 22)):
        step_logits, cache = decode_step(cfg, model, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.from_numpy(_pos(t)), cache)
        _close(step_logits, ref["logits"][i])
    _cache_close(cache, ref["cache"])
    assert cache["layers"]["pos"][0, -1] == 21


def test_prefill_longer_than_a_full_cache_raises():
    cfg = get_config("tinyllama-1.1b").reduced()
    model = init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="12 tokens does not fit a cache of 8 slots"):
        prefill(cfg, model, torch.zeros((1, 12), dtype=torch.int32), cache)


# ----------------------------------------------------------- the pieces


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_linear_attention_step():
    b, h, n, p = 2, 3, 8, 5
    q, k, v, state = _rand(1, b, h, n), _rand(2, b, h, n), _rand(3, b, h, p), _rand(4, b, h, n, p)
    log_a = -np.abs(_rand(5, b, h))
    want_y, want_s = jssd.linear_attention_step(*map(jnp.asarray, (q, k, v, log_a, state)))
    got_y, got_s = tssd.linear_attention_step(*map(torch.from_numpy, (q, k, v, log_a, state)))
    _close(got_y, want_y, LAYER_TOL)
    _close(got_s, want_s, LAYER_TOL)
    assert got_s.dtype == torch.float32


@pytest.mark.parametrize("k,s", [(1, 5), (4, 1), (4, 6)])
def test_causal_conv1d_state(k, s):
    """A given state is the left pad; the new state is the last K - 1 rows
    of the padded input (zeros at K = 1)."""
    x, w, state = _rand(6, 2, s, 12), _rand(7, k, 12), _rand(8, 2, k - 1, 12)
    want_y, want_s = jcommon.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                           state=jnp.asarray(state))
    got_y, got_s = tcommon.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                         state=torch.from_numpy(state))
    _close(got_y, want_y, 1e-6)
    assert tuple(got_s.shape) == want_s.shape
    _close(got_s, want_s, 0)


def test_mlstm_prefill_resume():
    """``mlstm_apply(mode="prefill_resume")`` runs from the cached state and
    returns no cache, in both."""
    (jcfg, jparams), (cfg, model) = _pair("xlstm-1.3b")
    x = _rand(9, 2, 12, 64)
    jp = jax.tree.map(lambda a: a[0, 1], jparams["layers"]["mlstm"]["mixer"])
    state = _rand(10, 2, cfg.n_heads, 2 * 64 // cfg.n_heads, 2 * 64 // cfg.n_heads + 1)
    conv = _rand(11, 2, 3, 128)
    want, want_c = jxlstm.mlstm_apply(jp, jcfg, jnp.asarray(x), mode="prefill_resume",
                                      cache={"conv": jnp.asarray(conv),
                                             "state": jnp.asarray(state)})
    got, got_c = txlstm.mlstm_apply(model.layers[0].mlstm[1].mixer, cfg, torch.from_numpy(x),
                                    mode="prefill_resume",
                                    cache={"conv": torch.from_numpy(conv),
                                           "state": torch.from_numpy(state)})
    assert got_c is None and want_c is None
    _close(got, want, LAYER_TOL)
