"""The port's bf16 serving path on the CPU, one model of each family that
decodes on the card at full depth (xlstm, qwen2-moe, zamba2, whisper, the
vlm, gemma), at ``.reduced()`` width with three groups and ``param_dtype``
bf16, held against the JAX package's ``prefill`` and ``decode_step`` on the
same weights (the port's init stacked into the reference's tree, the
zero-initialised gates, biases and ``dt_bias`` drawn non-zero first).

The reference runs greedy: a prefill of S_PRE tokens, then STEPS decode
steps, each fed the token its last logits chose; the port is fed the same
tokens.  The reference's programs are compiled with XLA's
``xla_allow_excess_precision`` off, so that each bf16 operation rounds as
its source writes it (with it on, XLA may skip a rounding between fused
operations, and a hidden state one bf16 ulp away moves a near-tied MoE
choice).  Even so the two packages round differently inside an operation
(summation order of a product, silu and gelu rounded once in torch and per
operation in XLA), so values agree to bf16's grade, not bit for bit.

Bars: the logits at the prefill's last position and at every step within
LOGIT_TOL of that step's largest reference logit; every float cache leaf,
after the prefill and after the last step, within CACHE_TOL of the leaf's
largest reference magnitude (``pos`` bit for bit, shapes and types equal);
the port's greedy token equal to the reference's wherever the reference's
top-2 gap exceeds twice the step's logit error; the MoE routers' choices
equal at every layer of the prefill and of each step wherever they are
decisive (as the greedy tokens, on the router's logits).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import mlp as jmlp
from repro.models import prefill as jprefill
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.models import decode_step, init_cache, init_params, param_tree, prefill
from repro_torch.models import mlp as tmlp

FAMILIES = ("xlstm-1.3b", "qwen2-moe-a2.7b", "zamba2-2.7b", "whisper-medium",
            "llama-3.2-vision-11b", "gemma-2b")
GROUPS = 3
B, S_PRE, STEPS = 2, 32, 6  # S_PRE: two chunks of the reduced SSM (16)
# bf16 keeps 8 significant bits (a unit roundoff of 2^-8): the bars are 8
# and 16 such units of the tensor's largest magnitude.
LOGIT_TOL, CACHE_TOL = 2.0**-5, 2.0**-4
ZERO_AT_INIT = ("gate", "ffn_gate", "bq", "bk", "bv", "dt_bias")
XLA_OPTIONS = {"xla_allow_excess_precision": False}


def _cut(cfg):
    return cfg.reduced().replace(n_layers=GROUPS * cfg.group_size, param_dtype="bfloat16")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _leaves(tree[k], f"{prefix}.{k}")]
    return [(prefix.lstrip("."), tree)]


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class _Routes:
    """Each package's ``_route`` wrapped to record every call's expert
    choices (B, S, k) and router logits (B, S, E) float32, in call order;
    the reference's through an ordered debug callback, which its compiled
    program runs as it goes."""

    def __init__(self):
        self.ref, self.port = [], []

    def __enter__(self):
        self._orig = jmlp._route, tmlp._route

        def ref_route(p, cfg, x):
            res = self._orig[0](p, cfg, x)
            jax.debug.callback(lambda i, lg: self.ref.append((np.asarray(i), np.asarray(lg))),
                               res[1], x.astype(jnp.float32) @ p["router"], ordered=True)
            return res

        def port_route(p, cfg, x):
            res = self._orig[1](p, cfg, x)
            self.port.append((res[1].numpy().copy(), (x.to(torch.float32) @ p.router).numpy()))
            return res

        jmlp._route, tmlp._route = ref_route, port_route
        return self

    def __exit__(self, *exc):
        jmlp._route, tmlp._route = self._orig


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both packages through the prefill and STEPS greedy steps: per step
    (the prefill's last position first) the logits of each, the tokens fed,
    the caches after the prefill and after the last step, and the routes."""
    jcfg, tcfg = _cut(jget_config(name)), _cut(get_config(name))
    # The weights: the port's init, its zero-initialised leaves drawn
    # non-zero, stacked into the reference's tree (an eager or compiled
    # draw of the reference's init costs seconds a family on the CPU).
    rng = np.random.default_rng(1)

    def tree_of(node, key=None):
        if isinstance(node, dict):
            return {k: tree_of(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return np.stack([tree_of(x, key) for x in node])
        x = node.detach().to(torch.float32).numpy()
        if key in ZERO_AT_INIT:
            x = (0.7 * rng.standard_normal(x.shape) + 0.3).astype(np.float32)
        return x

    tree = tree_of(param_tree(init_params(tcfg, 1, device="cpu")))
    shapes = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.key(1)))
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    model = carry_across("params", tree, cfg=tcfg, device="cpu")
    data = np.random.default_rng(2)
    prompt = data.integers(0, tcfg.vocab_size, (B, S_PRE)).astype(np.int32)
    frontend = None
    if tcfg.n_frontend_tokens:
        frontend = data.standard_normal(
            (B, tcfg.n_frontend_tokens, tcfg.d_model)).astype(np.float32)
    max_len = S_PRE + STEPS
    out = {"cfg": tcfg, "ref": [], "port": [], "fed": []}
    with _Routes() as routes:
        # The reference, greedy.
        cache = jinit_cache(jcfg, B, max_len)
        jfront = None if frontend is None else jnp.asarray(frontend, jnp.bfloat16)
        prog = jax.jit(lambda p, t, c, f: jprefill(jcfg, p, t, c, frontend=f))
        lg, cache = prog.lower(jparams, prompt, cache, jfront).compile(XLA_OPTIONS)(
            jparams, prompt, cache, jfront)
        out["ref_prefill_cache"] = jax.tree.map(np.asarray, cache)
        out["ref"].append(np.asarray(lg[:, -1]))
        pos0 = np.zeros((B, 1), np.int32)
        step = jax.jit(lambda p, t, q, c: jdecode_step(jcfg, p, t, q, c)).lower(
            jparams, pos0, pos0, cache).compile(XLA_OPTIONS)
        for t in range(S_PRE, max_len):
            fed = np.argmax(out["ref"][-1], axis=-1).astype(np.int32)[:, None]
            out["fed"].append(fed)
            lg, cache = step(jparams, fed, np.full((B, 1), t, np.int32), cache)
            out["ref"].append(np.asarray(lg))
        out["ref_cache"] = jax.tree.map(np.asarray, cache)
        # The port, fed the same tokens.
        cache = init_cache(tcfg, B, max_len, device="cpu")
        tfront = None if frontend is None else torch.from_numpy(frontend).to(torch.bfloat16)
        with torch.no_grad():
            lg, cache = prefill(tcfg, model, torch.from_numpy(prompt), cache, frontend=tfront)
            out["port_prefill_cache"] = [(k, v.clone()) for k, v in _leaves(cache)]
            out["port"].append(lg[:, -1].numpy())
            for i, t in enumerate(range(S_PRE, max_len)):
                lg, cache = decode_step(tcfg, model, torch.from_numpy(out["fed"][i]),
                                        torch.full((B, 1), t), cache)
                out["port"].append(lg.numpy())
        out["port_cache"] = _leaves(cache)
    out["routes"] = routes.ref, routes.port
    return out


def _cache_close(got, want, when):
    w = _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in w], when
    for (key, a), (_, b) in zip(got, w):
        assert tuple(a.shape) == b.shape, (when, key)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), (when, key)
        if key.endswith("pos"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{when} {key}")
        elif b.size:
            err = float(np.abs(_f32(a) - _f32(b)).max())
            bar = CACHE_TOL * float(np.abs(_f32(b)).max())
            assert err <= bar, f"{when} {key}: max abs err {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_prefill_and_decode_match_reference(name):
    """Logits at the prefill's last position and at each of the 6 steps, and
    every cache leaf after the prefill and after the last step."""
    out = _run(name)
    v = out["cfg"].vocab_size
    for i, (got, want) in enumerate(zip(out["port"], out["ref"])):
        assert got.shape == want.shape == (B, out["cfg"].padded_vocab)
        err = float(np.abs(got[:, :v] - want[:, :v]).max())
        bar = LOGIT_TOL * float(np.abs(want[:, :v]).max())
        assert np.isfinite(got[:, :v]).all()
        assert err <= bar, f"step {i}: logits max abs err {err:.3e} > {bar:.3e}"
    _cache_close(out["port_prefill_cache"], out["ref_prefill_cache"], "after the prefill")
    _cache_close(out["port_cache"], out["ref_cache"], f"after {STEPS} steps")


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_greedy_tokens_match_where_decisive(name):
    """The port's argmax equals the reference's wherever the reference's
    top-2 gap exceeds twice the step's max abs logit error; most positions
    are decisive."""
    out = _run(name)
    v = out["cfg"].vocab_size
    decisive = 0
    for got, want in zip(out["port"], out["ref"]):
        got, want = got[:, :v], want[:, :v]
        err = float(np.abs(got - want).max())
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * err
        decisive += int(sure.sum())
        np.testing.assert_array_equal(np.argmax(got, -1)[sure], np.argmax(want, -1)[sure])
    assert decisive >= (STEPS + 1) * B // 2, decisive


def test_bf16_router_choices_match():
    """qwen2-moe: every MoE layer's top-k choices, in order, in the prefill
    (B x 32 tokens) and in each step (one token a row, capacity 1) equal
    the reference's wherever they are decisive: each gap between the
    reference's k + 1 largest router logits exceeds twice the call's max
    abs router logit error (the hidden states entering a router differ by
    bf16 roundings, which can flip a near tie).  Most are decisive."""
    ref, port = _run("qwen2-moe-a2.7b")["routes"]
    assert len(ref) == len(port) == GROUPS * (1 + STEPS)
    k = get_config("qwen2-moe-a2.7b").reduced().moe.top_k
    n_sure = n_all = 0
    for i, ((want, lg_ref), (got, lg_port)) in enumerate(zip(ref, port)):
        err = float(np.abs(lg_port - lg_ref).max())
        top = -np.sort(-lg_ref, axis=-1)[..., :k + 1]
        sure = (top[..., :-1] - top[..., 1:]).min(axis=-1) > 2 * err  # (B, S)
        n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.size
        np.testing.assert_array_equal(got.astype(want.dtype)[sure], want[sure],
                                      err_msg=f"route call {i}")
    assert n_sure >= 0.75 * n_all, (n_sure, n_all)
