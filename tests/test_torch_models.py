"""The port's dense backbone on the CPU, held against the JAX package's
``models/`` on weights carried across from the reference's ``init_params``.

Bars: float32 layers (rmsnorm, RoPE, MLP, self-attention under each
route) within 2e-5, where only the summation order and the sin/cos/rsqrt
implementations differ; ``embed_sentences`` within 2e-4 in float32 (the
reference's own flash-vs-sdpa bound, tests/test_encoder_stage.py) and
3e-2 in bf16 (two layers); the tokenizer and the carried weights bit for
bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data.synthetic import synthetic_document
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import embed_sentences as jembed_sentences
from repro.models import init_params as jinit_params
from repro.models import mlp as jmlp
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import get_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.interop import carry_across
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decode_step, embed_sentences, forward, init_cache, init_params
from repro_torch.models import mlp as tmlp

DENSE = ["sbert-paper", "tinyllama-1.1b", "qwen2.5-32b", "minitron-8b", "gemma-2b"]
LAYER_TOL, EMBED_TOL, BF16_TOL = 2e-5, 2e-4, 3e-2


def _tree_np(tree):
    """The reference's params as float32 numpy (bf16 leaves widen exactly)."""
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _pair(name, seed=1, **replace):
    """(reference cfg, params), (port cfg, model) on the same weights."""
    jcfg = jget_config(name).reduced().replace(**replace)
    tcfg = get_config(name).reduced().replace(**replace)
    jparams = jinit_params(jcfg, jax.random.key(seed))
    return (jcfg, jparams), (tcfg, carry_across("params", _tree_np(jparams), cfg=tcfg,
                                               device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _layer0(jparams):
    return jax.tree.map(lambda x: x[0], jparams["layers"])


def test_tokenizer_bit_for_bit():
    texts = ["The budget vote passed.", "Ünïcödé — naïve café.", "", "a\nb\tc"]
    jt, tt = JByteTokenizer(), ByteTokenizer()
    for t in texts:
        assert tt.encode(t, bos=True, eos=True) == jt.encode(t, bos=True, eos=True)
        assert tt.decode(tt.encode(t)) == jt.decode(jt.encode(t))
    for max_len in (16, 128):
        for got, want in zip(tt.encode_sentences(texts, max_len),
                             jt.encode_sentences(texts, max_len)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", DENSE)
def test_carry_across_params_bit_for_bit(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    state = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        want = np.asarray(leaf.astype(jnp.float32))
        if keys[0] == "layers":
            for i in range(jcfg.n_groups):
                got = state[".".join(["layers", str(i), *keys[1:]])]
                np.testing.assert_array_equal(got.to(torch.float32).numpy(), want[i])
                n += 1
        else:
            np.testing.assert_array_equal(state[".".join(keys)].to(torch.float32).numpy(), want)
            n += 1
    assert n == len(state)


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in DENSE] + [("sbert-paper", "bfloat16")])
def test_init_params_has_the_reference_shapes_and_dtypes(name, dtype):
    jcfg = jget_config(name).reduced().replace(param_dtype=dtype)
    tcfg = get_config(name).reduced().replace(param_dtype=dtype)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jinit_params(jcfg, jax.random.key(0)))[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(jcfg.n_groups):
                want[".".join(["layers", str(i), *keys[1:]])] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    model = init_params(tcfg, 0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == {k: (tuple(s), d) for k, (s, d) in want.items()}
    assert all(not p.requires_grad for p in model.parameters())


def test_init_params_is_seeded():
    cfg = get_config("sbert-paper").reduced()
    a, b, c = (init_params(cfg, s, device="cpu").state_dict() for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x, scale = _rand(0, 2, 8, 64), _rand(1, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale, jdt)}, jnp.asarray(x, jdt), eps=1e-5)
    got = tcommon.rmsnorm(torch.from_numpy(scale).to(tdt), torch.from_numpy(x).to(tdt), eps=1e-5)
    assert got.dtype == tdt
    _close(got, want, LAYER_TOL if dtype == "float32" else BF16_TOL)


def test_apply_rope():
    x = _rand(2, 2, 8, 4, 16)
    pos = np.broadcast_to(np.arange(8)[None] + np.array([[0], [100]]), (2, 8))
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10000.0)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("name", ["sbert-paper", "gemma-2b", "minitron-8b"])  # silu, gelu, relu2
def test_mlp_apply(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    x = _rand(3, 2, 8, 64)
    want = jmlp.mlp_apply(_layer0(jparams)["mlp"], jcfg, jnp.asarray(x))
    got = tmlp.mlp_apply(model.layers[0].mlp, tcfg, torch.from_numpy(x))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("impl", ["flash", "sdpa", "auto"])
@pytest.mark.parametrize("name", ["sbert-paper", "tinyllama-1.1b", "qwen2.5-32b"])
def test_self_attention(impl, name):
    """Each route at S = 128 (``auto`` at S <= attn_chunk is the naive
    path; the chunked path is held below at chunk 32)."""
    (jcfg, jparams), (tcfg, model) = _pair(name, attn_impl=impl)
    b, s = 2, 128
    x = _rand(4, b, s, 64)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    want, _ = jattn.self_attention(_layer0(jparams)["attn"], jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), mode="train")
    got, cache = tattn.self_attention(model.layers[0].attn, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()))
    assert cache is None
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_sdpa_chunked(causal, window):
    b, s, h, kv, d = 2, 128, 4, 2, 16
    q, k, v = _rand(5, b, s, h, d), _rand(6, b, s, kv, d), _rand(7, b, s, kv, d)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    kw = dict(causal=causal, window=window, chunk=32)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), d**-0.5, **kw)
    got = tattn._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos.copy()), d**-0.5, **kw)
    _close(got, want, LAYER_TOL)


def _tokens(n_sents=4, max_len=128):
    tokens, segs = JByteTokenizer().encode_sentences(synthetic_document(9, n_sents), max_len)
    return tokens[None], segs[None], n_sents


@pytest.mark.parametrize("name", DENSE)
def test_embed_sentences_matches_reference(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    tokens, segs, g = _tokens()
    want = jembed_sentences(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(segs), g)
    got = embed_sentences(tcfg, model, torch.from_numpy(tokens), torch.from_numpy(segs), g)
    assert got.shape == (1, g, tcfg.d_model) and got.dtype == torch.float32
    _close(got, want, EMBED_TOL)


def test_embed_sentences_bf16_two_layers():
    """bf16 weights: the embedding scale rounds to bf16 first and the
    logits of the naive path round to bf16 before widening, on both sides."""
    (jcfg, jparams), (tcfg, model) = _pair("sbert-paper", param_dtype="bfloat16")
    assert tcfg.n_layers == 2 and model.embed.dtype == torch.bfloat16
    tokens, segs, g = _tokens()
    want = jembed_sentences(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(segs), g)
    got = embed_sentences(tcfg, model, torch.from_numpy(tokens), torch.from_numpy(segs), g)
    _close(got, want, BF16_TOL)


def test_forward_logits_mask_the_padded_vocab():
    (jcfg, jparams), (tcfg, model) = _pair("gemma-2b")  # tied embeddings
    tokens, _, _ = _tokens(max_len=64)
    from repro.models import forward as jforward

    want, _, _ = jforward(jcfg, jparams, jnp.asarray(tokens))
    got, cache, aux = forward(tcfg, model, torch.from_numpy(tokens))
    assert cache is None and float(aux) == 0.0
    assert got.shape == (1, 64, tcfg.padded_vocab) and got.dtype == torch.float32
    assert bool((got[..., tcfg.vocab_size:] == -1e30).all())
    _close(got[..., :tcfg.vocab_size], np.asarray(want)[..., :tcfg.vocab_size], EMBED_TOL)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_other_families_name_their_roadmap_item(name):
    """Every registered config runs prefill and decode (ROADMAP queue 1 is
    ported): the cache comes back, the logits are finite, and nothing names
    a ROADMAP item."""
    cfg = get_config(name).reduced()
    model = init_params(cfg, 0, device="cpu")
    frontend = (torch.ones((1, cfg.n_frontend_tokens, cfg.d_model))
                if cfg.n_frontend_tokens else None)
    cache = init_cache(cfg, 1, 9, device="cpu")
    logits, got, _ = forward(cfg, model, torch.zeros((1, 8), dtype=torch.int32), mode="prefill",
                             cache=cache, frontend=frontend)
    assert got is cache and logits.shape == (1, 8, cfg.padded_vocab)
    logits, got = decode_step(cfg, model, torch.ones((1, 1), dtype=torch.int32),
                              torch.full((1, 1), 8), cache)
    assert got is cache and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())


def test_other_modes_name_their_roadmap_item():
    """A prefill or decode without a cache, and an unknown mode, raise a
    ValueError that names what is missing, not a ROADMAP item."""
    cfg = get_config("sbert-paper").reduced()
    model = init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="needs a cache from init_cache"):
            forward(cfg, model, tokens, mode=mode)
    with pytest.raises(ValueError, match="unknown mode 'prefill_resume'"):
        forward(cfg, model, tokens, mode="prefill_resume")
