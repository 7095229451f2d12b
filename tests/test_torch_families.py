"""The port's other model families end to end on the CPU: moe
(mixtral-8x22b, qwen2-moe-a2.7b), hybrid (zamba2-2.7b), ssm (xlstm-1.3b),
encdec (whisper-medium) and vlm (llama-3.2-vision-11b), at reduced width,
held against the JAX package's ``init_params`` / ``forward`` / ``encode`` /
``embed_sentences`` on weights carried across from the reference.

The leaves that start at zero (the vlm's tanh gates ``gate`` and
``ffn_gate``, QKV biases, Mamba2's ``dt_bias``) are drawn non-zero in the
numpy tree before it goes into both packages: at zero a gated
cross-attention block is the identity and would never be compared.

Bars: the carried weights bit for bit, each leaf in its own type (float32
routers, gates and SSM constants in a bf16 model); ``init_params``'s
shapes and types equal the reference's tree; cross-attention and
``encode`` within 2e-5 in float32; ``forward``'s logits and aux and
``embed_sentences`` within 2e-4 in float32 (the reference's own
flash-vs-sdpa bound, tests/test_encoder_stage.py), and 3e-2 in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data.synthetic import synthetic_document
from repro.data.tokenizer import ByteTokenizer
from repro.models import attention as jattn
from repro.models import embed_sentences as jembed_sentences
from repro.models import encode as jencode
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch.configs.base import get_config
from repro_torch.embeddings import EncoderStage
from repro_torch.interop import carry_across
from repro_torch.models import attention as tattn
from repro_torch.models import embed_sentences, encode, forward, init_params

FAMILIES = ["mixtral-8x22b", "qwen2-moe-a2.7b", "zamba2-2.7b", "xlstm-1.3b",
            "whisper-medium", "llama-3.2-vision-11b"]
LAYER_TOL, EMBED_TOL, BF16_TOL = 2e-5, 2e-4, 3e-2
ZERO_AT_INIT = ("gate", "ffn_gate", "bq", "bk", "bv", "dt_bias")
STACKED = ("self", "mamba", "mlstm")  # a group's repeated sub-blocks


def _pair(name, seed=1, **replace):
    """(reference cfg, params), (port cfg, model) on the same weights, the
    zero-initialised leaves drawn non-zero."""
    jcfg = jget_config(name).reduced().replace(**replace)
    tcfg = get_config(name).reduced().replace(**replace)
    jparams = jinit_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if path[-1].key not in ZERO_AT_INIT:
            return x
        return jnp.asarray(0.7 * rng.standard_normal(x.shape) + 0.3, x.dtype)

    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    return (jcfg, jparams), (tcfg, carry_across("params", tree, cfg=tcfg, device="cpu"))


def _split(keys, leaf):
    """[(port state name, array)] of one reference leaf, split along the
    stacked axes it carries in front."""
    if keys[0] == "layers":
        out = []
        for i in range(leaf.shape[0]):
            if keys[1] in STACKED:
                out += [(".".join(["layers", str(i), keys[1], str(j), *keys[2:]]), leaf[i, j])
                        for j in range(leaf.shape[1])]
            else:
                out.append((".".join(["layers", str(i), *keys[1:]]), leaf[i]))
        return out
    if keys[:2] == ["encoder", "blocks"]:
        return [(".".join(["encoder", "blocks", str(j), *keys[2:]]), leaf[j])
                for j in range(leaf.shape[0])]
    return [(".".join(keys), leaf)]


def _leaves(jparams):
    return [pair for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
            for pair in _split([p.key for p in path], leaf)]


def _inputs(cfg, b=2, s=64, seed=3):
    """Tokens of two synthetic documents, their segment ids, and a stub
    frontend (B, n_frontend_tokens, d) where the family needs one."""
    tok = ByteTokenizer()
    pairs = [tok.encode_sentences(synthetic_document(seed + i, 4), s) for i in range(b)]
    tokens = np.stack([t for t, _ in pairs])
    segs = np.stack([g for _, g in pairs])
    frontend = None
    if cfg.family in ("vlm", "encdec"):
        frontend = np.random.default_rng(seed).standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return tokens, segs, frontend


def _both(x, jdtype, tdtype):
    if x is None:
        return None, None
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_carry_across_params_bit_for_bit(name):
    """bf16 configs: every leaf arrives bit for bit in its own type."""
    (jcfg, jparams), (tcfg, model) = _pair(name, param_dtype="bfloat16")
    state = model.state_dict()
    leaves = _leaves(jparams)
    assert sorted(k for k, _ in leaves) == sorted(state)
    for key, leaf in leaves:
        assert str(state[key].dtype).removeprefix("torch.") == str(leaf.dtype), key
        np.testing.assert_array_equal(state[key].to(torch.float32).numpy(),
                                      np.asarray(leaf.astype(jnp.float32)), err_msg=key)
    assert model.embed.dtype == torch.bfloat16
    if tcfg.moe:
        assert model.layers[0].moe.router.dtype == torch.float32


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_has_the_reference_shapes_and_dtypes(name):
    jcfg = jget_config(name).reduced().replace(param_dtype="bfloat16")
    tcfg = get_config(name).reduced().replace(param_dtype="bfloat16")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _leaves(jinit_params(jcfg, jax.random.key(0)))}
    model = init_params(tcfg, 0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    assert all(not p.requires_grad for p in model.parameters())
    assert all(bool(torch.isfinite(p.float()).all()) for p in model.parameters())


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    tokens, _, frontend = _inputs(tcfg)
    jf, tf = _both(frontend, jnp.float32, torch.float32)
    want, _, jaux = jforward(jcfg, jparams, jnp.asarray(tokens), frontend=jf)
    got, cache, aux = forward(tcfg, model, torch.from_numpy(tokens), frontend=tf)
    assert cache is None and got.shape == (2, 64, tcfg.padded_vocab)
    v = tcfg.vocab_size
    _close(got[..., :v], np.asarray(want)[..., :v], EMBED_TOL)
    assert bool((got[..., v:] == -1e30).all())
    _close(aux, jaux, EMBED_TOL)
    if tcfg.moe:
        assert float(aux) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_embed_sentences_matches_reference(name):
    (jcfg, jparams), (tcfg, model) = _pair(name)
    tokens, segs, frontend = _inputs(tcfg)
    jf, tf = _both(frontend, jnp.float32, torch.float32)
    want = jembed_sentences(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(segs), 4,
                            frontend=jf)
    got = embed_sentences(tcfg, model, torch.from_numpy(tokens), torch.from_numpy(segs), 4,
                          frontend=tf)
    assert got.shape == (2, 4, tcfg.d_model) and got.dtype == torch.float32
    _close(got, want, EMBED_TOL)


def test_embed_sentences_bf16():
    """qwen2-moe in bf16 (two layers, qkv bias, shared expert): the router
    takes float32 logits of bf16 states on both sides."""
    (jcfg, jparams), (tcfg, model) = _pair("qwen2-moe-a2.7b", param_dtype="bfloat16")
    tokens, segs, _ = _inputs(tcfg)
    want = jembed_sentences(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(segs), 4)
    got = embed_sentences(tcfg, model, torch.from_numpy(tokens), torch.from_numpy(segs), 4)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention(gated):
    """The vlm's gated cross layer and whisper's ungated one (qkv bias)."""
    name = "llama-3.2-vision-11b" if gated else "whisper-medium"
    (jcfg, jparams), (tcfg, model) = _pair(name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 16, 64)).astype(np.float32)
    if gated:
        jp = jax.tree.map(lambda a: a[1], jparams["layers"]["cross"]["attn"])
        tp = model.layers[1].cross.attn
    else:
        jp = jax.tree.map(lambda a: a[1], jparams["layers"]["cross_attn"])
        tp = model.layers[1].cross_attn
    want = jattn.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(mem), gated=gated)
    got = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(mem),
                                gated=gated)
    _close(got, want, LAYER_TOL)
    if gated:  # the gate scales the output
        ungated = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(mem))
        torch.testing.assert_close(got, torch.tanh(tp.gate) * ungated)


def test_encode():
    (jcfg, jparams), (tcfg, model) = _pair("whisper-medium")
    _, _, frontend = _inputs(tcfg)
    want = jencode(jcfg, jparams, jnp.asarray(frontend))
    got = encode(tcfg, model, torch.from_numpy(frontend))
    assert got.shape == (2, tcfg.n_frontend_tokens, tcfg.d_model)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("name", ["whisper-medium", "llama-3.2-vision-11b"])
def test_frontend_families_need_a_frontend(name):
    cfg = get_config(name).reduced()
    model = init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="need frontend embeddings"):
        forward(cfg, model, tokens)
    with pytest.raises(ValueError, match="frontend"):
        EncoderStage(cfg, model, device="cpu")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "zamba2-2.7b", "xlstm-1.3b"])
def test_encoder_stage_takes_the_text_families(name):
    """The stage serves moe, hybrid and ssm configs unchanged: its flash
    route (the kernel's plain version here) gives embed_sentences' rows."""
    cfg = get_config(name).reduced()
    model = init_params(cfg, 0, device="cpu")
    sents = synthetic_document(7, 6)
    with EncoderStage(cfg, model, max_len=1024, attn_impl="flash", device="cpu") as stage:
        fut = stage.submit(sents)
        got = fut.result(timeout=120)
        assert stage.stats().launches == 1
    # An MoE's capacity grows with the padded length, so the rows are
    # those of the stage's length bucket.
    tokens, segs = ByteTokenizer().encode_sentences(sents, fut.receipt().padded_len)
    assert set(segs.tolist()) == {-1, *range(6)}
    want = embed_sentences(cfg.replace(attn_impl="flash"), model,
                           torch.from_numpy(tokens)[None], torch.from_numpy(segs)[None], 6)[0]
    want = want / torch.linalg.vector_norm(want, dim=-1, keepdim=True)
    assert got.shape == (6, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
