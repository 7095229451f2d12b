"""The flash-attention kernel's plain version (and the naive oracle) on the
CPU, held against the JAX package's Pallas kernel in interpret mode and its
``ref_attention``, on the same numpy inputs.

Bars: 2e-5 for float32 against the JAX flash kernel (the same blocked
algorithm; only the summation order differs), 1.6e-2 (about two bf16 ulps
of the output) for bf16 against it; 2e-3 for float32 and 3e-2 for bf16
against the naive oracle (the reference's own bounds,
tests/test_kernels_attention.py).  The kernels themselves run only on the
card: the ``cuda`` tests hold them against the plain version there, at the
same bars, and skip elsewhere; on the card, with no JAX installed, run them
alone: ``PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_attention.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.kernels.ref import ref_attention as jref_attention
except ModuleNotFoundError:  # a machine with a card but no JAX runs only the cuda tests
    jnp = jflash = jref_attention = None
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

F32_FLASH, BF16_FLASH = 2e-5, 1.6e-2
F32_REF, BF16_REF = 2e-3, 3e-2


def _qkv(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs for both packages, rounded to ``dtype`` once."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


CASES = [  # (b, sq, skv, h, kv, d, causal, window, dtype): tests/test_kernels_attention.py
    *[(b, s, s, h, kv, d, causal, None, "float32")
      for (b, s, h, kv, d) in [(1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 32),
                               (2, 128, 2, 2, 128)]
      for causal in (True, False)],
    (1, 256, 256, 2, 2, 64, True, 64, "float32"),  # sliding window
    (1, 128, 128, 2, 2, 64, True, None, "bfloat16"),
    (1, 64, 256, 2, 2, 64, True, None, "float32"),  # right-aligned queries, Sq < Skv
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window,dtype", CASES)
def test_plain_matches_jax_flash_and_ref(b, sq, skv, h, kv, d, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sq + d + h, b, sq, skv, h, kv, d), dtype)
    kw = dict(causal=causal, window=window)
    got = flash_attention_plain(tq, tk, tv, block_q=64, block_k=64, **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = jflash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    f32 = dtype == "float32"
    _close(got, want, F32_FLASH if f32 else BF16_FLASH)
    _close(got, jref_attention(jq, jk, jv, **kw), F32_REF if f32 else BF16_REF)
    _close(kref.ref_attention(tq, tk, tv, **kw), jref_attention(jq, jk, jv, **kw),
           F32_FLASH if f32 else BF16_FLASH)


@pytest.mark.parametrize("b,s,h,d", [(4, 64, 2, 16), (2, 128, 4, 16)])
def test_serving_shapes_match_jax_flash(b, s, h, d):
    """tests/test_encoder_stage.py's serving shapes, at the model's default
    128-row tiles, through ``ops.flash_attention`` as the model calls it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, b, s, s, h, h, d), "float32")
    before = flash_attention_cuda.launches
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert flash_attention_cuda.launches == before  # CPU tensors: the plain version
    _close(got, jflash(jq, jk, jv, causal=True, interpret=True), F32_FLASH)


def test_masked_score_is_neg_1e30_not_minus_inf():
    """A query with no real key (Sq > Skv, causal) averages v uniformly, as
    the reference's -1e30 fill gives; -inf would give NaN."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, 128, 64, 2, 2, 16), "float32")
    got = flash_attention_plain(tq, tk, tv, causal=True, block_q=64, block_k=64)
    want = jflash(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    assert torch.isfinite(got).all()
    _close(got, want, F32_FLASH)
    _close(got[0, 0], tv[0].mean(dim=0), F32_FLASH)


def test_preconditions_raise():
    q, k, v = (torch.zeros(1, 128, 3, 16), torch.zeros(1, 128, 2, 16), torch.zeros(1, 128, 2, 16))
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_plain(q, k, v)
    q, k, v = (torch.zeros(1, 192, 2, 16), torch.zeros(1, 192, 2, 16), torch.zeros(1, 192, 2, 16))
    with pytest.raises(ValueError, match="tile"):
        flash_attention_cuda(q, k, v)


def test_cudaless_call_raises_naming_cuda():
    """Off the CPU the wrapper launches the kernel or raises: a tensor that
    is on neither the CPU nor a CUDA device names what is missing."""
    q = torch.zeros(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("dtype,d,want", [
    *[(torch.bfloat16, d, "wgmma") for d in (64, 128, 80, 48, 100)],
    *[(torch.bfloat16, d, "tf32") for d in (8, 16, 32)],
    *[(torch.float32, d, "tf32") for d in (8, 16, 32, 64, 80, 128)],
])
def test_route_by_type_and_padded_head_dim(dtype, d, want):
    """bf16 at a padded D of 64 or 128 (every full-width config; zamba2's 80
    pads to 128) takes the wgmma kernel; float32 at any D, and bf16 at D 16
    or 32, the split-TF32 tensor-core kernel."""
    assert fa.route(dtype, d) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_raises_above_128(dtype):
    with pytest.raises(ValueError, match="at most 128"):
        fa.route(dtype, 129)


def test_kernel_names_tell_the_routes_apart():
    """The profile split in chip_smoke.py classifies a kernel by these
    substrings of its name: neither may contain the other."""
    tf32_name, wgmma_name = fa.KERNEL_NAMES
    assert tf32_name not in wgmma_name and wgmma_name not in tf32_name


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits cleared: a TF32 operand (the
    kernel rounds to nearest instead, which halves this error)."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b as the tensor cores form it from TF32 operands, summed in
    float32 (a product of two TF32 values is exact in float32): one pass,
    or three of the split a = big + small, b likewise, dropping small.small."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _tf32_attention(q, k, v, causal, window, passes):
    """Float32 attention with both products (QK^T, and PV with p in [0, 1])
    taken as :func:`_tf32_matmul` takes them; masks as the kernels'."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.reshape(b, sq, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    kf = k.permute(0, 2, 1, 3)[:, :, None]
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    s = _tf32_matmul(qf, kf.transpose(-1, -2), passes) * d**-0.5
    q_pos = torch.arange(sq)[:, None] + (skv - sq)
    k_pos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    s = torch.where(keep, s, fa.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = _tf32_matmul(p, vf, passes) / p.sum(dim=-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window,dtype",
                         [c for c in CASES if c[-1] == "float32"])
def test_split_tf32_products_keep_the_float32_bar(b, sq, skv, h, kv, d, causal, window, dtype):
    """The split-TF32 kernel's error budget, on the CPU: attention whose two
    products are three TF32 passes each stays within the float32 bar (2e-5)
    of the plain version at the float32 cases' shapes and inputs; one TF32
    pass does not."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sq + d + h, b, sq, skv, h, kv, d))
    want = flash_attention_plain(q, k, v, causal=causal, window=window).numpy()
    three = _tf32_attention(q, k, v, causal, window, passes=3).numpy()
    one = _tf32_attention(q, k, v, causal, window, passes=1).numpy()
    np.testing.assert_allclose(three, want, rtol=F32_FLASH, atol=F32_FLASH)
    assert not np.allclose(one, want, rtol=F32_FLASH, atol=F32_FLASH), float(
        np.abs(one - want).max())


WGMMA_CASES = [  # the wgmma kernel's 128-key tiles are the plain version's default blocks
    (1, 256, 256, 8, 2, 128, True, 64),  # GQA 4:1, sliding window 64, D 128
    (1, 256, 256, 4, 2, 64, True, None),
    (1, 128, 128, 2, 2, 128, False, None),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window", WGMMA_CASES)
def test_plain_matches_jax_flash_at_wgmma_route(b, sq, skv, h, kv, d, causal, window):
    """bf16 at the shapes the wgmma route takes, at the default 128-row
    tiles on both sides: the plain version (the wgmma kernel's CPU
    counterpart) against the JAX flash kernel in interpret mode (1.6e-2)
    and the naive oracle (3e-2)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sq + d + h + 1, b, sq, skv, h, kv, d), "bfloat16")
    assert fa.route(tq.dtype, d) == "wgmma"
    kw = dict(causal=causal, window=window)
    got = flash_attention_cuda(tq, tk, tv, **kw)  # CPU tensors: the plain version
    assert got.shape == tq.shape and got.dtype == torch.bfloat16
    _close(got, jflash(jq, jk, jv, interpret=True, **kw), BF16_FLASH)
    _close(got, jref_attention(jq, jk, jv, **kw), BF16_REF)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: torch.cuda.is_available() is False (no GPU or a CPU-only torch)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d", [(8, 2048, 12, 12, 64), (8, 2048, 8, 2, 128)])
def test_wgmma_kernel_matches_plain_on_card(card, b, s, h, kv, d):
    """On the card: the wgmma kernel at the encoder stage's 2048 bucket (and
    at D 128 with GQA 4:1) against its plain version (1.6e-2)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = flash_attention_cuda.route_launches["wgmma"]
    got = flash_attention_cuda(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    assert flash_attention_cuda.route_launches["wgmma"] == before + 1
    want = flash_attention_plain(q, k, v, causal=True).float()
    err = (got - want).abs()
    assert bool((err <= BF16_FLASH + BF16_FLASH * want.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dtype", [
    (8, 2048, 12, 12, 64, torch.float32),  # the encoder stage's 2048 bucket
    (8, 2048, 8, 2, 128, torch.float32),  # D 128, GQA 4:1
    (2, 256, 4, 2, 16, torch.bfloat16),
    (2, 256, 4, 2, 32, torch.bfloat16),
])
def test_tf32_kernel_matches_plain_on_card(card, b, s, h, kv, d, dtype):
    """On the card: the split-TF32 kernel against its plain version, float32
    within 2e-5 and bf16 within 1.6e-2, one launch on its route each."""
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = dict(flash_attention_cuda.route_launches)
    got = flash_attention_cuda(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    assert flash_attention_cuda.route_launches == {**before, "tf32": before["tf32"] + 1}
    want = flash_attention_plain(q, k, v, causal=True).float()
    tol = F32_FLASH if dtype == torch.float32 else BF16_FLASH
    err = (got - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), float(err.max())
