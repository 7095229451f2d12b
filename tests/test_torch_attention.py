"""The flash-attention kernel's plain version (and the naive oracle) on the
CPU, held against the JAX package's Pallas kernel in interpret mode and its
``ref_attention``, on the same numpy inputs.

Bars: 2e-5 for float32 against the JAX flash kernel (the same blocked
algorithm; only the summation order differs), 1.6e-2 (about two bf16 ulps
of the output) for bf16 against it; 2e-3 for float32 and 3e-2 for bf16
against the naive oracle (the reference's own bounds,
tests/test_kernels_attention.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import ref_attention as jref_attention
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
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
