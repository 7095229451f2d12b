"""The port's sequence mixers on the CPU: ``models/common.py``'s
``causal_conv1d`` and ``sinusoidal_positions``, ``models/ssd.py`` (the
chunked linear-attention core and the Mamba2 block, zamba2) and
``models/xlstm.py`` (mLSTM and sLSTM, xlstm-1.3b), held against the JAX
package's twins on weights carried across from the reference's
``init_params``, ``dt_bias`` made non-zero so that it is compared.

Bars: ``causal_conv1d`` within 1e-6 (the same products and sums in the
same order); ``sinusoidal_positions`` within 1e-6 at 16 positions, and at
whisper's 1500 x 1024 within 2e-4: the two libraries' float32 ``exp`` of
the rate differ by an ulp (6e-8), which the position multiplies before
the sin/cos (1500 x 6e-8 ~ 1e-4); the core and the three mixers within
2e-5 in float32, where only the summation order of the products, the
libraries' exp / log1p / tanh and ``F.logsigmoid`` against
``jax.nn.log_sigmoid`` differ (the port takes softplus as
``logaddexp(x, 0)``, as ``jax.nn.softplus`` does, with no threshold).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import ssd as jssd
from repro.models import xlstm as jxlstm
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.models import common as tcommon
from repro_torch.models import ssd as tssd
from repro_torch.models import xlstm as txlstm

LAYER_TOL = 2e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(name, seed=1):
    """(reference cfg, params), (port cfg, model) on the same weights, with
    the zero-initialised dt_bias drawn non-zero (some heads above softplus's
    threshold of 20)."""
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        a = np.asarray(x.astype(jnp.float32))
        if path[-1].key == "dt_bias":
            a = (3.0 * rng.standard_normal(a.shape)).astype(np.float32)
            a.flat[::5] = 21.0
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, jinit_params(jcfg, jax.random.key(seed)))
    jparams = jax.tree.map(lambda a: jnp.asarray(a), tree)
    return (jcfg, jparams), (tcfg, carry_across("params", tree, cfg=tcfg, device="cpu"))


@pytest.mark.parametrize("k", [1, 4])
def test_causal_conv1d(k):
    x, w = _rand(0, 2, 19, 12), _rand(1, k, 12)
    want, want_state = jcommon.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    got, got_state = tcommon.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want, 1e-6)
    assert tuple(got_state.shape) == want_state.shape
    _close(got_state, want_state, 0)


@pytest.mark.parametrize("seq,dim,tol", [(16, 32, 1e-6), (1500, 1024, 2e-4)])
def test_sinusoidal_positions(seq, dim, tol):
    want = jcommon.sinusoidal_positions(seq, dim)
    got = tcommon.sinusoidal_positions(seq, dim)
    assert got.shape == (seq, dim) and got.dtype == torch.float32
    _close(got, want, tol)


@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 32), (50, 16), (7, 16)])
def test_chunked_linear_attention(s, chunk):
    """Whole chunks, a chunk size that does not divide S (identity-step
    padding) and S below one chunk; from a zero and a given state."""
    b, h, n, p = 2, 3, 8, 5
    q, k, v = _rand(2, b, s, h, n), _rand(3, b, s, h, n), _rand(4, b, s, h, p)
    log_a = -np.abs(_rand(5, b, s, h))
    state0 = _rand(6, b, h, n, p)
    for s0 in (None, state0):
        want_y, want_s = jssd.chunked_linear_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(log_a), chunk=chunk,
            state0=None if s0 is None else jnp.asarray(s0))
        got_y, got_s = tssd.chunked_linear_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(log_a), chunk=chunk,
            state0=None if s0 is None else torch.from_numpy(s0))
        assert got_y.shape == (b, s, h, p)
        _close(got_y, want_y, LAYER_TOL)
        _close(got_s, want_s, LAYER_TOL)


def test_mamba2_apply():
    (jcfg, jparams), (tcfg, model) = _pair("zamba2-2.7b")
    x = _rand(7, 2, 40, 64)
    jp = jax.tree.map(lambda a: a[0, 1], jparams["layers"]["mamba"]["mixer"])
    want, _ = jssd.mamba2_apply(jp, jcfg, jnp.asarray(x))
    got, cache = tssd.mamba2_apply(model.layers[0].mamba[1].mixer, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("s", [24, 64])
def test_mlstm_apply(s):
    (jcfg, jparams), (tcfg, model) = _pair("xlstm-1.3b")
    x = _rand(8, 2, s, 64)
    jp = jax.tree.map(lambda a: a[1, 2], jparams["layers"]["mlstm"]["mixer"])
    want, _ = jxlstm.mlstm_apply(jp, jcfg, jnp.asarray(x))
    got, cache = txlstm.mlstm_apply(model.layers[1].mlstm[2].mixer, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want, LAYER_TOL)


def test_slstm_apply():
    (jcfg, jparams), (tcfg, model) = _pair("xlstm-1.3b")
    x = _rand(9, 2, 33, 64)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["slstm"]["cell"])
    want, _ = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(x))
    got, cache = txlstm.slstm_apply(model.layers[1].slstm.cell, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want, LAYER_TOL)
