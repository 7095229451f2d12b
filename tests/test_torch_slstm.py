"""The sLSTM scan op (``repro_torch::slstm_scan``, kernels/slstm_scan.py) on
the CPU, where it runs its plain versions, against the JAX package.

Bars: the op inside ``slstm_apply`` against the reference's ``slstm_apply``
(xlstm-1.3b reduced, weights carried across) within 2e-5 in float32, the
bar of ``tests/test_torch_ssm.py`` (only the summation order of the
products and the libraries' exp / log1p / tanh differ); the plain scan
against a float64 numpy transcription of the reference's step within 1e-12
(the same float64 arithmetic, summed in another order); the op's backward
against autograd of the plain loop within 1e-10 in float64, and its
``gradcheck``; its gradients against ``jax.grad`` within 2e-4, the bar of
``tests/test_torch_train_models.py`` (float32 through a backward of the
cell and its FFN); the flop formulas exactly.  The CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py``'s phase
4k.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import xlstm as jxlstm
from repro_torch.analysis.cost import analyze
from repro_torch.configs.base import get_config
from repro_torch.interop import carry_across
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_scan as ks
from repro_torch.models import xlstm as txlstm

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = 2e-5
GRAD_TOL = 2e-4
STATE = ("c", "n", "h", "m")


def _rand(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float64)),
                               np.asarray(want, np.float64), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, the second sLSTM cell's params), (port cfg, the same
    cell) of xlstm-1.3b reduced (d 64, 4 heads of 16), weights carried
    across; the forget bias and the zero biases redrawn so that every gate
    sees a bias."""
    jcfg, tcfg = jget_config("xlstm-1.3b").reduced(), get_config("xlstm-1.3b").reduced()
    rng = np.random.default_rng(3)

    def leaf(path, x):
        a = np.asarray(x.astype(jnp.float32))
        if [getattr(k, "key", None) for k in path][-2:] == ["cell", "bias"]:
            a = (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, jinit_params(jcfg, jax.random.key(3)))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = carry_across("params", tree, cfg=tcfg, device="cpu")
    return (jcfg, jax.tree.map(lambda a: a[1], jparams["layers"]["slstm"]["cell"])), (
        tcfg, model.layers[1].slstm.cell)


def test_op_against_reference_train_prefill_decode(pair):
    """Train (no state), prefill (its final state) and 4 decode steps from
    that state, each within 2e-5 of the reference's ``slstm_apply``."""
    (jcfg, jp), (tcfg, cell) = pair
    x = _rand(11, 2, 29, 64)
    want, _ = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(x))
    got, cache = txlstm.slstm_apply(cell, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want, LAYER_TOL)

    want, jst = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(x), mode="prefill")
    got, tst = txlstm.slstm_apply(cell, tcfg, torch.from_numpy(x), mode="prefill")
    _close(got, want, LAYER_TOL)
    for k in STATE:
        _close(tst[k], jst[k], LAYER_TOL)

    steps = _rand(12, 2, 4, 64)
    for t in range(4):
        want, jst = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(steps[:, t:t + 1]), mode="decode",
                                       cache=jst)
        got, out = txlstm.slstm_apply(cell, tcfg, torch.from_numpy(steps[:, t:t + 1]),
                                      mode="decode", cache=tst)
        assert out is tst  # the cache is written in place
        _close(got, want, LAYER_TOL)
        for k in STATE:
            _close(tst[k], jst[k], LAYER_TOL)


def _reference_scan_np(wx, r, bias, st):
    """The reference's step (src/repro/models/xlstm.py:158-170) transcribed
    in numpy, float64: (hs, final state)."""
    b, s, d4 = wx.shape
    nh, dh, _ = r.shape
    d = d4 // 4
    hs = []
    for t in range(s):
        rec = np.einsum("bhd,hde->bhe", st["h"].reshape(b, nh, dh), r).reshape(b, 4 * d)
        pre = wx[:, t] + rec + bias
        z_r, i_r, f_r, o_r = np.split(pre, 4, axis=-1)
        z = np.tanh(z_r)
        log_f = -np.logaddexp(0.0, -f_r)
        m_new = np.maximum(log_f + st["m"], i_r)
        i_g = np.exp(i_r - m_new)
        f_g = np.exp(log_f + st["m"] - m_new)
        c = f_g * st["c"] + i_g * z
        n = f_g * st["n"] + i_g
        h = 1.0 / (1.0 + np.exp(-o_r)) * c / np.maximum(n, 1e-6)
        st = {"c": c, "n": n, "h": h, "m": m_new}
        hs.append(h)
    return np.stack(hs, axis=1), st


def _inputs(seed, b, s, nh, dh, dtype=np.float64):
    """wx, r (fan-in dh), bias and a starting state (n positive), numpy."""
    d = nh * dh
    rng = np.random.default_rng(seed)
    st = {"c": rng.standard_normal((b, d)), "n": rng.uniform(0.5, 1.5, (b, d)),
          "h": 0.5 * rng.standard_normal((b, d)), "m": rng.standard_normal((b, d))}
    return (rng.standard_normal((b, s, 4 * d)).astype(dtype),
            (rng.standard_normal((nh, dh, 4 * dh)) / math.sqrt(dh)).astype(dtype),
            rng.standard_normal(4 * d).astype(dtype),
            {k: v.astype(dtype) for k, v in st.items()})


@pytest.mark.parametrize("nh", [2, 4, 8])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_scan_index_map(nh, d):
    """Gate g of unit j reads flat column g D + j of the per-head product,
    dense across heads, at NH 2, 4 and 8: the plain scan (and its saved
    pre-activations and states) against the transcription in float64."""
    wx, r, bias, st = _inputs(nh * 100 + d, 3, 9, nh, d // nh)
    want_hs, want_st = _reference_scan_np(wx, r, bias, st)
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    hs, c, n, h, m, pre, cnm = ks.slstm_scan_plain(
        torch.from_numpy(wx), torch.from_numpy(r), torch.from_numpy(bias),
        t["c"], t["n"], t["h"], t["m"], save=True)
    _close(hs, want_hs, 1e-12)
    for k, v in zip(STATE, (c, n, h, m)):
        _close(v, want_st[k], 1e-12)
    assert pre.shape == wx.shape and cnm.shape == (3, 3, 9, d)
    _close(cnm[:, :, -1], np.stack([want_st["c"], want_st["n"], want_st["m"]]), 1e-12)
    # pre at step 0 is wx + h0 @ r (per head) + bias
    rec0 = np.einsum("bhd,hde->bhe", st["h"].reshape(3, nh, d // nh), r).reshape(3, 4 * d)
    _close(pre[:, 0], wx[:, 0] + rec0 + bias, 1e-12)


@pytest.mark.parametrize("nh", [2, 4])
def test_backward_against_autograd_of_the_loop(nh):
    """The op's gradients (the plain reverse scan, then d_r's product and
    d_bias's sum) of every input against autograd of the plain loop, in
    float64, with gradients on hs and on every leaf of the final state."""
    b, s, dh = 2, 7, 4
    wx, r, bias, st = _inputs(7 + nh, b, s, nh, dh)
    rng = np.random.default_rng(8)
    d = nh * dh
    g_hs = torch.from_numpy(rng.standard_normal((b, s, d)))
    g_st = [torch.from_numpy(rng.standard_normal((b, d))) for _ in STATE]

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (wx, r, bias, st["c"], st["n"], st["h"], st["m"])]
        hs, *final = fn(*leaves)[:5]
        loss = (hs * g_hs).sum() + sum((f * g).sum() for f, g in zip(final, g_st))
        return torch.autograd.grad(loss, leaves)

    want = grads(lambda *a: ks.slstm_scan_plain(*a, save=False))
    got = grads(lambda *a: ks.slstm_scan(*a, True))
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-10)


def test_backward_plain_matches_autograd_d_pre():
    """slstm_scan_backward_plain's own outputs: d_pre equals autograd's
    gradient of wx, and the starting state's gradients, in float64."""
    wx, r, bias, st = _inputs(21, 2, 6, 2, 8)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (wx, r, bias, st["c"], st["n"], st["h"], st["m"])]
    hs, c, n, h, m, pre, cnm = ks.slstm_scan_plain(*args, save=True)
    g_hs = torch.from_numpy(np.random.default_rng(22).standard_normal(hs.shape))
    want = torch.autograd.grad((hs * g_hs).sum(), args)
    zero = torch.zeros_like(c)
    d_pre, d_c0, d_n0, d_h0, d_m0 = ks.slstm_scan_backward_plain(
        g_hs, zero, zero, zero, zero, args[1].detach(), pre.detach(), cnm.detach(),
        *(a.detach() for a in (args[3], args[4], args[6])))
    for g, w in zip((d_pre, d_c0, d_n0, d_h0, d_m0), (want[0], *want[3:])):
        _close(g, w.numpy(), 1e-10)


def test_gradcheck():
    """torch.autograd.gradcheck of the op over wx, r, bias and the starting
    state, at B 2, S 5 (float64, finite differences)."""
    wx, r, bias, st = _inputs(31, 2, 5, 2, 3)
    args = tuple(torch.from_numpy(a).requires_grad_(True)
                 for a in (wx, r, bias, st["c"], st["n"], st["h"], st["m"]))
    assert torch.autograd.gradcheck(lambda *a: ks.slstm_scan(*a, True)[:5], args)


def test_grad_against_jax(pair):
    """jax.grad of a scalar of the reference's slstm_apply against the op's
    gradients through the port's slstm_apply (x and every weight of the
    cell), within 2e-4."""
    (jcfg, jp), (tcfg, cell) = pair
    x = _rand(41, 2, 17, 64)
    g = _rand(42, 2, 17, 64)

    def loss(p, xx):
        return (jxlstm.slstm_apply(p, jcfg, xx)[0] * jnp.asarray(g)).sum()

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = [n for n, _ in cell.named_parameters()]
    params = list(cell.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = txlstm.slstm_apply(cell, tcfg, xt)
        got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [xt, *params])
    finally:
        for p in params:
            p.requires_grad_(False)
    _close(got[0], want_x, GRAD_TOL)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(want_p)[0]}
    for name, grad in zip(names, got[1:]):
        _close(grad, flat[name], GRAD_TOL)


def test_fake_full_width_and_flops():
    """Under FakeTensorMode, the op at xlstm-1.3b's full width (D 2048, 4
    heads of 512) and S 32,768 (prefill_32k's rank, B 2) returns its shapes
    at once, and analysis.cost counts 2 B S NH dh 4dh for it; with its
    backward (B 16 x S 4,096, train_4k's rank), the reverse scan and d_r's
    product add twice that."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    nh, dh = 4, 512
    d = nh * dh
    with FakeTensorMode():
        def call(b, s, grad):
            wx = torch.empty((b, s, 4 * d), requires_grad=grad)
            r = torch.empty((nh, dh, 4 * dh), requires_grad=grad)
            bias = torch.empty(4 * d)
            state = {k: torch.empty((b, d)) for k in STATE}
            hs, st = ops.slstm_scan(wx, r, bias, state)
            if grad:
                torch.autograd.grad(hs.sum(), [wx, r])
            return hs, st

        t0 = time.perf_counter()
        cost = analyze(call, 2, 32768, False)
        assert time.perf_counter() - t0 < 1.0
        hs, st = cost["out"]
        assert hs.shape == (2, 32768, d) and all(st[k].shape == (2, d) for k in STATE)
        assert cost["flops"] == 2 * 2 * 32768 * nh * dh * 4 * dh
        train = analyze(call, 16, 4096, True)
        assert train["flops"] == 3 * 2 * 16 * 4096 * nh * dh * 4 * dh


def test_dryrun_xlstm_train_cell(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --arch xlstm-1.3b --shape
    train_4k --mesh single`` at one group (``--override n_layers=8``: 7
    mLSTM layers and 1 sLSTM layer; the full cells run in chip_smoke.py's
    phase 4k) reaches ``ok`` in a subprocess, and its flops hold the sLSTM's
    share by the formula: the same cell traced here with the two ops'
    formulas at 0 counts 3 x 2 B_l S D 4dh less (the forward, its
    recomputation under remat, the reverse scan; B_l 16 = 256 / 16)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import flop_registry

    from repro_torch.launch import dryrun

    args = ["--arch", "xlstm-1.3b", "--shape", "train_4k", "--mesh", "single",
            "--override", "n_layers=8"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                             "--out", str(tmp_path / "sub")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        for op in (torch.ops.repro_torch.slstm_scan, torch.ops.repro_torch.slstm_scan_backward):
            monkeypatch.setitem(flop_registry, op, lambda *a, **k: 0)
        cfg = get_config("xlstm-1.3b")
        bare = dryrun.run_cell("xlstm-1.3b", "train_4k", False, tmp_path,
                               overrides={"n_layers": 8})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    assert "xlstm-1.3b x train_4k: ok " in out, out
    rec = json.loads((tmp_path / "sub" / "xlstm-1.3b__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and bare["status"] == "ok", bare.get("error")
    dh = cfg.d_model // cfg.n_heads
    share = 3 * 2 * 16 * 4096 * cfg.d_model * 4 * dh
    assert rec["flops_per_chip"] - bare["flops_per_chip"] == share
    assert rec["fits"] and rec["seconds"] < dryrun.CELL_BUDGET_S


# ---------------------------------------------------------------------------
# The CUDA wrappers' host side: the exchange buffer, the plan's fields and
# the timed instances' buffer (the kernels themselves run in chip_smoke.py)
# ---------------------------------------------------------------------------

SPLIT_S, SPLIT_GRID = 6, 4


@pytest.fixture(scope="module")
def split_buffer():
    """A timed launch's buffer as the kernel lays it out (S 6, grid 4):
    every counter full, block 2 the last to publish at every step but step
    3 (block 1), phase k of block x at step t taking 100 (k + 1) + 10 x + t
    cycles, and block x's clock at 2 + x / 10 GHz over the loop."""
    s, grid, slots = SPLIT_S, SPLIT_GRID, 8
    buf = np.zeros(ks.split_words(s, grid), dtype=np.int64)
    buf[:s] = grid
    tickets = buf[s:s + grid * s].reshape(grid, s)
    tickets[:] = np.array([0, 1, 3, 2])[:, None]
    tickets[[1, 2], 3] = [3, 2]
    o = s + grid * s
    cycles = buf[o:o + grid * s * slots].reshape(grid, s, slots)
    k, x, t = np.meshgrid(np.arange(slots), np.arange(grid), np.arange(s), indexing="ij")
    cycles[:] = (100 * (k + 1) + 10 * x + t).transpose(1, 2, 0)
    clocks = buf[o + grid * s * slots:].reshape(grid, 4)
    clocks[:, 1], clocks[:, 3] = 1_000, 1_000 + 10_000
    clocks[:, 0], clocks[:, 2] = 5, 5 + (10_000 * (2 + np.arange(grid) / 10)).astype(np.int64)
    return buf


def test_exchange_words_and_plan_fields():
    """The wrappers' exchange buffer: two slots of h (B, D) for the forward,
    of d pre (B, 4D) for the backward; the plan reports the register layout
    and the exchange's bytes, and no batch tile or partial scratch."""
    assert ks.exchange_words(2, 2048) == 2 * 2 * 2048
    assert ks.exchange_words(40, 2048, backward=True) == 2 * 40 * 4 * 2048
    assert {"registers", "exchange_bytes", "lines", "warps", "segments"} <= set(ks.PLAN_FIELDS)
    assert "batch_tile" not in ks.PLAN_FIELDS
    assert ks.split_words(SPLIT_S, SPLIT_GRID) == SPLIT_S * (1 + 9 * SPLIT_GRID) + 4 * SPLIT_GRID
    assert all(len(p) <= 8 for p in ks.SPLIT_PHASES.values())


def test_read_split_block0_and_last(split_buffer):
    """Each phase's mean ns a step in block 0 and in the block whose ticket
    was its step's last, cycles over each block's own clock rate."""
    phases = ks.SPLIT_PHASES["forward"]
    got = ks.read_split(split_buffer, SPLIT_S, SPLIT_GRID, phases)
    steps = np.arange(SPLIT_S)
    last = np.where(steps == 3, 1, 2)
    for i, name in enumerate(phases):
        want0 = np.mean(100 * (i + 1) + steps) / 2.0
        want_last = np.mean((100 * (i + 1) + 10 * last + steps) / (2 + last / 10))
        assert got["block0"][name] == pytest.approx(want0)
        assert got["last"][name] == pytest.approx(want_last)
    assert got["block0_sum"] == pytest.approx(sum(got["block0"].values()))
    assert got["ghz"] == pytest.approx(2.0) and got["complete"]


def test_read_split_flags_a_short_step(split_buffer):
    """A step whose arrival counter is short of the grid (a block that never
    published) reads as incomplete."""
    buf = split_buffer.copy()
    buf[4] = SPLIT_GRID - 1
    assert not ks.read_split(buf, SPLIT_S, SPLIT_GRID, ks.SPLIT_PHASES["backward"])["complete"]


@pytest.mark.parametrize("backward", [False, True])
def test_cuda_wrappers_refuse_cpu_tensors(backward):
    """The CUDA wrappers (and the timed instances) take CUDA tensors only:
    CPU tensors raise before any library is built or the exchange buffer
    allocated."""
    wx, r, bias, st = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                       {k: torch.from_numpy(v) for k, v in a.items()}
                       for a in _inputs(5, 2, 3, 2, 4, np.float32))
    state = [st[k] for k in STATE]
    if backward:
        hs, c, n, h, m, pre, cnm = ks.slstm_scan_plain(wx, r, bias, *state, save=True)
        args = (hs, c, n, h, m, r, pre, cnm, state[0], state[1], state[3])
        calls = (ks.slstm_scan_backward_cuda, lambda *a: ks.step_split(True, *a))
    else:
        args = (wx, r, bias, *state)
        calls = (ks.slstm_scan_cuda, lambda *a: ks.step_split(False, *a, False))
    for call in calls:
        with pytest.raises(ValueError, match="contiguous float32 tensors on"):
            call(*args)
