"""The sLSTM recurrence as one op: ``repro_torch::slstm_scan`` and its
backward ``repro_torch::slstm_scan_backward``, the CUDA kernels' wrappers
and their plain versions.

Replaces no ``pallas_call``: the reference runs the sLSTM cell as one
``jax.lax.scan`` (``src/repro/models/xlstm.py:158-172``) and differentiates
it with ``jax.grad``.  A Python loop over the sequence here was ~20 torch
ops a position (host-bound on the card, and ~80k ops a layer for the dry
run to walk on fake tensors), so the whole recurrence is one custom op a
layer, with

  * a CUDA implementation that launches ``csrc/slstm_scan.cu``'s forward
    kernel (one cooperative launch a call, :func:`slstm_scan_cuda`) and a
    CPU implementation that runs :func:`slstm_scan_plain`, the loop;
  * a fake implementation (shapes only) for ``FakeTensorMode``;
  * an autograd rule whose backward is the op ``slstm_scan_backward`` (the
    reverse scan, :func:`slstm_scan_backward_cuda` / ``_plain``, one launch)
    followed by ``d_wx = d_pre``, ``d_bias = d_pre.sum((0, 1))`` and ``d_r``
    as one per-head ``torch.matmul`` of the saved ``h_{t-1}`` against
    ``d_pre`` over B S (a plain large product, which the reference too
    leaves outside any kernel);
  * flop formulas (``torch.utils.flop_counter``): 2 B S NH dh 4dh for each
    op's recurrent product, so ``analysis.cost`` counts the scan as the
    reference's trip-count-aware walker does.

The layout is the reference's: the per-head product ``h_{t-1} @ r`` is
reshaped to (B, NH 4dh) and split into four gates of D, so gate g of unit
j reads flat column g D + j, which belongs to head (g D + j) // 4dh.

What the forward saves for the backward (only when autograd needs it,
``save=True``): the pre-activations (B, S, 4D) and c, n, m after every
step (3, B, S, D), float32.  A CUDA wrapper checks device, type, shape and
contiguity, allocates its outputs and the kernel's exchange buffer
(:func:`exchange_words`; the kernel marks it invalid itself), launches on
the current stream and raises on a non-zero return code; it never falls
back to the loop.  The ops dispatch by device: the plain versions serve
CPU tensors.

:func:`step_split` runs a kernel's timed instance and :func:`read_split`
turns its buffer into each phase's mean time a step, in block 0 and in the
block that published last; :func:`exchange_probe` times the exchange
alone (``chip_smoke.py``, phase 4k).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.flop_counter

from repro_torch.kernels import _build

NORM_FLOOR = 1e-6  # h = sigmoid(o) c / max(n, NORM_FLOOR)
PLAN_FIELDS = ("units", "grid", "lines", "warps", "segments", "registers", "heads", "smem",
               "exchange_bytes", "per_sm", "sms", "exact")
SPLIT_PHASES = {
    "forward": ("exchange wait", "products", "reduction", "barrier", "gates", "publish"),
    "backward": ("cell gradient", "publish", "exchange wait", "products", "reduction", "barrier"),
}
_SPLIT_SLOTS = 8  # phase words a step in a timed buffer (kPhases)
_PLAN_ERRORS = {
    1: "invalid sizes (B, D and NH at least 1, NH dividing D)",
    9: "r's slice is over the registers, or a block's shared memory over the card's opt-in "
       "limit",
    720: "the grid cannot be co-resident (cooperative launch too large)",
    801: "the device does not support cooperative launches",
}


def _sizes(wx: torch.Tensor, r: torch.Tensor) -> Tuple[int, int, int, int, int]:
    b, s, d4 = wx.shape
    nh, dh, e = r.shape
    if d4 != 4 * nh * dh or e != 4 * dh:
        raise ValueError(f"slstm_scan: wx {tuple(wx.shape)} does not match r {tuple(r.shape)} "
                         "(wx (B, S, 4 NH dh), r (NH, dh, 4 dh))")
    return b, s, nh * dh, nh, dh


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def slstm_scan_plain(wx, r, bias, c0, n0, h0, m0, save: bool = False):
    """The recurrence as a loop over S, in the inputs' type: wx (B, S, 4D)
    (the input projection), r (NH, dh, 4dh), bias (4D,), the starting state
    c0, n0, h0, m0 (B, D).  Returns (hs (B, S, D), c, n, h, m (B, D) final,
    pre (B, S, 4D), cnm (3, B, S, D)); pre and cnm (c, n, m after each step)
    are empty unless ``save``."""
    b, s, d, nh, dh = _sizes(wx, r)
    c, n, h, m = c0, n0, h0, m0
    hs, pres, cnms = [], [], []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, dh), r).reshape(b, 4 * d)
        pre = wx[:, t] + rec + bias
        z_r, i_r, f_r, o_r = torch.chunk(pre, 4, dim=-1)
        z = torch.tanh(z_r)
        log_f = F.logsigmoid(f_r)
        m_new = torch.maximum(log_f + m, i_r)
        i_g = torch.exp(i_r - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=NORM_FLOOR)
        m = m_new
        hs.append(h)
        if save:
            pres.append(pre)
            cnms.append(torch.stack([c, n, m]))
    empty = wx.new_empty(0)
    return (torch.stack(hs, dim=1), c, n, h, m,
            torch.stack(pres, dim=1) if save else empty,
            torch.stack(cnms, dim=2) if save else empty.clone())


def slstm_scan_backward_plain(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0):
    """The reverse scan, in the inputs' type: from the gradients of hs (B, S,
    D) and of the final c, n, h, m (B, D), the forward's saved pre (B, S, 4D)
    and cnm (3, B, S, D), r and the starting c0, n0, m0, returns (d_pre
    (B, S, 4D), d_c0, d_n0, d_h0, d_m0 (B, D)).  Each step differentiates
    the forward's step as autograd of the plain loop does: clamp(n, min)
    passes the gradient where n >= min, maximum splits it in half at a tie;
    d h_{t-1} is the transposed per-head product through the same index
    map."""
    b, s, d = d_hs.shape
    nh, dh, e = r.shape
    d_pre = torch.empty_like(pre)
    dc, dn, dm, dh_rec = d_c, d_n, d_m, d_h
    for t in reversed(range(s)):
        c, n, m = (c0, n0, m0) if t == 0 else cnm[:, :, t - 1].unbind(0)
        z_r, i_r, f_r, o_r = torch.chunk(pre[:, t], 4, dim=-1)
        z = torch.tanh(z_r)
        a = F.logsigmoid(f_r) + m
        m_new = torch.maximum(a, i_r)
        i_g = torch.exp(i_r - m_new)
        f_g = torch.exp(a - m_new)
        c1 = f_g * c + i_g * z
        n1 = f_g * n + i_g
        o = torch.sigmoid(o_r)
        nc = torch.clamp(n1, min=NORM_FLOOR)
        q = (d_hs[:, t] + dh_rec) / nc  # gradient of o c1
        d_o = q * c1 * (o * (1 - o))
        dc1 = dc + q * o
        dn1 = torch.where(n1 >= NORM_FLOOR, dn - q * o * c1 / nc, dn)
        dfg = dc1 * c + dn1 * n
        dig = dc1 * z + dn1
        d_z = dc1 * i_g * (1 - z * z)
        dmn = dm - dig * i_g - dfg * f_g
        share = torch.where(a > i_r, 1.0, torch.where(a == i_r, 0.5, 0.0)).to(a.dtype)
        da = dfg * f_g + dmn * share
        d_i = dig * i_g + dmn * (1 - share)
        d_f = da * torch.sigmoid(-f_r)
        step = torch.cat([d_z, d_i, d_f, d_o], dim=-1)
        d_pre[:, t] = step
        dm, dc, dn = da, dc1 * f_g, dn1 * f_g
        dh_rec = torch.einsum("bhe,hde->bhd", step.reshape(b, nh, e), r).reshape(b, d)
    return d_pre, dc, dn, dh_rec, dm


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_cuda(**tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"slstm_scan kernel wants contiguous float32 tensors on {dev}; "
                             f"{name} is {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")


def _check_shapes(**shapes) -> None:
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"slstm_scan: {name} has shape {tuple(t.shape)}, wants {want}")


def _check(err: int, what: str, b: int, d: int, nh: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} at B {b}, D {d}, NH {nh}: "
                           f"{_PLAN_ERRORS.get(err, f'CUDA error {err}')}")


def plan(b: int, d: int, nh: int, backward: bool = False, device=None) -> dict:
    """The kernel's launch plan on ``device`` (default: the current card),
    as :data:`PLAN_FIELDS`: units a block, grid, lines of r a block (the
    forward's 4U columns, the backward's U rows), warps holding them,
    segments a line, registers of r a thread, heads a block's d pre gather
    spans, shared memory bytes, exchange buffer bytes, blocks an SM holds,
    SMs, and 1 when the tiling is exact (every warp's products unguarded:
    xlstm-1.3b's width at an even B).  Raises when r's slice does not fit
    the registers or the grid cannot be launched as one cooperative
    grid."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(device):
        err = _build.library("slstm_scan").slstm_scan_plan(b, d, nh, int(backward),
                                                          ctypes.addressof(out))
    got = dict(zip(PLAN_FIELDS, out))
    _check(err, f"slstm_scan {'backward' if backward else 'forward'} plan {got}", b, d, nh)
    return got


def exchange_words(b: int, d: int, backward: bool = False) -> int:
    """The 8-byte words of a kernel's exchange buffer: two slots of the
    step's published values, h (B, D) for the forward, d pre (B, 4D) for the
    backward."""
    return 2 * b * d * (4 if backward else 1)


def _exchange(b: int, d: int, backward: bool, device) -> torch.Tensor:
    return torch.empty(exchange_words(b, d, backward), dtype=torch.int64, device=device)


def _forward_args(wx, r, bias, c0, n0, h0, m0, save: bool):
    b, s, d, nh, dh = _sizes(wx, r)
    _check_cuda(wx=wx, r=r, bias=bias, c0=c0, n0=n0, h0=h0, m0=m0)
    _check_shapes(bias=(bias, (4 * d,)), c0=(c0, (b, d)), n0=(n0, (b, d)), h0=(h0, (b, d)),
                  m0=(m0, (b, d)))
    if s < 1:
        raise ValueError("slstm_scan: the sequence is empty")
    hs = torch.empty((b, s, d), dtype=torch.float32, device=wx.device)
    c, n, h, m = (torch.empty((b, d), dtype=torch.float32, device=wx.device) for _ in range(4))
    pre = torch.empty((b, s, 4 * d) if save else (0,), dtype=torch.float32, device=wx.device)
    cnm = torch.empty((3, b, s, d) if save else (0,), dtype=torch.float32, device=wx.device)
    xch = _exchange(b, d, False, wx.device)
    outs = (hs, c, n, h, m, pre, cnm)
    ptrs = (wx.data_ptr(), r.data_ptr(), bias.data_ptr(), c0.data_ptr(), n0.data_ptr(),
            h0.data_ptr(), m0.data_ptr(), hs.data_ptr(), c.data_ptr(), n.data_ptr(),
            h.data_ptr(), m.data_ptr(), pre.data_ptr() if save else None,
            cnm.data_ptr() if save else None, xch.data_ptr(), xch.numel(), b, s, d, nh)
    return outs, ptrs, xch


def slstm_scan_cuda(wx, r, bias, c0, n0, h0, m0, save: bool = False):
    """The forward scan (see :func:`slstm_scan_plain`) on CUDA tensors: the
    kernel, one launch."""
    outs, ptrs, _ = _forward_args(wx, r, bias, c0, n0, h0, m0, save)
    err = _build.library("slstm_scan").slstm_scan_forward(*ptrs, _build.stream_of(wx))
    b, _, d, nh = ptrs[-4:]
    _check(err, "slstm_scan_forward", b, d, nh)
    _build.count_launch(slstm_scan_cuda)
    return outs


slstm_scan_cuda.launches = 0


def _backward_args(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0):
    b, s, d = d_hs.shape
    nh, dh, e = r.shape
    _check_cuda(d_hs=d_hs, d_c=d_c, d_n=d_n, d_h=d_h, d_m=d_m, r=r, pre=pre, cnm=cnm, c0=c0,
                n0=n0, m0=m0)
    _check_shapes(r=(r, (nh, d // nh, 4 * (d // nh))), pre=(pre, (b, s, 4 * d)),
                  cnm=(cnm, (3, b, s, d)),
                  **{k: (v, (b, d)) for k, v in dict(d_c=d_c, d_n=d_n, d_h=d_h, d_m=d_m, c0=c0,
                                                     n0=n0, m0=m0).items()})
    if s < 1:
        raise ValueError("slstm_scan_backward: the sequence is empty")
    d_pre = torch.empty((b, s, 4 * d), dtype=torch.float32, device=d_hs.device)
    d_c0, d_n0, d_h0, d_m0 = (torch.empty((b, d), dtype=torch.float32, device=d_hs.device)
                              for _ in range(4))
    xch = _exchange(b, d, True, d_hs.device)
    outs = (d_pre, d_c0, d_n0, d_h0, d_m0)
    ptrs = (*(t.data_ptr() for t in (d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0)),
            *(t.data_ptr() for t in outs), xch.data_ptr(), xch.numel(), b, s, d, nh)
    return outs, ptrs, xch


def slstm_scan_backward_cuda(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0):
    """The reverse scan (see :func:`slstm_scan_backward_plain`) on CUDA
    tensors: the kernel, one launch, with its exchange buffer of d pre
    (:func:`exchange_words`)."""
    outs, ptrs, _ = _backward_args(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0)
    err = _build.library("slstm_scan").slstm_scan_backward(*ptrs, _build.stream_of(d_hs))
    b, _, d, nh = ptrs[-4:]
    _check(err, "slstm_scan_backward", b, d, nh)
    _build.count_launch(slstm_scan_backward_cuda)
    return outs


slstm_scan_backward_cuda.launches = 0


# ---------------------------------------------------------------------------
# The timed instances and the exchange probe (phase 4k)
# ---------------------------------------------------------------------------


def split_words(s: int, grid: int) -> int:
    """A timed launch's buffer, in 8-byte words: S arrival counters, grid x S
    tickets, grid x S x 8 phase cycles, grid x 4 clocks."""
    return s + grid * s * (1 + _SPLIT_SLOTS) + 4 * grid


def read_split(buf, s: int, grid: int, phases) -> dict:
    """A timed launch's buffer (int64, :func:`split_words` long) as each
    phase's mean nanoseconds a step, in block 0 (``block0``) and in the
    block whose arrival ticket was the last of its step (``last``), with
    their sums, the SM clock (GHz: cycles over the global timer's ns across
    the loop, block 0's) and ``complete`` (every step's counter reads the
    grid)."""
    buf = np.asarray(buf, dtype=np.int64)
    o = s + grid * s
    counters = buf[:s]
    tickets = buf[s:o].reshape(grid, s)
    cycles = buf[o:o + grid * s * _SPLIT_SLOTS].reshape(grid, s, _SPLIT_SLOTS)[..., :len(phases)]
    clocks = buf[o + grid * s * _SPLIT_SLOTS:].reshape(grid, 4)
    ghz = (clocks[:, 2] - clocks[:, 0]) / np.maximum(clocks[:, 3] - clocks[:, 1], 1)
    last = tickets.argmax(axis=0)
    ns = cycles / ghz[:, None, None]
    first = ns[0].mean(axis=0)
    final = ns[last, np.arange(s)].mean(axis=0)
    return {"block0": dict(zip(phases, first.tolist())), "last": dict(zip(phases, final.tolist())),
            "block0_sum": float(first.sum()), "last_sum": float(final.sum()),
            "ghz": float(ghz[0]), "complete": bool((counters == grid).all())}


def step_split(backward: bool, *args) -> Tuple[dict, tuple]:
    """Runs the timed instance of the forward (``args`` as
    :func:`slstm_scan_cuda`'s, ``save`` last) or the backward (as
    :func:`slstm_scan_backward_cuda`'s) once: (:func:`read_split` of its
    buffer, its outputs).  Not counted as a launch of the main path."""
    outs, ptrs, xch = (_backward_args if backward else _forward_args)(*args)
    lib = _build.library("slstm_scan")
    entry = lib.slstm_backward_split if backward else lib.slstm_forward_split
    b, s, d, nh = ptrs[-4:]
    grid = plan(b, d, nh, backward)["grid"]
    buf = torch.zeros(split_words(s, grid), dtype=torch.int64, device=xch.device)
    _check(entry(*ptrs, buf.data_ptr(), _build.stream_of(xch)),
           f"slstm {'backward' if backward else 'forward'} split", b, d, nh)
    phases = SPLIT_PHASES["backward" if backward else "forward"]
    return read_split(buf.cpu().numpy(), s, grid, phases), outs


def exchange_probe(b: int, d: int, nh: int, s: int, tagged: bool = True, device=None) -> None:
    """One launch of S rounds of the forward's exchange alone on its grid
    (no arithmetic): the tagged words the kernels use, or the flag scheme
    (``tagged=False``).  Time it with CUDA events."""
    grid = plan(b, d, nh, device=device)["grid"]
    buf = torch.empty(2 * b * d + grid, dtype=torch.int64,
                      device=torch.device("cuda") if device is None else device)
    _build.check(_build.library("slstm_scan").slstm_exchange_probe(
        int(tagged), b, d, nh, s, buf.data_ptr(), _build.stream_of(buf)), "slstm_exchange_probe")


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------

_T = torch.Tensor


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=(), device_types="cpu")
def slstm_scan(wx: _T, r: _T, bias: _T, c0: _T, n0: _T, h0: _T, m0: _T,
               save: bool) -> Tuple[_T, _T, _T, _T, _T, _T, _T]:
    """The sLSTM scan: (hs, c, n, h, m, pre, cnm); see :func:`slstm_scan_plain`."""
    return slstm_scan_plain(wx, r, bias, c0, n0, h0, m0, save)


slstm_scan.register_kernel("cuda", slstm_scan_cuda)


@slstm_scan.register_fake
def _slstm_scan_fake(wx, r, bias, c0, n0, h0, m0, save):
    b, s, d4 = wx.shape
    d = d4 // 4
    return (wx.new_empty((b, s, d)), *(wx.new_empty((b, d)) for _ in range(4)),
            wx.new_empty((b, s, d4) if save else (0,)),
            wx.new_empty((3, b, s, d) if save else (0,)))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=(), device_types="cpu")
def slstm_scan_backward(d_hs: _T, d_c: _T, d_n: _T, d_h: _T, d_m: _T, r: _T, pre: _T, cnm: _T,
                        c0: _T, n0: _T, m0: _T) -> Tuple[_T, _T, _T, _T, _T]:
    """The reverse scan: (d_pre, d_c0, d_n0, d_h0, d_m0); see
    :func:`slstm_scan_backward_plain`."""
    return slstm_scan_backward_plain(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0)


slstm_scan_backward.register_kernel("cuda", slstm_scan_backward_cuda)


@slstm_scan_backward.register_fake
def _slstm_scan_backward_fake(d_hs, d_c, d_n, d_h, d_m, r, pre, cnm, c0, n0, m0):
    return (pre.new_empty(pre.shape), *(d_c.new_empty(d_c.shape) for _ in range(4)))


def _setup_context(ctx, inputs, output):
    wx, r, bias, c0, n0, h0, m0, save = inputs
    hs, _, _, _, _, pre, cnm = output
    ctx.saved = save
    ctx.save_for_backward(r, c0, n0, h0, m0, hs, pre, cnm)
    ctx.mark_non_differentiable(pre, cnm)


def _backward(ctx, d_hs, d_c, d_n, d_h, d_m, _d_pre, _d_cnm):
    if not ctx.saved:
        raise RuntimeError("slstm_scan ran with save=False, so it kept nothing to differentiate: "
                           "call it through ops.slstm_scan, which saves when autograd needs it")
    r, c0, n0, h0, m0, hs, pre, cnm = ctx.saved_tensors
    b, s, d = hs.shape
    nh, dh, e = r.shape

    def grad(g, like):
        return torch.zeros_like(like) if g is None else g.contiguous()

    d_pre, d_c0, d_n0, d_h0, d_m0 = torch.ops.repro_torch.slstm_scan_backward(
        grad(d_hs, hs), grad(d_c, c0), grad(d_n, c0), grad(d_h, c0), grad(d_m, c0), r, pre, cnm,
        c0, n0, m0)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).reshape(b * s, nh, dh)
    d_r = torch.matmul(h_prev.permute(1, 2, 0), d_pre.reshape(b * s, nh, e).transpose(0, 1))
    return d_pre, d_r, d_pre.sum((0, 1)), d_c0, d_n0, d_h0, d_m0, None


slstm_scan.register_autograd(_backward, setup_context=_setup_context)


def _recurrent_flops(b: int, s: int, r_shape) -> int:
    nh, dh, e = r_shape
    return 2 * b * s * nh * dh * e


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_flops(wx, r, *args, out_shape=None, **kwargs) -> int:
    """h_{t-1} @ r each step: 2 B S NH dh 4dh."""
    return _recurrent_flops(wx[0], wx[1], r)


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_scan_backward_flops(d_hs, d_c, d_n, d_h, d_m, r, *args, out_shape=None,
                               **kwargs) -> int:
    """d_pre @ r^T each step (d h_{t-1}): 2 B S NH dh 4dh; d_r's product is
    a ``matmul`` outside, which the registry counts."""
    return _recurrent_flops(d_hs[0], d_hs[1], r)
