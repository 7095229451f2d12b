"""Per-rank cost of a step: the counterpart of ``repro.analysis.hlo``.

The reference walks the optimized HLO of a compiled step; the port has no
HLO (it runs eagerly), so it counts the ops as they dispatch instead, which
is why this module is not named ``hlo``.  :func:`analyze` runs ``fn`` under
``FakeTensorMode`` (shapes only, no storage) with a dispatch mode that
counts, per rank:

  * flops: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention) for every op on plain tensors;
  * traffic_bytes: 2x the output bytes of every materialising op (views
    and metadata ops excluded).  Eager mode fuses nothing, so this is an
    upper bound where the reference's model counts a fusion's output once;
  * collectives: the output bytes of every collective, by the reference's
    kinds (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute), and collective_link_bytes with all-reduce
    counted twice (a ring moves about twice its payload);
  * peak_bytes: the most bytes alive at once among the plain tensors the
    run makes: each storage counted once, at the largest of its tensors
    seen, an expanded view at its storage's (so a rank's block taken as a
    view of a global input counts as the block), and freed when its last
    tensor dies; tensors made before the run are not counted.

A ``DTensor`` op dispatches twice: once on the ``DTensor`` (global shapes)
and again on each rank's local tensors.  Only ops on plain tensors are
counted, so the counts are one rank's.

Keys returned: flops, traffic_bytes, collectives, collective_bytes,
collective_link_bytes, collective_calls (count by kind), peak_bytes.
(``MemTracker`` counts a ``DTensor`` at its global size, so it cannot give
one rank's peak.)
"""

from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# Op names (overload packet names) of the collectives, functional and c10d.
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}

# Ops that move no bytes: views, metadata and waits.
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "expand", "t", "transpose", "permute", "slice",
    "select", "detach", "alias", "as_strided", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "view_as_real", "view_as_complex",
    "_reshape_alias", "lift_fresh", "empty", "empty_like", "empty_strided", "wait_tensor",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_to_copy_noop", "_local_scalar_dense", "set_", "resize_",
}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts one rank's flops, traffic and collectives (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.traffic_bytes = 0
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.calls = {c: 0 for c in COLLECTIVES}
        self.live: dict = {}  # storage -> [bytes counted, tensors alive]
        self.live_bytes = 0
        self.peak_bytes = 0

    def _track(self, out) -> None:
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            nbytes = min(t.numel() * t.element_size(), st.nbytes())
            entry = self.live.setdefault(key, [0, 0])
            if nbytes > entry[0]:
                self.live_bytes += nbytes - entry[0]
                entry[0] = nbytes
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch.distributed.tensor import DTensor

        leaves, _ = tree_flatten((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return out  # the global op; its local ops dispatch on their own
        self._track(out)
        name = func.overloadpacket.__name__
        kind = _KINDS.get(name)
        if kind is not None:
            self.collectives[kind] += _nbytes(out) if name not in ("allreduce_",) else \
                _nbytes(args[0])
            self.calls[kind] += 1
            return out
        packet = func.overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        if name not in _NO_BYTES:
            self.traffic_bytes += 2 * _nbytes(out)
        return out

    def result(self) -> dict:
        return {
            "flops": float(self.flops),
            "traffic_bytes": float(self.traffic_bytes),
            "collectives": dict(self.collectives),
            "collective_bytes": float(sum(self.collectives.values())),
            "collective_link_bytes": float(sum(
                v * (2.0 if k == "all-reduce" else 1.0) for k, v in self.collectives.items())),
            "collective_calls": dict(self.calls),
            "peak_bytes": float(self.peak_bytes),
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode` and return
    its per-rank counts, with ``fn``'s result under the key ``out``.  It
    runs under the caller's ``FakeTensorMode`` (make the arguments under
    it, so that nothing allocates storage), or under a new one if none is
    active."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
    mode = CostMode()
    with contextlib.nullcontext() if active else FakeTensorMode(allow_non_fake_inputs=True):
        with mode:
            out = fn(*args, **kwargs)
    return {**mode.result(), "out": out}
