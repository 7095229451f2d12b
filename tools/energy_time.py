#!/usr/bin/env python3
"""The Ising-energy kernel's time on the card, through whichever
``repro_torch`` is first on the path.

    PYTHONPATH=src python3 tools/energy_time.py

To compare a change with the commit it started from in one call, unpack the
parent with ``git archive`` into ``build/parent`` and alternate:
``for p in build/parent/src src src build/parent/src; do PYTHONPATH=$p
python3 tools/energy_time.py; done``.

Prints the card and its power limit, then, for each shape below, the
milliseconds per call (CUDA events around 500 back-to-back calls after a
warm-up; a call that takes less device time than the host needs to launch
it measures the host), and under torch.profiler the device launches one
call makes (by name) and the device time per call (CUPTI):

  * ``ops``: ``ops.ising_energy`` as ``cobi_anneal(reduce="none")`` calls
    it on the main path: int8 spins of 8 reads of a 20-spin chip-range
    integer instance, h (20,), J (20, 20);
  * ``entry``: the kernel's C entry on the operands the main path's call
    hands it (the int8 (8, 20) spins where the entry reads the live extent;
    the zero-padded (8, 128) float32 operands where it takes tile-aligned
    shapes only), its output made beforehand;
  * ``floor``: the C entry at its smallest shape (R 1, n 1; R 8, n 8 where
    it takes tile-aligned shapes only): the launch floor;
  * ``twin``: ``ising_energy_cuda`` on the (8, 128) float32 padded operands;
  * ``stack``: ``ising_energy_batched_cuda`` on the farm's two-launch stack,
    96 jobs x 8 reads x 128 lanes, float32.

Then the host's side of one ``ops`` call, step by step (microseconds a
step on the host's clock, the median of 2000 repeats after a warm-up):
``torch.empty`` of the output, ``_build.stream_of``, ``_build.library``,
``_build.count_launch``, the C entry's ``ctypes`` call with its check, and
the whole ``ops.ising_energy`` call.

Needs the CUDA toolkit and a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPS = 500


def events_ms(fn) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def profiled(fn, reps: int = 200) -> tuple[list, float]:
    """(device launches of one call by name, device ms per call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return names, us / reps / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("energy_time: torch.cuda.is_available() is False: it needs a GPU")
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ising_energy as ie

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; repro_torch: {ops.__file__}")
    dev = torch.device("cuda")
    g = np.random.default_rng(0)

    def instance(b: int, n: int):
        j = np.triu(g.integers(-14, 15, (b, n, n)), 1).astype(np.float32)
        return (torch.tensor(g.integers(-14, 15, (b, n)).astype(np.float32), device=dev),
                torch.tensor(j + j.transpose(0, 2, 1), device=dev))

    def spins(*shape):
        return torch.tensor(np.where(g.random(shape) < 0.5, 1, -1).astype(np.int8), device=dev)

    h, j = (t[0] for t in instance(1, 20))
    s8 = spins(8, 20)
    hp, jp, sp = (torch.zeros(shape, device=dev) for shape in ((1, 128), (128, 128), (8, 128)))
    hp[0, :20], jp[:20, :20], sp[:, :20] = h, j, s8
    hs, js = instance(96, 128)
    ss = spins(96, 8, 128).float()

    lib = _build.library("ising_energy")
    live_extent = len(_build._ARGTYPES["ising_energy"]["ising_energy"]) > 8

    def entry(s, hh, jj):
        """The C entry on one instance, s (R, n), hh (1, n), jj (n, n)."""
        r, n = s.shape
        out = torch.empty((1, r), device=dev)
        stream = _build.stream_of(s)
        if live_extent:
            args = (s.data_ptr(), int(s.dtype == torch.int8), hh.data_ptr(), jj.data_ptr(),
                    out.data_ptr(), 1, r, n, s.numel(), s.stride(0), n, jj.numel(), jj.stride(0),
                    stream)
        else:
            args = (s.data_ptr(), hh.data_ptr(), jj.data_ptr(), out.data_ptr(), 1, r, n, stream)
        return lambda: _build.check(lib.ising_energy(*args), "ising_energy")

    if live_extent:
        main_entry = entry(s8, h[None], j)
        floor = entry(torch.ones((1, 1), dtype=torch.int8, device=dev), h[None, :1],
                      j[:1, :1].contiguous())
        floor_shape = "R 1, n 1, int8"
    else:
        main_entry = entry(sp, hp, jp)
        floor = entry(sp[:, :8].contiguous(), hp[:, :8].contiguous(), jp[:8, :8].contiguous())
        floor_shape = "R 8, n 8, float32"
    want = ie.ising_energy_plain(s8.float(), h[None], j)
    if not torch.equal(ops.ising_energy(s8, h, j), want):
        sys.exit("energy_time: ops.ising_energy != its plain version")
    cases = {
        "ops": (lambda: ops.ising_energy(s8, h, j), "R 8, n 20, int8 spins, unpadded h and J"),
        "entry": (main_entry, "R 8, n 20, int8" if live_extent else "R 8, N 128, float32"),
        "floor": (floor, floor_shape),
        "twin": (lambda: ie.ising_energy_cuda(sp, hp, jp), "R 8, N 128, float32"),
        "stack": (lambda: ie.ising_energy_batched_cuda(ss, hs[:, None], js),
                  "B 96, R 8, N 128, float32"),
    }
    for label, (fn, shape) in cases.items():
        ms = events_ms(fn)
        names, dev_ms = profiled(fn)
        print(f"{label} ({shape}): {ms:.5f} ms a call (events); {len(names)} device launch(es) a "
              f"call {names}; device {dev_ms:.5f} ms a call (profiler)")

    counter = type("Counter", (), {"launches": 0, "route_launches": None})
    steps = {
        "torch.empty": lambda: torch.empty((1, 8), device=dev),
        "stream_of": lambda: _build.stream_of(s8),
        "library": lambda: _build.library("ising_energy"),
        "count_launch": lambda: _build.count_launch(counter),
        "C entry": main_entry,
        "ops.ising_energy": cases["ops"][0],
    }
    split = []
    for label, fn in steps.items():
        times = []
        for _ in range(200):
            fn()
        for _ in range(2000):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        split.append(f"{label} {float(np.median(times)) * 1e6:.2f}")
    print("host us a step (median): " + "; ".join(split))


if __name__ == "__main__":
    main()
