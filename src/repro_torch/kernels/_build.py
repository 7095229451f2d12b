"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Libraries are built
at first use into ``build/kernels/`` at the repository root, named by a hash
of the sources, so a stale library is never loaded.  :func:`build_all` starts
one ``nvcc`` per source at once; a failed build raises with the compiler's
output.  Nothing here runs at import time: this module is imported on
machines with no CUDA toolkit.  No library links ``libcuda``: the flash
kernel's tensor maps need the driver's ``cuTensorMapEncodeTiled``, which
its source fetches at run time through the CUDA runtime's entry-point
lookup.

Thread-safe: the chip farm launches from its background drive thread and the
MCMC pool from its workers while the caller may launch from its own, so one
module lock serializes building and loading, each build writes a temporary
file named by process and thread before it moves into place, and
:func:`count_launch` keeps the wrappers' launch counts exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ising_energy", "cobi_dynamics", "mcmc_dynamics", "flash_attention", "slstm_scan")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "ising_energy": {"ising_energy": [P, I, P, P, P, I, I, I, L, L, L, L, L, P]},
    "cobi_dynamics": {
        "cobi_trajectory": [P, P, P, P, I, I, I, I, F, F, P],
        "cobi_readout": [P, P, P, P, P, P, P, I, I, I, I, F, F, P],
        "cobi_fused_best": [P] * 11 + [I, I, I, I, I, F, F, P],
        "cobi_anneal_rows": [],
    },
    "mcmc_dynamics": {
        "mcmc_sweep": [P] * 8 + [I] * 7 + [P],
        "mcmc_fused_best": [P] * 10 + [I] * 7 + [P],
        "mcmc_block_rows": [],
    },
    "flash_attention": {
        "flash_attention": [P] * 4 + [I] * 10 + [F, P],
        "flash_attention_wgmma": [P] * 4 + [I] * 9 + [F, P],
    },
    "slstm_scan": {
        "slstm_scan_plan": [I, I, I, I, P],
        "slstm_scan_forward": [P] * 15 + [I] * 5 + [P],
        "slstm_scan_backward": [P] * 17 + [I] * 5 + [P],
        "slstm_forward_split": [P] * 15 + [I] * 5 + [P, P],
        "slstm_backward_split": [P] * 17 + [I] * 5 + [P, P],
        "slstm_exchange_probe": [I] * 5 + [P, P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()  # guards _LIBS and the builds; library() nests build_all()
_COUNT_LOCK = threading.Lock()  # guards every wrapper's .launches


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # searches CUDA_HOME, PATH

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every library not yet built, one ``nvcc`` per source, all
    started together.  Returns {name: path}; raises if any build fails.
    Each build's ptxas report is kept beside its library as ``.log``."""
    with _LOCK:
        return _build_all(names)


def _build_all(names) -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            tmp.replace(targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every entry's
    ``argtypes`` and ``restype`` declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in _ARGTYPES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def count_launch(wrapper, route: str | None = None) -> None:
    """Add one to ``wrapper.launches`` (and to ``wrapper.route_launches[route]``
    for a wrapper with more than one kernel).  Under a lock: the MCMC pool's
    worker threads launch at once, and a bare ``+= 1`` can lose a count."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if route is not None:
            wrapper.route_launches[route] += 1


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it:
    the raw handle, read the way PyTorch's generated kernels read it, without
    building a ``torch.cuda.Stream`` (a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
