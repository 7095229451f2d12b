"""Mesh definitions: the twin of ``repro.launch.mesh`` on ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the process group that is already up (the
caller starts it: ``torchrun``, ``init_process_group``, or the ``fake``
backend of a dry run), on the device type of that group's backend: ``cuda``
for NCCL, ``cpu`` for gloo and the fake backend.  Functions, not
module-level constants, so importing this module touches no device and no
process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """One device as the reference's host mesh: data-parallel shape (1, 1)
    over the axes ("data", "model").  The step makers run on it as on no
    mesh."""

    device: torch.device
    shape: tuple = (1, 1)
    axis_names: tuple = ("data", "model")


def backend_device_type() -> str:
    """The device type of the default process group's backend: ``cuda``
    for NCCL, ``cpu`` for gloo and the fake backend."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple, axis_names: tuple):
    """A ``DeviceMesh`` of ``shape`` (row-major over the ranks) named
    ``axis_names``, over the default process group, which must hold exactly
    ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    want = math.prod(shape)
    found = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if found != want:
        have = "no process group" if found is None else f"a process group of {found} ranks"
        raise RuntimeError(f"a {' x '.join(map(str, shape))} mesh needs {want} ranks; found "
                           f"{have}")
    ranks = torch.arange(want, dtype=torch.int64).reshape(shape)
    return DeviceMesh(backend_device_type(), ranks, mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``.  Raises,
    naming the world size it found, unless the process group holds exactly
    256 (512) ranks; it never shrinks the mesh."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes)


def make_host_mesh(device=None) -> HostMesh:
    """The local device (``None``: the card; raises without one), the
    single-card stand-in for the reference's data-parallel host mesh."""
    return HostMesh(resolve_device(device))
