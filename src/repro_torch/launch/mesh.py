"""Mesh definitions: the twin of ``repro.launch.mesh`` on one card.

Functions, not module-level constants, so importing this module touches no
device."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import not_ported

MESH_ITEM = "§1 item 2: mesh and TPU-only tooling"


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """One device as the reference's host mesh: data-parallel shape (1, 1)
    over the axes ("data", "model").  The step makers run on it as on no
    mesh."""

    device: torch.device
    shape: tuple = (1, 1)
    axis_names: tuple = ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    shape = "2 x 16 x 16" if multi_pod else "16 x 16"
    raise not_ported(f"make_production_mesh (the {shape} mesh)", MESH_ITEM)


def make_host_mesh(device=None) -> HostMesh:
    """The local device (``None``: the card; raises without one), the
    single-card stand-in for the reference's data-parallel host mesh."""
    return HostMesh(resolve_device(device))
