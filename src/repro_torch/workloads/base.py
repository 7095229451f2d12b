"""Workload registry: name -> builder of :class:`SelectionRequest`.

A workload is just a function from domain inputs (a document, a query +
candidates, a list of documents, ...) to a ``SelectionRequest`` -- items
plus a :class:`repro_torch.serving.api.KofnSpec`.  The registry gives launchers
and benchmarks a stable name space (``--workload rerank``) without the
engine knowing any workload exists.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.serving.api import SelectionRequest

_REGISTRY: Dict[str, "Workload"] = {}


@dataclasses.dataclass(frozen=True)
class Workload:
    """One registered workload: ``build(**kwargs) -> SelectionRequest``."""

    name: str
    describe: str
    build: Callable[..., SelectionRequest]


def register_workload(name: str, describe: str):
    """Decorator: register ``fn`` as workload ``name``.

    ``fn`` must return a :class:`SelectionRequest`; the registry stamps
    ``workload=name`` on it so responses carry the zoo name.
    """

    def deco(fn: Callable[..., SelectionRequest]):
        def build(**kwargs) -> SelectionRequest:
            req = fn(**kwargs)
            if req.workload != name:
                req = dataclasses.replace(req, workload=name)
            return req

        _REGISTRY[name] = Workload(name=name, describe=describe, build=build)
        return fn

    return deco


def get_workload(name: str) -> Workload:
    if name not in _REGISTRY:
        from repro_torch import workloads  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown workload {name!r}; have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available_workloads() -> List[str]:
    from repro_torch import workloads  # noqa: F401  (populates the registry)

    return sorted(_REGISTRY)


def build_request(name: str, **kwargs) -> SelectionRequest:
    """Build a ``SelectionRequest`` for registered workload ``name``."""
    return get_workload(name).build(**kwargs)
