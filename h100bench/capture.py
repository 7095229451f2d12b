"""What the solver saw, request by request, for the comparison that decides
``correct``: the request's problem (mu, beta) as the engine formed it, each
formulation handed to the rounding (its problem and its real h, J), each
rounded instance submitted to the solver backend, and the solver's answer
for it (best read's spins and energy).

It wraps three entry points of the program for the whole run, on every run:
``problem_from_embeddings`` as the serving engine calls it,
``improved_ising`` as the pipeline calls it, and the engine's backend's
``submit``, which carries the request's id as its ``tag``.  Each pipeline
step runs on the engine's driver thread from the formulation to its
submissions without yielding, so the problem and formulation a thread
formed last belong to the next tag it submits.  A missing entry point
raises: a rename in the program must not empty the check quietly.

Only references are kept (no copies, no host syncs on the timed path), and
:meth:`InstanceLog.drop` frees a request's record as soon as the harness
knows it will not be judged.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading


@dataclasses.dataclass
class Instance:
    h: object  # the rounded instance, as submitted
    j: object
    energy: object = None  # the solver's best read: energy and spins
    spins: object = None


@dataclasses.dataclass
class Formulation:
    mu: object
    beta: object
    m: int
    lam: float
    gamma: float | None
    h: object  # the real (h, J) the rounding took
    j: object
    instances: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RequestLog:
    mu: object = None  # the request's whole problem
    beta: object = None
    formulations: list = dataclasses.field(default_factory=list)
    unformulated: int = 0  # instances submitted with no captured formulation


# (module, attribute): the program's functions wrapped, by where they are called.
PROBLEM = ("repro_torch.serving.engine", "problem_from_embeddings")
FORMULATION = ("repro_torch.core.pipeline", "improved_ising")


class InstanceLog:
    def __init__(self):
        self.logs: dict[int, RequestLog] = {}
        self._lock = threading.Lock()
        self._pending: dict[int, dict] = {}  # thread id -> what it formed last
        self._undo: list = []

    def install(self, engine) -> None:
        self._wrap(*PROBLEM, self._on_problem)
        self._wrap(*FORMULATION, self._on_formulation)
        backend = engine.backend
        if backend is None or not callable(getattr(backend, "submit", None)):
            raise AttributeError("the engine has no solver backend with submit()")
        real = backend.submit

        def submit(ising, key, *args, tag=None, **kwargs):
            inst = self._on_submit(ising, tag)
            fut = real(ising, key, *args, tag=tag, **kwargs)
            if inst is not None:
                fut.add_done_callback(lambda f, inst=inst: self._on_result(inst, f))
            return fut

        backend.submit = submit
        self._undo.append((backend, "submit", None))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)  # the instance attribute shadowing the method
            else:
                setattr(owner, attr, fn)
        self._undo.clear()

    def drop(self, tag: int) -> None:
        with self._lock:
            self.logs.pop(tag, None)

    def _wrap(self, module: str, attr: str, hook) -> None:
        owner = importlib.import_module(module)
        fn = getattr(owner, attr)  # raises where the program renamed it

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            hook(out, *args, **kwargs)
            return out

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn))

    def _slot(self) -> dict:
        return self._pending.setdefault(threading.get_ident(), {})

    def _on_problem(self, problem, *args, **kwargs) -> None:
        with self._lock:
            self._slot()["problem"] = problem

    def _on_formulation(self, ising, problem, gamma=None, mu_b=None) -> None:
        with self._lock:
            self._slot()["formulation"] = Formulation(
                mu=problem.mu, beta=problem.beta, m=int(problem.m), lam=float(problem.lam),
                gamma=gamma, h=ising.h, j=ising.j)

    def _on_submit(self, ising, tag) -> Instance | None:
        if tag is None:
            return None
        with self._lock:
            slot = self._slot()
            log = self.logs.setdefault(tag, RequestLog())
            problem = slot.pop("problem", None)
            if problem is not None:
                log.mu, log.beta = problem.mu, problem.beta
            form = slot.pop("formulation", None)
            if form is not None:
                log.formulations.append(form)
            inst = Instance(h=ising.h, j=ising.j)
            if log.formulations:
                log.formulations[-1].instances.append(inst)
            else:
                log.unformulated += 1
            return inst

    @staticmethod
    def _on_result(inst: Instance, fut) -> None:
        try:
            res = fut.result(0.0)
        except Exception:  # noqa: BLE001 -- a failed job is the request's failure
            return
        inst.energy, inst.spins = res.energies, res.spins
