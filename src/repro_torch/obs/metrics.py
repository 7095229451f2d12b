"""Unified metrics registry: typed counters / gauges / histograms with
labeled families.

Every layer of the serving stack registers its counters here instead of
keeping private ``self._stats.x += 1`` fields; the scattered ``stats()``
dicts (engine, admission, router, farm, encoder, breakers) are rebuilt as
*views* over this registry, so the numbers cannot drift between layers.

Model (a deliberately small slice of the Prometheus data model):

* A **family** is a named metric with a fixed tuple of label names
  (``registry.counter("farm_jobs_total", labels=("chip",))``).
* ``family.labels(chip=3)`` resolves one **child** (a concrete series);
  children are cached, so hot paths resolve once and hold the handle.
* A family declared with no labels IS its own child (``family.inc()``).

Histograms are log-bucketed (geometric bucket bounds, suited to latencies
spanning microseconds..minutes and joules spanning similar decades) and
additionally maintain an EWMA of observed values -- the encoder stage's
per-workload sec/token estimates read that EWMA straight from the
registry (see ``EncoderStage.estimate_seconds``).

Thread safety: one lock per family guards child creation and value
updates.  The hot path is per-job (tens of updates per request), not
per-spin, so a plain lock is cheap enough.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "log_buckets"]


def log_buckets(lo: float = 1e-6, hi: float = 1e3,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Geometric bucket upper bounds covering [lo, hi] with
    ``per_decade`` buckets per factor of 10."""
    if not (lo > 0.0 and hi > lo and per_decade > 0):
        raise ValueError("need 0 < lo < hi and per_decade > 0")
    n = int(math.ceil((math.log10(hi) - math.log10(lo)) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


def _label_values(names: Tuple[str, ...], kv: dict) -> Tuple[str, ...]:
    if set(kv) != set(names):
        raise ValueError(
            f"expected labels {names}, got {tuple(sorted(kv))}")
    return tuple(str(kv[n]) for n in names)


class _Family:
    """Shared family machinery: label resolution + child cache."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: Tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labels:  # label-less family is its own single child
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        key = _label_values(self.label_names, kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    # Label-less convenience: family.inc()/set()/observe() forward to the
    # single child (raises KeyError if the family declared labels).
    def _solo(self):
        return self._children[()]


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    @property
    def value(self) -> float:
        return self._solo().value

    def total(self) -> float:
        """Sum over every child series."""
        return sum(c.value for _, c in self.children())


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._solo().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._solo().inc(-n)

    @property
    def value(self) -> float:
        return self._solo().value


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count", "vmin", "vmax",
                 "ewma", "_alpha", "_lock")

    def __init__(self, bounds: Tuple[float, ...], alpha: float):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1 overflow bucket
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.ewma = 0.0
        self._alpha = alpha
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):  # noqa: B007
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            self.ewma = (v if self.count == 1
                         else (1.0 - self._alpha) * self.ewma
                         + self._alpha * v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help_: str, labels: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None,
                 ewma_alpha: float = 0.3):
        self.buckets = tuple(buckets) if buckets else log_buckets()
        self.ewma_alpha = float(ewma_alpha)
        super().__init__(name, help_, labels)

    def _new_child(self):
        return _HistogramChild(self.buckets, self.ewma_alpha)

    def observe(self, v: float) -> None:
        self._solo().observe(v)


class MetricsRegistry:
    """Process-local registry of metric families, keyed by name.

    Re-registering an existing name returns the existing family (kind and
    label names must match), so independent components can share series.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name, help_, labels, **kw) -> _Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                return fam
            fam = cls(name, help_, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  ewma_alpha: float = 0.3) -> Histogram:
        return self._register(Histogram, name, help_, labels,
                              buckets=buckets, ewma_alpha=ewma_alpha)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # ---------------------------------------------------------- export

    def snapshot(self) -> dict:
        """Plain-dict snapshot of every series (benchmark reports and the
        example service print from this instead of hand-rolled dicts)."""
        out = {}
        for fam in self.families():
            series = []
            for key, child in sorted(fam.children()):
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels, "count": child.count,
                        "sum": child.sum, "mean": child.mean,
                        "ewma": child.ewma,
                        "min": child.vmin if child.count else 0.0,
                        "max": child.vmax if child.count else 0.0,
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format snapshot."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children()):
                base = _fmt_labels(fam.label_names, key)
                if fam.kind == "histogram":
                    cum = 0
                    for bound, c in zip(child.bounds, child.counts):
                        cum += c
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(fam.label_names + ('le',), key + (f'{bound:g}',))}"
                            f" {cum}")
                    cum += child.counts[-1]
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(fam.label_names + ('le',), key + ('+Inf',))}"
                        f" {cum}")
                    lines.append(f"{fam.name}_sum{base} {child.sum:g}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    lines.append(f"{fam.name}{base} {child.value:g}")
        return "\n".join(lines) + "\n"


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    body = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + body + "}"
