"""Dependency-free wall-clock metrics registry (DESIGN.md §11).

The trace plane (core/tracing.py) answers *what happened to one workflow*
in virtual time and is replay-derived; this module answers *what the
control plane itself costs* in wall-clock time and is deliberately
process-local: timings of a dead process are not history worth journaling,
so nothing here touches the event stream or the CAS.

One ``MetricsRegistry`` per service instance (never a module global — a
test process hosts many fabrics at once and their samples must not blend):

  * ``Counter`` / ``Gauge`` / ``Histogram`` with optional label names;
  * **bounded label sets**: each metric admits at most ``max_label_sets``
    distinct label-value combinations — further combinations fold into a
    single ``_other`` series instead of growing without bound (the
    cardinality contract the nightly soak asserts);
  * ``render()`` emits the Prometheus text exposition format served by
    ``GET /metrics`` on both the primary and the follower.

Histograms keep cumulative buckets (+sum/count), so quantiles are the
usual upper-bound interpolation — good enough for the BENCH trajectory,
with no per-sample storage.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator

#: default latency buckets (seconds): 5µs .. 10s, the fabric's hot paths
DEFAULT_BUCKETS = (5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
                   1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: the fold-in series for label combinations beyond a metric's cap
OVERFLOW_LABEL = "_other"


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    """Shared plumbing: label resolution with the cardinality cap."""

    type_name = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: tuple[str, ...], max_label_sets: int,
                 lock: threading.Lock) -> None:
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.max_label_sets = max_label_sets
        self._lock = lock
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[n]) for n in self.label_names)
        if key not in self._series and \
                len(self._series) >= self.max_label_sets:
            # cardinality cap: every further combination shares one series
            return (OVERFLOW_LABEL,) * len(self.label_names)
        return key

    def _labels_text(self, key: tuple[str, ...],
                     extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = [f'{n}="{_escape(v)}"'
                 for n, v in zip(self.label_names, key)]
        pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    @property
    def cardinality(self) -> int:
        return len(self._series)

    def render(self) -> Iterator[str]:          # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    type_name = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + value

    def child(self, **labels) -> "_CounterChild":
        """A bound handle for one label set: resolves the series key once
        (under the cardinality cap) so hot-path increments skip label
        validation entirely. Callers cache children per label combination."""
        with self._lock:
            key = self._key(labels)
            self._series.setdefault(key, 0.0)
        return _CounterChild(self, key)

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def render(self) -> Iterator[str]:
        for key in sorted(self._series):
            yield (f"{self.name}{self._labels_text(key)} "
                   f"{_format(self._series[key])}")


class Gauge(_Metric):
    type_name = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def render(self) -> Iterator[str]:
        for key in sorted(self._series):
            yield (f"{self.name}{self._labels_text(key)} "
                   f"{_format(self._series[key])}")


class _HistSeries:
    __slots__ = ("buckets", "total", "count")

    def __init__(self, n_buckets: int) -> None:
        self.buckets = [0] * n_buckets        # non-cumulative per-bound
        self.total = 0.0
        self.count = 0


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(self, name, help_text, label_names, max_label_sets, lock,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help_text, label_names, max_label_sets, lock)
        self.bounds = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.bounds))
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    series.buckets[i] += 1
                    break
            series.total += value
            series.count += 1

    def time(self, **labels) -> "_Timer":
        """Context manager: ``with hist.time(): ...`` observes the elapsed
        wall-clock seconds — the standard probe on the fabric's hot paths."""
        return _Timer(self, labels)

    def child(self, **labels) -> "_HistChild":
        """A bound handle for one label set (see ``Counter.child``): the
        series is resolved eagerly so per-sample observes are just
        lock + bucket insert."""
        with self._lock:
            key = self._key(labels)
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.bounds))
        return _HistChild(self, series)

    def count(self, **labels) -> int:
        with self._lock:
            series = self._series.get(self._key(labels))
            return 0 if series is None else series.count

    def sum(self, **labels) -> float:
        with self._lock:
            series = self._series.get(self._key(labels))
            return 0.0 if series is None else series.total

    def quantile(self, q: float, **labels) -> float:
        """Upper-bound bucket estimate of the q-quantile (0..1). Samples
        beyond the last bound report the last bound — an explicit floor,
        not an extrapolation."""
        with self._lock:
            series = self._series.get(self._key(labels))
            if series is None or series.count == 0:
                return 0.0
            rank = q * series.count
            seen = 0
            for i, bound in enumerate(self.bounds):
                seen += series.buckets[i]
                if seen >= rank:
                    return bound
            return self.bounds[-1]

    def render(self) -> Iterator[str]:
        for key in sorted(self._series):
            series = self._series[key]
            cum = 0
            for i, bound in enumerate(self.bounds):
                cum += series.buckets[i]
                yield (f"{self.name}_bucket"
                       f"{self._labels_text(key, (('le', _format(bound)),))}"
                       f" {cum}")
            yield (f"{self.name}_bucket"
                   f"{self._labels_text(key, (('le', '+Inf'),))}"
                   f" {series.count}")
            yield (f"{self.name}_sum{self._labels_text(key)} "
                   f"{_format(series.total)}")
            yield (f"{self.name}_count{self._labels_text(key)} "
                   f"{series.count}")


class _CounterChild:
    """Pre-resolved (metric, series-key) pair — the per-event fast path."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: tuple[str, ...]) -> None:
        self._counter = counter
        self._key = key

    def inc(self, value: float = 1.0) -> None:
        counter = self._counter
        with counter._lock:
            series = counter._series
            series[self._key] = series.get(self._key, 0.0) + value


class _HistChild:
    """Pre-resolved histogram series — observe without label resolution."""

    __slots__ = ("_hist", "_series")

    def __init__(self, hist: Histogram, series: _HistSeries) -> None:
        self._hist = hist
        self._series = series

    def observe(self, value: float) -> None:
        hist = self._hist
        series = self._series
        with hist._lock:
            for i, bound in enumerate(hist.bounds):
                if value <= bound:
                    series.buckets[i] += 1
                    break
            series.total += value
            series.count += 1


class _Timer:
    def __init__(self, hist: Histogram, labels: dict) -> None:
        self.hist = hist
        self.labels = labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)


def _format(v: float) -> str:
    """Integral floats render without the trailing ``.0`` (Prometheus
    parses both; the short form keeps the exposition stable and small)."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """A set of named metrics with one exposition surface.

    Re-registering a name returns the existing instrument (so probes in
    different modules can share a series) — but only if the type and label
    names agree, otherwise the registration is a programming error.
    """

    def __init__(self, *, max_label_sets: int = 128) -> None:
        self._lock = threading.Lock()
        self.max_label_sets = max_label_sets
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name: str, help_text: str,
                  labels: tuple[str, ...], max_label_sets: int | None,
                  **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) \
                        or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set")
                return existing
            metric = cls(name, help_text, tuple(labels),
                         max_label_sets if max_label_sets is not None
                         else self.max_label_sets,
                         self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labels: tuple[str, ...] = (),
                max_label_sets: int | None = None) -> Counter:
        return self._register(Counter, name, help_text, labels,
                              max_label_sets)

    def gauge(self, name: str, help_text: str = "",
              labels: tuple[str, ...] = (),
              max_label_sets: int | None = None) -> Gauge:
        return self._register(Gauge, name, help_text, labels,
                              max_label_sets)

    def histogram(self, name: str, help_text: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  max_label_sets: int | None = None) -> Histogram:
        return self._register(Histogram, name, help_text, labels,
                              max_label_sets, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def cardinality(self) -> dict[str, int]:
        """Distinct label sets per metric — the soak's bounded-cardinality
        assertion reads this instead of parsing the exposition."""
        with self._lock:
            return {name: m.cardinality for name, m in self._metrics.items()}

    def render(self) -> str:
        """The Prometheus text exposition (version 0.0.4)."""
        lines: list[str] = []
        # hold the registry lock across the walk: per-metric render() does
        # not re-lock, so concurrent probes cannot mutate mid-exposition
        with self._lock:
            for m in self._metrics.values():
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.type_name}")
                lines.extend(m.render())
        return "\n".join(lines) + "\n"
