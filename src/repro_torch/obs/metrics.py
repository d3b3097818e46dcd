"""Labelled metrics registry: counters, gauges, histograms.

Replaces the serving engine's ad-hoc ``self.counters`` dict with one
schema that feeds ``summarize()``, ``BENCH_serving.json`` rows, and the
tracer's counter tracks.  Everything is plain-Python and allocation-light
so the registry can sit on the engine hot path.

Identity model: a metric is ``(name, frozenset(labels.items()))``.
``value(name)`` aggregates across all label sets of a counter, which is
what bench rows want (``registry.value("preemptions")`` regardless of
which policy label fired them).
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return (name, tuple(sorted(labels.items())))


@dataclass
class Counter:
    name: str
    labels: Dict[str, Any]
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


@dataclass
class Gauge:
    """Last-write-wins gauge that also tracks min/max over its lifetime.

    With ``series_capacity > 0`` it keeps a bounded (t, value) time
    series — used for arena occupancy / queue depth tracks.
    """

    name: str
    labels: Dict[str, Any]
    value: Optional[float] = None
    max: Optional[float] = None
    min: Optional[float] = None
    series: Optional[Deque[Tuple[float, float]]] = field(default=None, repr=False)

    def set(self, value: float, t: Optional[float] = None) -> None:
        self.value = value
        self.max = value if self.max is None else max(self.max, value)
        self.min = value if self.min is None else min(self.min, value)
        if self.series is not None and t is not None:
            self.series.append((t, value))


@dataclass
class Histogram:
    """Reservoir of observations with exact percentiles.

    Bounded: keeps the most recent ``capacity`` samples plus running
    count/sum so rates stay exact even after the window slides.
    """

    name: str
    labels: Dict[str, Any]
    capacity: int = 4096
    count: int = 0
    sum: float = 0.0
    samples: Deque[float] = field(default_factory=collections.deque, repr=False)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if len(self.samples) >= self.capacity:
            self.samples.popleft()
        self.samples.append(value)

    def percentile(self, p: float) -> Optional[float]:
        """Exact percentile over the retained window; None when empty."""
        if not self.samples:
            return None
        xs = sorted(self.samples)
        rank = (p / 100.0) * (len(xs) - 1)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return xs[int(rank)]
        frac = rank - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


class MetricsRegistry:
    """Registry of counters/gauges/histograms keyed by (name, labels)."""

    def __init__(self, *, gauge_series: int = 0) -> None:
        self._counters: Dict[LabelKey, Counter] = {}
        self._gauges: Dict[LabelKey, Gauge] = {}
        self._histograms: Dict[LabelKey, Histogram] = {}
        self._gauge_series = gauge_series

    # -------------------------------------------------------------- lookup

    def counter(self, name: str, **labels: Any) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter(name, labels)
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            series: Optional[Deque[Tuple[float, float]]] = (
                collections.deque(maxlen=self._gauge_series)
                if self._gauge_series > 0 else None)
            g = self._gauges[k] = Gauge(name, labels, series=series)
        return g

    def histogram(self, name: str, **labels: Any) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(name, labels)
        return h

    # ----------------------------------------------------------- aggregate

    def value(self, name: str) -> float:
        """Sum of a counter across every label set (0.0 if never touched)."""
        return sum(c.value for c in self._counters.values() if c.name == name)

    def gauge_peak(self, name: str) -> Optional[float]:
        peaks = [g.max for g in self._gauges.values()
                 if g.name == name and g.max is not None]
        return max(peaks) if peaks else None

    def snapshot(self) -> Dict[str, Any]:
        """Flat, JSON-ready view of every metric (used by bench rows)."""

        def tag(m) -> str:
            if not m.labels:
                return m.name
            lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
            return f"{m.name}{{{lbl}}}"

        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for c in self._counters.values():
            out["counters"][tag(c)] = c.value
        for g in self._gauges.values():
            out["gauges"][tag(g)] = {"last": g.value, "max": g.max, "min": g.min}
        for h in self._histograms.values():
            out["histograms"][tag(h)] = {
                "count": h.count, "mean": h.mean,
                "p50": h.percentile(50), "p95": h.percentile(95),
                "p99": h.percentile(99),
            }
        return out

    def counters_flat(self) -> Dict[str, float]:
        """Per-name counter totals (labels aggregated)."""
        out: Dict[str, float] = {}
        for c in self._counters.values():
            out[c.name] = out.get(c.name, 0.0) + c.value
        return out

    def gauge_peaks(self) -> Dict[str, float]:
        """Per-name gauge maxima, suffixed ``_peak`` for summary merging."""
        out: Dict[str, float] = {}
        for g in self._gauges.values():
            if g.max is None:
                continue
            k = f"{g.name}_peak"
            out[k] = g.max if k not in out else max(out[k], g.max)
        return out
