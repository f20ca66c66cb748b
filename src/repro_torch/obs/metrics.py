"""Host metrics, twin of `repro.obs.metrics`: counters, gauges,
log-scale histograms and the registry the serving stack reports from.

`MetricsRegistry` is the source of truth the port's `ServeEngine`
registers its counters in (``engine_admitted_total`` and so on), under
the reference's names.  `Histogram` uses fixed log-scale buckets:
`observe` is two arithmetic ops and an increment, and p50/p99/p999 come
from the bucket counts with the bucket's relative width
(``10^(1/per_decade) - 1``, ~7.5 % at the default 32 buckets/decade).

The reference's `DeviceRouteStats` (device-side routing stats) belongs to
the routing engines' observability and is not ported yet (`ROADMAP.md`
queue 1, item 10).
"""
from __future__ import annotations

import json
import math
from typing import Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]


class Counter:
    """Monotone event count."""

    kind = "counter"
    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": self.kind, "unit": self.unit, "value": self.value}


class Gauge:
    """Instantaneous level (in-flight, queue depth, active slots)."""

    kind = "gauge"
    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def snapshot(self) -> dict:
        return {"type": self.kind, "unit": self.unit, "value": self.value}


class Histogram:
    """Fixed-bucket log-scale histogram (p50/p99/p999 without samples).

    Buckets span [lo, hi) with ``per_decade`` geometrically-spaced
    buckets per decade; values below ``lo`` land in bucket 0 and values
    at/above ``hi`` in the last bucket, so every observation is counted.
    Quantiles interpolate within the hit bucket's log-width, bounding
    the relative error by one bucket ratio (10^(1/per_decade), ~7.5% at
    the default 32/decade — tighter than the run-to-run noise of any
    latency distribution this repo measures).
    """

    kind = "histogram"
    __slots__ = ("name", "unit", "lo", "hi", "per_decade", "n_buckets",
                 "counts", "count", "total", "vmin", "vmax", "_log_lo",
                 "_inv_log_ratio")

    def __init__(self, name: str, unit: str = "ms", lo: float = 1e-3,
                 hi: float = 1e6, per_decade: int = 32):
        if lo <= 0 or hi <= lo:
            raise ValueError("need 0 < lo < hi")
        self.name = name
        self.unit = unit
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        decades = math.log10(self.hi / self.lo)
        self.n_buckets = max(1, math.ceil(decades * self.per_decade))
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._log_lo = math.log10(self.lo)
        self._inv_log_ratio = float(self.per_decade)   # buckets per decade

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int((math.log10(v) - self._log_lo) * self._inv_log_ratio)
        return min(i, self.n_buckets - 1)

    def observe(self, v: float) -> None:
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(float(v))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _edge(self, i: float) -> float:
        return self.lo * 10.0 ** (i / self.per_decade)

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile, clamped to the observed range."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= target:
                # log-linear interpolation inside the hit bucket
                frac = (target - acc) / c
                v = self._edge(i + frac)
                return max(self.vmin, min(v, self.vmax))
            acc += c
        return self.vmax

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    def snapshot(self) -> dict:
        return {
            "type": self.kind, "unit": self.unit, "count": self.count,
            "mean": self.mean,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.p50, "p99": self.p99, "p999": self.p999,
        }


class MetricsRegistry:
    """Flat name -> instrument registry; `get_or_create` semantics so
    every layer binding the same name shares one instrument."""

    def __init__(self):
        self._metrics: dict = {}

    def _bind(self, cls, name: str, **kw):
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(name, **kw)
            self._metrics[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric '{name}' already registered as {inst.kind}"
            )
        return inst

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._bind(Counter, name, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._bind(Gauge, name, unit=unit)

    def histogram(self, name: str, unit: str = "ms", **kw) -> Histogram:
        return self._bind(Histogram, name, unit=unit, **kw)

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        m = self._metrics.get(name)
        return m.value if m is not None and hasattr(m, "value") else default

    def names(self) -> list:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        return {k: self._metrics[k].snapshot() for k in sorted(self._metrics)}

    def to_json(self, path: str, extra: Optional[dict] = None) -> None:
        payload = {"metrics": self.snapshot()}
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
