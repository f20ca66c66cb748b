"""Host metrics, twin of `repro.obs.metrics`: counters, gauges,
log-scale histograms and the registry the serving stack reports from.

`MetricsRegistry` is the source of truth the port's `ServeEngine`
registers its counters in (``engine_admitted_total`` and so on), under
the reference's names.  `Histogram` uses fixed log-scale buckets:
`observe` is two arithmetic ops and an increment, and p50/p99/p999 come
from the bucket counts with the bucket's relative width
(``10^(1/per_decade) - 1``, ~7.5 % at the default 32 buckets/decade).

`DeviceRouteStats` is the hot-path accumulator of the routing engines: one
f32 buffer on the device of the engines' outputs, updated from their
*device* tensors (picks, C/N/S sums) at flush boundaries, with no host
sync; `fold` copies it to the host once.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import torch

__all__ = [
    "Counter",
    "DeviceRouteStats",
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


class DeviceRouteStats:
    """Per-route stats accumulated on the device, twin of
    `repro.obs.metrics.DeviceRouteStats`.

    Layout: one f32 vector ``[n_servers + 4]``: ``buf[:n_servers]`` pick
    counts per server, then the count of routed requests and the running
    sums of the winning C / N / S.  `accumulate` keeps references to an
    engine call's device outputs (before any host conversion): an O(1)
    list append, no launch and no host sync on the routing hot path.
    `drain` adds everything pending in one batch of plain tensor ops on
    the outputs' device (one `index_add_` of the picks, one update of the
    four sums, however many calls are pending); `fold` drains and copies
    the buffer to the host once.

    Padded rows (the micro-batch ``pad_to`` path) are left out by
    ``n_real``, a Python int: each call's outputs are sliced to their real
    rows (views, nothing read back).  The buffer is made on the device of
    the first tensors drained into it; until then a fold reads zeros.  Pick counts go
    through float atomics on the card: exact below 2^24 picks a server.
    The engines hand over freshly allocated outputs, which nothing writes
    to afterwards, so a deferred drain reads the values of its own call
    (on the CPU the returned decisions' arrays share that memory; no code
    of the port writes into them).
    """

    # engine calls between folds before an inline drain (bounds the
    # retained device tensors, far above any real flush cadence)
    MAX_PENDING = 512

    def __init__(self, n_servers: int):
        self.n_servers = int(n_servers)
        self._buf: Optional[torch.Tensor] = None
        self._pending: list = []

    def accumulate(self, server_idx: torch.Tensor, expertise: torch.Tensor,
                   network: torch.Tensor, fused: torch.Tensor,
                   n_real: Optional[int] = None) -> None:
        """Record one engine call's device outputs (each ``[B]``) for the
        next drain; ``n_real`` counts the real rows ahead of the padding
        (None: every row).  `MAX_PENDING` is the inline backstop for
        callers that never drain."""
        self._pending.append((server_idx, expertise, network, fused, n_real))
        if len(self._pending) >= self.MAX_PENDING:
            self.drain()

    def drain(self) -> None:
        """Add the pending calls into the buffer on their device (tensor
        ops queued on the card, no host sync).  The serving drivers call it
        at flush boundaries, outside the latency-timed windows."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        # each call's real rows as views: [:None] keeps them all
        real = [[t[:call[4]] for t in call[:4]] for call in pending]
        idx = torch.cat([r[0] for r in real]).long()
        sums = torch.stack([torch.cat([r[j] for r in real]).float().sum() for j in (1, 2, 3)])
        if self._buf is None:
            self._buf = torch.zeros(self.n_servers + 4, dtype=torch.float32, device=idx.device)
        self._buf.index_add_(0, idx, torch.ones(idx.shape[0], device=idx.device))
        self._buf[-4] += idx.shape[0]
        self._buf[-3:] += sums

    def fold(self, reset: bool = True) -> dict:
        """Drain, then one device->host copy; returns the folded stats."""
        self.drain()
        host = (torch.zeros(self.n_servers + 4).numpy() if self._buf is None
                else self._buf.cpu().numpy().copy())
        if reset:
            self._buf = None
        n = float(host[-4])
        return {
            "picks": host[: self.n_servers],
            "n_routed": n,
            "mean_expertise": float(host[-3]) / n if n else 0.0,
            "mean_network": float(host[-2]) / n if n else 0.0,
            "mean_fused": float(host[-1]) / n if n else 0.0,
        }
