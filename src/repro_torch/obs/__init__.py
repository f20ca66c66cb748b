"""Observability, twin of `repro.obs` (host part).

One `Observability` bundle is threaded through the serving stack: a
`MetricsRegistry` (counters, gauges, histograms) and a `SpanTracer`
(lifecycle spans, Chrome trace export).  The reference's device-side
routing stats (``jit_stats=True``) and score audit tap (``audit=True``)
are not ported yet (`ROADMAP.md` queue 1, item 10) and raise
`NotImplementedError`; the bundle's ``audit_tap`` and ``route_stats``
are therefore always None, and the serving layers pass them through.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    NULL_TRACER,
    SpanTracer,
    annotate,
    emit_chaos_events,
    emit_flush_spans,
    emit_request_spans,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Observability",
    "SpanTracer",
    "annotate",
    "emit_chaos_events",
    "emit_flush_spans",
    "emit_request_spans",
]


class Observability:
    """A metrics registry and a tracer the serving layers share.

    Parameters
    ----------
    trace : bool
        Record lifecycle spans (a disabled tracer costs one check per site).
    jit_stats, audit : bool
        The reference's device route stats and audit tap; not ported, and
        True raises `NotImplementedError`.
    registry : MetricsRegistry, optional
        Share an existing registry; default creates a fresh one.
    clock_ms : callable, optional
        Timeline for the tracer; default wall clock.
    """

    def __init__(
        self,
        trace: bool = False,
        jit_stats: bool = False,
        audit: bool = False,
        registry: Optional[MetricsRegistry] = None,
        clock_ms: Optional[Callable[[], float]] = None,
        max_trace_events: int = 200_000,
    ):
        if jit_stats or audit:
            raise NotImplementedError(
                "repro_torch.obs: device route stats (jit_stats) and the audit tap are not "
                "ported yet (ROADMAP.md queue 1, item 10)"
            )
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = SpanTracer(enabled=trace, clock_ms=clock_ms, max_events=max_trace_events)
        self.audit_tap = None
        self.route_stats = None

    def ensure_route_stats(self, n_servers: int):
        """The gateway's device-side route accumulator: None while
        ``jit_stats`` is off (always, until it is ported)."""
        return self.route_stats

    def drain_route_stats(self) -> None:
        """Flush-boundary hook of the serving drivers; nothing to drain
        without device route stats."""
