"""End-to-end routing observability, twin of `repro.obs`.

The serving stack accepts one `Observability` bundle and threads it
through every layer:

  * `SpanTracer` (`repro_torch.obs.trace`): request-lifecycle and stage
    spans with Chrome trace-event export (Perfetto-loadable).  Its
    `span(name)` also opens the `torch.profiler` label ``name``, and its
    default clock is the profiler's axis (ms on the Unix epoch), so the
    program's trace lines up in Perfetto with a `torch.profiler` export
    of the same run (whose ``ts`` are offset by its
    ``baseTimeNanoseconds``).
  * `MetricsRegistry` (`repro_torch.obs.metrics`): counters, gauges and
    log-bucket histograms, the one source of the gateway's, micro-batcher's,
    front end's, engine's and simulators' counts.
  * `DeviceRouteStats` (`repro_torch.obs.metrics`): routing picks and C/N/S
    sums accumulated on the device from the engines' outputs, folded to the
    host only at flush boundaries.
  * `AuditTap` (`repro_torch.obs.audit`): the α/β/γ/δ score decomposition
    of every winning server of the scalar router, bit-exact by
    construction.
  * `render_dashboard` / `LiveDashboard` (`repro_torch.obs.dashboard`): the
    text panel of the online launcher.

The reference's `enable_jax_annotations` switch has no twin: the port's
`annotate` is always `torch.profiler.record_function`, which costs next to
nothing without an active profiler.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.obs.audit import AuditTap, ScoreAudit
from repro_torch.obs.dashboard import LiveDashboard, render_dashboard
from repro_torch.obs.metrics import (
    Counter,
    DeviceRouteStats,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    SpanTracer,
    annotate,
    emit_chaos_events,
    emit_flush_spans,
    emit_request_spans,
)

__all__ = [
    "AuditTap",
    "Counter",
    "DeviceRouteStats",
    "Gauge",
    "Histogram",
    "LiveDashboard",
    "MetricsRegistry",
    "NULL_TRACER",
    "Observability",
    "ScoreAudit",
    "SpanTracer",
    "annotate",
    "emit_chaos_events",
    "emit_flush_spans",
    "emit_request_spans",
    "render_dashboard",
]


class Observability:
    """One bundle the serving stack threads end to end.

    Parameters
    ----------
    trace : bool
        Record lifecycle and stage spans (a disabled tracer costs one check
        per site beside the profiler label its `span` opens).
    jit_stats : bool
        Thread a `DeviceRouteStats` through the routing engines (device
        accumulation, host fold at flush boundaries).  The reference's name
        is kept; nothing is compiled here.
    audit : bool
        Attach an `AuditTap` to scalar routing decisions.
    registry : MetricsRegistry, optional
        Share an existing registry; default creates a fresh one.
    clock_ms : callable, optional
        Timeline for the tracer; default `repro_torch.obs.trace.now_ms`,
        the profiler's axis.
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
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = SpanTracer(enabled=trace, clock_ms=clock_ms, max_events=max_trace_events)
        self.jit_stats = bool(jit_stats)
        self.audit_tap: Optional[AuditTap] = AuditTap() if audit else None
        # per-fleet DeviceRouteStats, created by the gateway on demand
        self.route_stats: Optional[DeviceRouteStats] = None

    def ensure_route_stats(self, n_servers: int) -> Optional[DeviceRouteStats]:
        """The gateway's device-side accumulator (one per fleet size)."""
        if not self.jit_stats:
            return None
        if self.route_stats is None or self.route_stats.n_servers != n_servers:
            self.route_stats = DeviceRouteStats(n_servers)
        return self.route_stats

    def drain_route_stats(self) -> None:
        """Add the pending device-stat updates; the serving drivers call
        this at flush boundaries, outside their latency-timed windows."""
        if self.route_stats is not None:
            self.route_stats.drain()

    def fold_route_stats(self, reset: bool = False) -> Optional[dict]:
        """The folded route stats (one device->host copy), or None while
        ``jit_stats`` is off."""
        if self.route_stats is None:
            return None
        return self.route_stats.fold(reset=reset)
