"""Span tracing with Chrome trace-event export, twin of `repro.obs.trace`.

`SpanTracer` records complete ("X"), instant ("i") and counter ("C")
events on one timeline in milliseconds of the caller's clock, bounded by
``max_events`` (drops are counted); `to_chrome_trace()` emits the Trace
Event Format JSON that Perfetto loads.

`SpanTracer.span(name)` is the program's one call for a stage: it always
opens the `torch.profiler.record_function` label ``name``, and when the
tracer is enabled it also records an X event of that name.  The default
clock (`now_ms`) is the profiler's axis, ms on the Unix epoch, read
through `time.perf_counter` plus one offset taken at import, so a span
and its label start within microseconds of each other and the program's
trace lines up with a `torch.profiler` trace (an export's ``ts`` plus its
``baseTimeNanoseconds`` / 1000 is the ``ts`` written here).  A disabled
tracer's `span()` costs the label and one attribute check.

The reference's `annotate` hook (`jax.profiler.TraceAnnotation` around
the jit hot paths, behind a switch) is `torch.profiler.record_function`
here, always on: it costs next to nothing without an active profiler;
it stays for model-level labels that have no tracer in reach.
`emit_flush_spans` / `emit_request_spans` are the serving drivers' span
emitters, `emit_chaos_events` renders a fault schedule for the traffic
simulators.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional, Sequence

import torch

__all__ = [
    "NULL_TRACER",
    "SpanTracer",
    "annotate",
    "emit_chaos_events",
    "emit_flush_spans",
    "emit_request_spans",
    "now_ms",
]


def _epoch_offset_ms() -> float:
    """Unix-epoch ms minus `time.perf_counter` ms, from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1] / 1e6


_EPOCH_OFFSET_MS = _epoch_offset_ms()


def now_ms() -> float:
    """The default clock: ms on the Unix epoch, `torch.profiler`'s axis,
    with `time.perf_counter`'s monotonic resolution."""
    return 1000.0 * time.perf_counter() + _EPOCH_OFFSET_MS


class _LiveSpan:
    """Context manager that opens the label ``name`` and records one X
    event of the same name on exit."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "t0", "label")

    def __init__(self, tracer, name, cat, tid, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self.t0 = 0.0
        self.label = torch.profiler.record_function(name)

    # Each end is stamped before and after the label's call and set to the
    # midpoint: under an active profiler the call costs tens of
    # microseconds, and the label stamps its own time somewhere inside it.
    def __enter__(self):
        clock = self.tracer.clock_ms
        before = clock()
        self.label.__enter__()
        self.t0 = 0.5 * (before + clock())
        return self

    def __exit__(self, *exc):
        clock = self.tracer.clock_ms
        before = clock()
        self.label.__exit__(*exc)
        self.tracer.add_span(
            self.name, self.t0, 0.5 * (before + clock()),
            cat=self.cat, tid=self.tid, args=self.args,
        )
        return False


class SpanTracer:
    """Bounded in-memory trace-event recorder (ms timestamps).

    Parameters
    ----------
    enabled : bool
        A disabled tracer records nothing; its `span()` still opens the
        profiler label, and each call site costs that and one attribute
        check.
    clock_ms : callable, optional
        ``() -> float`` returning the current time in **ms**.  Default is
        `now_ms`, the profiler's axis; callers with their own timeline
        (virtual-time pump, discrete-event simulator) pass theirs so
        every span lands on one consistent axis.
    pid : str
        Process name grouping the events in the Perfetto UI.
    max_events : int
        Event-buffer bound; events past it are dropped and counted.
    """

    def __init__(
        self,
        enabled: bool = True,
        clock_ms: Optional[Callable[[], float]] = None,
        pid: str = "netmcp",
        max_events: int = 200_000,
    ):
        self.enabled = enabled
        self.clock_ms = clock_ms if clock_ms is not None else now_ms
        self.pid = pid
        self.max_events = int(max_events)
        self.events: list = []
        self.n_dropped = 0

    # -- recording -----------------------------------------------------------
    def _push(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.n_dropped += 1
            return
        self.events.append(ev)

    def span(self, name: str, cat: str = "serving", tid=0,
             args: Optional[dict] = None):
        """Context manager over a block: the profiler label ``name``
        always, and when enabled an X event of that name on this
        tracer's clock (the entered span's ``t0`` and ``args`` may be
        read and filled inside the block)."""
        if not self.enabled:
            return torch.profiler.record_function(name)
        return _LiveSpan(self, name, cat, tid, args)

    def add_span(self, name: str, t0_ms: float, t1_ms: float, *,
                 cat: str = "serving", tid=0, pid: Optional[str] = None,
                 args: Optional[dict] = None) -> None:
        """Record one complete span with explicit [t0, t1] timestamps."""
        if not self.enabled:
            return
        ev = {
            "name": name, "cat": cat, "ph": "X",
            "ts": 1000.0 * t0_ms, "dur": 1000.0 * max(t1_ms - t0_ms, 0.0),
            "pid": pid or self.pid, "tid": tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, t_ms: Optional[float] = None, *,
                cat: str = "event", tid=0, pid: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        """Record an instant event (sheds, expiries, fault injections)."""
        if not self.enabled:
            return
        ev = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": 1000.0 * (self.clock_ms() if t_ms is None else t_ms),
            "pid": pid or self.pid, "tid": tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, values: dict,
                t_ms: Optional[float] = None, *, tid=0) -> None:
        """Record a counter sample (rendered as a stacked series)."""
        if not self.enabled:
            return
        self._push({
            "name": name, "ph": "C",
            "ts": 1000.0 * (self.clock_ms() if t_ms is None else t_ms),
            "pid": self.pid, "tid": tid, "args": dict(values),
        })

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Trace Event Format payload (Perfetto / chrome://tracing)."""
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.pid},
        }]
        payload = {
            "traceEvents": meta + list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "n_events": len(self.events),
                "n_dropped": self.n_dropped,
            },
        }
        return payload

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def clear(self) -> None:
        self.events = []
        self.n_dropped = 0


NULL_TRACER = SpanTracer(enabled=False)


def annotate(name: str):
    """Label a block of device work in a `torch.profiler` trace."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# Structured emission helpers shared by the serving drivers
# ---------------------------------------------------------------------------

def emit_flush_spans(
    tracer: SpanTracer,
    t0_ms: float,
    t1_ms: float,
    phases: Sequence[tuple],
    rids: Sequence[int],
    *,
    tid=0,
    flush_idx: Optional[int] = None,
) -> None:
    """Emit one flush's span tree: a parent ``flush`` span over [t0, t1]
    and child phase spans (encode / dispatch / merge) that **tile the
    interval exactly**: the phase durations (wall ms measured inside
    `SonarGateway.route_batch`) are rescaled so their sum equals the
    caller-observed flush duration, and the last phase absorbs the
    rounding remainder."""
    if not tracer.enabled:
        return
    args = {"rids": list(rids), "batch": len(rids)}
    if flush_idx is not None:
        args["flush"] = flush_idx
    tracer.add_span("flush", t0_ms, t1_ms, cat="serving", tid=tid, args=args)
    total = sum(max(d, 0.0) for _, d in phases)
    span_ms = max(t1_ms - t0_ms, 0.0)
    if total <= 0.0 or span_ms <= 0.0:
        return
    scale = span_ms / total
    cur = t0_ms
    for j, (name, dur) in enumerate(phases):
        end = t1_ms if j == len(phases) - 1 else cur + max(dur, 0.0) * scale
        tracer.add_span(
            name, cur, end, cat="serving", tid=tid,
            args=None if flush_idx is None else {"flush": flush_idx},
        )
        cur = end


def emit_request_spans(
    tracer: SpanTracer,
    rid: int,
    t_arrival_ms: float,
    t_routed_ms: float,
    t_done_ms: float,
    *,
    replica_idx: int = -1,
    flush_idx: Optional[int] = None,
) -> None:
    """Per-request lifecycle spans on the ``requests`` track: ``serve``
    (arrival -> completion) wrapping ``queue_wait`` (arrival -> flush
    start); the rest of ``serve`` is the flush the request rode."""
    if not tracer.enabled:
        return
    args = {"rid": rid, "replica": replica_idx}
    if flush_idx is not None:
        args["flush"] = flush_idx
    tracer.add_span("serve", t_arrival_ms, t_done_ms, cat="request",
                    pid="requests", tid=rid, args=args)
    tracer.add_span("queue_wait", t_arrival_ms, t_routed_ms, cat="request",
                    pid="requests", tid=rid, args={"rid": rid})


def _mask_intervals(row) -> list:
    """[(start_step, end_step)] maximal runs of True in a bool vector."""
    out = []
    start = None
    for t, v in enumerate(row):
        if v and start is None:
            start = t
        elif not v and start is not None:
            out.append((start, t))
            start = None
    if start is not None:
        out.append((start, len(row)))
    return out


def emit_chaos_events(tracer: SpanTracer, schedule, dt_s: float) -> None:
    """Render a `repro_torch.chaos.ChaosSchedule` onto the trace timeline:
    per-server ``down`` spans (with an ``inject:down`` instant at onset),
    ``degraded`` spans where the latency inflation exceeds 1, and
    ``telemetry-stale`` spans for monitoring blackouts, all on a ``chaos``
    process with one track per server."""
    if not tracer.enabled or schedule is None:
        return
    step_ms = 1000.0 * dt_s

    def spans(mask_row, name, server):
        for s, e in _mask_intervals(mask_row):
            tracer.add_span(
                name, s * step_ms, e * step_ms, cat="chaos",
                pid="chaos", tid=server, args={"server": server},
            )
            if name == "down":
                tracer.instant(
                    "inject:down", s * step_ms, cat="chaos",
                    pid="chaos", tid=server, args={"server": server},
                )

    for i in range(schedule.n_servers):
        spans(schedule.down[i], "down", i)
        spans(schedule.degrade[i] > 1.0, "degraded", i)
        spans(schedule.stale[i], "telemetry-stale", i)
