"""Deadline-aware micro-batching for the online serving front-end, twin of
`repro.serving.microbatch`.

Requests arrive **one at a time** (`traffic.source.LiveRequest`), are
coalesced into micro-batches, and each flush runs the gateway's batched
routing path (`SonarGateway.route_batch`: the routing kernels on the
card), so the serving path makes the decisions `route_batch` makes on the
same flush partitions (tests/test_torch_gateway.py).

Three layers, from pure to real-time:

  `MicroBatcher`        — the batching policy as a deterministic state
                          machine (offer / trigger / take).  No clock of
                          its own, no I/O: callers pass ``now_ms``.
  `MicroBatchPump`      — replays a request schedule against a real
                          `SonarGateway` on a **virtual clock**: arrivals
                          at their scheduled times, each flush occupying
                          the engine for its *measured* wall-clock
                          routing time.  Deterministic arrivals + real
                          compute = reproducible queueing dynamics.
  `AsyncServingGateway` — the same batcher on the asyncio event loop and
                          the wall clock (repro_torch.serving.frontend).

A batch flushes when the first of three triggers fires:

  size      len(pending) >= max_batch          (flush immediately)
  age       now >= head arrival + max_wait_ms  (bound the wait of the
                                               oldest request)
  deadline  now >= min(deadline) - slack_ms    (the most urgent pending
                                               request's remaining slack
                                               is down to slack_ms:
                                               route now or miss it)

Under burst the queue outgrows ``max_batch`` and the batcher degrades to
back-to-back chunked flushes (every take is capped at ``max_batch``),
with depth bounded by ``queue_limit`` — offers beyond it are **shed** at
admission (accounted, never silently dropped) so latency stays bounded
instead of the queue growing without limit.  Requests whose deadline has
already passed when their batch forms are expiry-shed at take time.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.trace import SpanTracer, emit_flush_spans, emit_request_spans
from repro_torch.traffic.source import LiveRequest

__all__ = [
    "BatchingPolicy",
    "MicroBatcher",
    "MicroBatchPump",
    "PumpReport",
    "ServeResult",
]


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """Knobs of the micro-batching policy (units in the field names).

    Parameters
    ----------
    max_batch : int
        Flush as soon as this many requests are pending; also the cap on
        every flush size (burst degradation takes `max_batch`-sized
        chunks back-to-back).
    max_wait_ms : float
        Age trigger: flush when the oldest pending request has waited
        this long (**ms**).  The queueing-delay bound a lightly-loaded
        request can see.
    slack_ms : float
        Deadline trigger headroom (**ms**): flush when the most urgent
        pending deadline is within ``slack_ms`` of now.  Set it to
        roughly one batch service time so urgent requests route early
        enough to make their deadline.
    queue_limit : int
        Bound on pending-queue depth; offers beyond it are shed
        (admission control).  Must be >= max_batch to ever fill a batch.
    pad_batches : bool
        Pad every flush to ``max_batch`` rows before the engine
        (`SonarGateway.route_batch(pad_to=...)`), so every micro-batch
        has the same shape on the card whatever its size.  Padded rows
        are discarded before any accounting; decisions on real rows are
        argmax-identical (tested).  Off by default, as in the reference.
    """

    max_batch: int = 32
    max_wait_ms: float = 5.0
    slack_ms: float = 0.0
    queue_limit: int = 256
    pad_batches: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.queue_limit < self.max_batch:
            raise ValueError("queue_limit must be >= max_batch")
        if self.max_wait_ms < 0.0 or self.slack_ms < 0.0:
            raise ValueError("max_wait_ms and slack_ms must be >= 0")


@dataclasses.dataclass
class ServeResult:
    """Outcome of one request through the micro-batched serving path.

    Exactly one of ``shed`` / ``expired`` / routed holds:
    ``shed`` — rejected at admission (queue full); ``expired`` — its
    deadline passed while it waited, so it was dropped at flush time;
    otherwise it was routed and carries the replica decision.  All times
    are **ms** on the caller's clock (virtual for the pump, wall for the
    asyncio front-end); ``wait_ms = t_routed_ms - t_arrival_ms`` is the
    queueing delay and ``latency_ms`` the replica's observed network
    latency from the gateway's feed-forward record.
    """

    rid: int
    replica_idx: int = -1
    ok: bool = False
    latency_ms: float = 0.0
    t_arrival_ms: float = 0.0
    t_routed_ms: float = 0.0      # flush start (batch formation)
    t_done_ms: float = 0.0        # flush completion (decision + record)
    batch_size: int = 0
    shed: bool = False
    expired: bool = False

    @property
    def wait_ms(self) -> float:
        return self.t_routed_ms - self.t_arrival_ms

    @property
    def serve_ms(self) -> float:
        """Queueing wait + routing service (the front-end latency the
        QPS benchmark reports; replica execution is ``latency_ms``)."""
        return self.t_done_ms - self.t_arrival_ms


class MicroBatcher:
    """The batching policy as a clockless, deterministic state machine.

    Callers drive it with explicit ``now_ms`` timestamps: `offer` admits
    (or sheds) one arriving request, `next_trigger_ms` reports when the
    pending batch wants to flush, `take` pops the next micro-batch.  The
    pump and the asyncio front-end share this object, so the policy has
    exactly one implementation to test.

    >>> from repro_torch.traffic.source import LiveRequest
    >>> b = MicroBatcher(BatchingPolicy(max_batch=2, max_wait_ms=10.0,
    ...                                 queue_limit=2))
    >>> b.offer(LiveRequest(rid=0, text="a", t_ms=0.0), now_ms=0.0)
    True
    >>> b.next_trigger_ms(now_ms=0.0)   # age trigger: head arrival + 10
    10.0
    >>> b.offer(LiveRequest(rid=1, text="b", t_ms=1.0), now_ms=1.0)
    True
    >>> b.next_trigger_ms(now_ms=1.0)   # size trigger: flush now
    1.0
    >>> b.offer(LiveRequest(rid=2, text="c", t_ms=1.5), now_ms=1.5)
    False
    >>> b.n_shed, [r.rid for r in b.take(now_ms=2.0)], b.n_pending
    (1, [0, 1], 0)
    """

    def __init__(self, policy: BatchingPolicy = BatchingPolicy(),
                 registry=None):
        self.policy = policy
        self._pending: collections.deque = collections.deque()
        self.n_offered = 0
        self.n_shed = 0
        self.n_expired = 0
        self.n_taken = 0
        # mirror the accounting in the shared metrics registry so shed /
        # expired counts surface alongside the gateway's (one source of
        # truth; the conservation identity over these registry counters
        # is property-tested against check_accounting)
        self._reg = registry
        if registry is not None:
            self._m_offered = registry.counter("serving_offered_total", "req")
            self._m_shed = registry.counter("serving_shed_total", "req")
            self._m_expired = registry.counter("serving_expired_total", "req")
            self._m_taken = registry.counter("serving_routed_total", "req")
            self._m_depth = registry.gauge("serving_queue_depth", "req")

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def offer(self, req: LiveRequest, now_ms: float) -> bool:
        """Admit one arriving request; returns False (and accounts a
        shed) when the queue is at ``queue_limit`` — bounded queue depth
        is the load-shedding backpressure under burst."""
        self.n_offered += 1
        if self._reg is not None:
            self._m_offered.inc()
        if len(self._pending) >= self.policy.queue_limit:
            self.n_shed += 1
            if self._reg is not None:
                self._m_shed.inc()
            return False
        self._pending.append(req)
        if self._reg is not None:
            self._m_depth.set(len(self._pending))
        return True

    def next_trigger_ms(self, now_ms: float) -> Optional[float]:
        """Earliest time a flush is wanted: ``now_ms`` when the size
        trigger already holds, else min(age trigger, deadline trigger);
        ``None`` with nothing pending.  May be in the past (an overdue
        trigger while the engine was busy) — callers flush at
        ``max(trigger, engine_free)``."""
        if not self._pending:
            return None
        if len(self._pending) >= self.policy.max_batch:
            return now_ms
        t = self._pending[0].t_ms + self.policy.max_wait_ms
        deadlines = [
            r.deadline_ms for r in self._pending if r.deadline_ms is not None
        ]
        if deadlines:
            t = min(t, min(deadlines) - self.policy.slack_ms)
        return t

    def take(self, now_ms: float) -> list:
        """Pop the next micro-batch (arrival order, <= max_batch).

        Requests whose deadline has already passed are expiry-shed here
        — even an instantaneous route would miss them — and do **not**
        consume batch slots.  Returns the (possibly empty) list of
        requests to route; expired requests are retrievable via
        `take_expired` so callers can resolve their futures."""
        batch: list = []
        self._expired_now: list = []
        while self._pending and len(batch) < self.policy.max_batch:
            req = self._pending.popleft()
            if req.deadline_ms is not None and req.deadline_ms <= now_ms:
                self.n_expired += 1
                self._expired_now.append(req)
                continue
            batch.append(req)
        self.n_taken += len(batch)
        if self._reg is not None:
            self._m_expired.inc(len(self._expired_now))
            self._m_taken.inc(len(batch))
            self._m_depth.set(len(self._pending))
        return batch

    def take_expired(self) -> list:
        """Requests expiry-shed by the latest `take` call."""
        out = getattr(self, "_expired_now", [])
        self._expired_now = []
        return out

    def drop_pending(self) -> list:
        """Shed every pending request (non-drain shutdown): returns them
        so callers can resolve their futures, accounted as shed."""
        out = list(self._pending)
        self._pending.clear()
        self.n_shed += len(out)
        if self._reg is not None:
            self._m_shed.inc(len(out))
            self._m_depth.set(0)
        return out

    def check_accounting(self) -> None:
        """offered == taken + shed + expired + pending, always."""
        total = self.n_taken + self.n_shed + self.n_expired + self.n_pending
        if self.n_offered != total:
            raise AssertionError(
                f"micro-batch accounting leak: offered={self.n_offered} != "
                f"taken={self.n_taken} + shed={self.n_shed} + "
                f"expired={self.n_expired} + pending={self.n_pending}"
            )


def _emit_flush_trace(tracer, fidx, batch, routed, t_flush_ms, busy_ms,
                      phases) -> None:
    """One flush's spans: the flush+phase tree on the serving track and
    serve/queue_wait per request.  Pure function of flush-log data, so
    the live trace and `MicroBatchPump.replay_spans` emit identical
    events."""
    emit_flush_spans(
        tracer, t_flush_ms, t_flush_ms + busy_ms, phases,
        [r.rid for r in batch], flush_idx=fidx,
    )
    for req, res in zip(batch, routed):
        emit_request_spans(
            tracer, req.rid, req.t_ms, t_flush_ms, t_flush_ms + busy_ms,
            replica_idx=res.replica_idx, flush_idx=fidx,
        )


@dataclasses.dataclass
class PumpReport:
    """Aggregate of one `MicroBatchPump.replay` (times in ms, virtual)."""

    n_offered: int
    n_routed: int
    n_shed: int
    n_expired: int
    n_flushes: int
    mean_batch: float             # mean routed flush size
    sustained_qps: float          # routed / busy span (arrival -> last done)
    p50_ms: float                 # serve latency (wait + routing service)
    p99_ms: float
    mean_wait_ms: float
    results: list                 # list[ServeResult], arrival order


class MicroBatchPump:
    """Virtual-time replay of a request schedule through the gateway.

    Arrivals advance a deterministic virtual clock; each flush calls the
    real `SonarGateway.route_batch` (which returns after its decisions
    are back on the host) and occupies the (single) engine for
    the flush's measured duration, so queueing dynamics reflect actual
    routing compute while the arrival process stays reproducible.  The
    engine is a serial resource: a flush whose trigger fires while a
    previous flush is still in service starts when the engine frees —
    during that wait more arrivals join the batch, which is exactly the
    burst-coalescing behavior a real event loop exhibits.

    Parameters
    ----------
    gateway : SonarGateway
        Must have ``use_kernels=True`` (the point of micro-batching is
        the batched engine path).
    policy : BatchingPolicy
    service_ms : callable, optional
        ``(texts) -> float`` override for the flush service time on the
        virtual clock — tests pass a constant for fully deterministic
        timelines; default measures the real `route_batch` wall time.
    """

    def __init__(self, gateway, policy: BatchingPolicy = BatchingPolicy(),
                 service_ms=None):
        if not getattr(gateway, "use_kernels", False):
            raise ValueError("MicroBatchPump requires use_kernels=True")
        self.gw = gateway
        self.policy = policy
        self.obs = gateway.obs
        self.batcher = MicroBatcher(policy, registry=self.obs.registry)
        self._service_ms = service_ms
        self.flush_log: list = []     # list[list[LiveRequest]] actually routed
        self.flush_times: list = []   # [(t_flush_ms, busy_ms)] per flush
        self.flush_phases: list = []  # per-flush gateway phase durations
        self.weight_log: list = []    # [(flush_idx, [a, b, g, d])] when the
                                      # gateway routes with SONAR-ADAPT
        self.results: dict = {}       # rid -> ServeResult
        self._now_ms = 0.0            # virtual clock, for the tracer
        self._m_flushes = self.obs.registry.counter(
            "serving_flushes_total", "flushes"
        )
        self._m_serve = self.obs.registry.histogram("serving_latency_ms", "ms")
        if self.obs.tracer.enabled:
            # spans land on the pump's virtual timeline, aligned with the
            # gateway's health instants (ejection/readmission)
            self.obs.tracer.clock_ms = lambda: self._now_ms

    # -- one flush ----------------------------------------------------------
    def _flush(self, now_ms: float) -> float:
        """Form and route one micro-batch at virtual time ``now_ms``;
        returns the engine-busy duration in virtual ms (0.0 when the take
        yielded nothing to route)."""
        batch = self.batcher.take(now_ms)
        tracer = self.obs.tracer
        for req in self.batcher.take_expired():
            self.results[req.rid] = ServeResult(
                rid=req.rid, expired=True, t_arrival_ms=req.t_ms,
                t_routed_ms=now_ms, t_done_ms=now_ms,
            )
            tracer.instant("expired", now_ms, args={"rid": req.rid})
        if not batch:
            return 0.0
        texts = [r.text for r in batch]
        regions = (
            [r.region for r in batch]
            if any(r.region >= 0 for r in batch) else None
        )
        sids = (
            [r.session_id for r in batch]
            if any(r.session_id is not None for r in batch) else None
        )
        pad = self.policy.max_batch if self.policy.pad_batches else None
        t0 = time.perf_counter()
        routed = self.gw.route_batch(
            texts, client_regions=regions, pad_to=pad, session_ids=sids
        )
        wall_ms = 1000.0 * (time.perf_counter() - t0)
        # device-stat fold boundary, after the timed window
        self.obs.drain_route_stats()
        busy_ms = (
            wall_ms if self._service_ms is None else
            float(self._service_ms(texts))
        )
        fidx = len(self.flush_log)
        self.flush_log.append(batch)
        self.flush_times.append((now_ms, busy_ms))
        self.flush_phases.append(list(self.gw.last_flush_phases))
        self._m_flushes.inc()
        state = self.gw.adapt_state()
        if state is not None:
            # weight trajectory sampled at flush granularity: feedback
            # recorded in this flush applies at the next route, so flush f
            # logs the weights it routed with
            w = [float(x) for x in state.weights.cpu().tolist()]
            self.weight_log.append((fidx, w))
            if tracer.enabled:
                tracer.instant(
                    "adapt_flush_weights", now_ms,
                    args={"flush": fidx, "step": int(state.step),
                          "alpha": w[0], "beta": w[1],
                          "gamma": w[2], "delta": w[3]},
                )
        for req, res in zip(batch, routed):
            self.results[req.rid] = ServeResult(
                rid=req.rid, replica_idx=res.replica_idx, ok=res.ok,
                latency_ms=res.latency_ms, t_arrival_ms=req.t_ms,
                t_routed_ms=now_ms, t_done_ms=now_ms + busy_ms,
                batch_size=len(batch),
            )
            self._m_serve.observe(now_ms + busy_ms - req.t_ms)
        if tracer.enabled:
            _emit_flush_trace(
                tracer, fidx, batch, routed, now_ms, busy_ms,
                self.flush_phases[-1],
            )
        return busy_ms

    # -- driver --------------------------------------------------------------
    def replay(self, schedule: Sequence[LiveRequest]) -> PumpReport:
        """Replay ``schedule`` (sorted by ``t_ms``) to completion: every
        request is resolved as routed, shed, or expired, and the queue is
        drained before returning (the empty-queue drain is a no-op)."""
        schedule = sorted(schedule, key=lambda r: (r.t_ms, r.rid))
        i, n = 0, len(schedule)
        free_ms = 0.0                 # engine free-at time (virtual)
        now_ms = 0.0
        tracer = self.obs.tracer
        while i < n or self.batcher.n_pending:
            trig = self.batcher.next_trigger_ms(now_ms)
            if trig is None:
                # idle: jump to the next arrival
                req = schedule[i]
                now_ms = max(now_ms, req.t_ms)
                self._now_ms = now_ms
                if not self.batcher.offer(req, now_ms):
                    self.results[req.rid] = ServeResult(
                        rid=req.rid, shed=True, t_arrival_ms=req.t_ms,
                        t_routed_ms=now_ms, t_done_ms=now_ms,
                    )
                    tracer.instant("shed", now_ms, args={"rid": req.rid})
                i += 1
                continue
            t_flush = max(trig, free_ms, now_ms)
            if i < n and schedule[i].t_ms <= t_flush:
                # an arrival lands before the flush fires: admit it first
                # (it may tighten the trigger via size or deadline)
                req = schedule[i]
                now_ms = max(now_ms, req.t_ms)
                self._now_ms = now_ms
                if not self.batcher.offer(req, now_ms):
                    self.results[req.rid] = ServeResult(
                        rid=req.rid, shed=True, t_arrival_ms=req.t_ms,
                        t_routed_ms=now_ms, t_done_ms=now_ms,
                    )
                    tracer.instant("shed", now_ms, args={"rid": req.rid})
                i += 1
                continue
            now_ms = t_flush
            self._now_ms = now_ms
            busy = self._flush(now_ms)
            free_ms = now_ms + busy
            self._now_ms = free_ms
        self.batcher.check_accounting()
        return self.report()

    def replay_spans(self) -> SpanTracer:
        """Deterministically rebuild the flush/request span timeline from
        `flush_log` (+ recorded flush times/phases and results) into a
        fresh tracer.  Emits exactly the events the live trace recorded
        (the live path and this replay share `_emit_flush_trace`)."""
        tracer = SpanTracer(enabled=True, clock_ms=lambda: 0.0)
        for fidx, batch in enumerate(self.flush_log):
            t_flush, busy = self.flush_times[fidx]
            routed = [self.results[r.rid] for r in batch]
            _emit_flush_trace(
                tracer, fidx, batch, routed, t_flush, busy,
                self.flush_phases[fidx],
            )
        return tracer

    def report(self) -> PumpReport:
        res = [self.results[k] for k in sorted(self.results)]
        routed = [r for r in res if not r.shed and not r.expired]
        lat = np.asarray([r.serve_ms for r in routed], np.float64)
        waits = np.asarray([r.wait_ms for r in routed], np.float64)
        if routed:
            span_ms = max(r.t_done_ms for r in routed) - min(
                r.t_arrival_ms for r in routed
            )
        else:
            span_ms = 0.0
        sizes = [len(b) for b in self.flush_log]
        return PumpReport(
            n_offered=len(res),
            n_routed=len(routed),
            n_shed=self.batcher.n_shed,
            n_expired=self.batcher.n_expired,
            n_flushes=len(self.flush_log),
            mean_batch=float(np.mean(sizes)) if sizes else 0.0,
            sustained_qps=1000.0 * len(routed) / max(span_ms, 1e-9),
            p50_ms=float(np.percentile(lat, 50)) if lat.size else 0.0,
            p99_ms=float(np.percentile(lat, 99)) if lat.size else 0.0,
            mean_wait_ms=float(waits.mean()) if waits.size else 0.0,
            results=res,
        )
