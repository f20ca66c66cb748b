"""Discrete-event fleet traffic simulator with a closed load->latency loop,
twin of `repro.traffic.simulator`.

The platform's network traces (`core.latency`) are *exogenous*: routing
decisions never changed what the router observed, so at offered loads past
a single server's capacity SONAR herds every request onto the top-scored
replica.  This simulator closes the loop:

  request completion latency = queueing wait + (inflated) service + network

and that total is fed forward into `platform.observed` at the completion
tick — the paper's feed-forward recording (Sec. III-B), now carrying
endogenous queueing delay.  Queue overflows are recorded as offline events
(the paper's hard clamp), which is exactly the signal SONAR's outage
penalty reacts to.

Mechanics
  - virtual clock in ms; event heap of (time, seq, kind, payload)
  - ARRIVAL  — route the request (any `Router`, incl. SONAR-LB with the
               live utilization vector, or a plain callable) and offer it
               to the chosen station (`traffic.queueing.ServerQueue`)
  - FINISH   — complete a service, start the queued head (work
               conservation), record the feed-forward observation
  - HEDGE    — if the request is still waiting `hedge_ms` after arrival,
               dispatch a duplicate copy (first completion wins; queued
               losers are cancelled, in-service losers waste capacity)

Retry budget: queue drops consume from a per-request budget — each drop
records an offline observation and re-routes immediately (the agent loop's
exception handling, seen from the fleet side); a request with no live copy
and no budget left fails.

Chaos faults (repro_torch.chaos, via the platform's schedule): a crashed or
partitioned station rejects dispatches (connection refused) and loses any
copy in service when it goes down; both paths record an offline
observation (blackout permitting), charge the retry budget and re-route
with the dead server in the request's failed set — which failover-aware
routers (SONAR-FT) receive as their failed-mask.

Geo composition (repro_torch.geo, via the platform's placement): when the
platform carries a `GeoPlacement` and `run` receives region-tagged
arrivals, each request's completion pays the propagation RTT of its
client region -> winning server's region on top of queueing + service +
server-side network (observed latency = propagation RTT + server QoS),
and locality-aware routers (SONAR-GEO) receive the request's
`client_rtt_ms` row so they can trade semantic fit against distance.
The RTT-inclusive completion latency is what feeds forward into the
observed history — exactly what a client-side monitor would report.

The simulation is host Python: the event heap, the float clock and the
f64 numpy arithmetic are the reference's, so on the same inputs every
event happens in the same order.  Routing is the scalar `Router.select`.
The one random draw, the service-time stream, comes from a
`torch.Generator` on ``device`` (the card by default) seeded with
``seed`` (`_service_draws`); it is not the reference's `jax.random`
stream.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import latency as L
from repro_torch.core.platform import NetMCPPlatform
from repro_torch.core.routing import Router
from repro_torch.obs import Observability
from repro_torch.obs.trace import emit_chaos_events, emit_request_spans
from repro_torch.traffic.queueing import QueueConfig, ServerQueue

_ARRIVAL, _FINISH, _HEDGE = 0, 1, 2


@dataclasses.dataclass
class Request:
    rid: int
    text: str
    t_arrival_ms: float
    budget: int                  # remaining retry/hedge budget
    region: int = -1             # client region (geo); -1 = untagged
    session_id: int = -1         # owning session DAG; -1 = standalone
    node_id: int = -1            # node within the session DAG
    hedge_ok: bool = True        # DAG-aware hedging: only critical-path
                                 # nodes are allowed to duplicate work
    done: bool = False
    failed: bool = False
    live_copies: int = 0
    n_routes: int = 0
    n_drops: int = 0
    n_hedges: int = 0
    hedged: bool = False
    # servers observed dead for THIS request (chaos faults); a
    # failover-aware router gets them as its failed-mask on re-routes
    failed_servers: set = dataclasses.field(default_factory=set)
    t_start_ms: float = math.nan    # service start of the winning copy
    t_finish_ms: float = math.nan   # client-side completion (incl. network)
    service_ms: float = math.nan    # inflated service time of the winner
    net_ms: float = math.nan        # network latency of the winner
    server_idx: int = -1            # winning server
    # winner features [C, N, -U, -R] from the last routing decision —
    # SONAR-ADAPT's credit-assignment payload (None for other routers)
    feats: Optional[np.ndarray] = None


class _Dispatch:
    """One copy of a request offered to one station."""

    __slots__ = ("req", "server", "draw_ms", "service_ms", "t_dispatch_ms",
                 "t_start_ms", "started")

    def __init__(self, req: Request, server: int, draw_ms: float, now_ms: float):
        self.req = req
        self.server = server
        self.draw_ms = draw_ms          # raw sampled service time
        self.service_ms = 0.0           # inflated at service start
        self.t_dispatch_ms = now_ms
        self.t_start_ms = math.nan
        self.started = False


@dataclasses.dataclass
class TrafficReport:
    n_offered: int
    n_completed: int
    n_failed: int
    n_drop_events: int
    n_hedges: int
    goodput_rps: float            # completed (within deadline, if set) / s
    p50_ms: float
    p99_ms: float
    mean_ms: float
    per_server_served: list
    max_share: float              # share of completions on the busiest server
    mean_utilization: float
    requests: list                # list[Request] for invariant checks

    def row(self, name: str) -> str:
        return (
            f"{name},goodput={self.goodput_rps:.2f}rps,"
            f"p50={self.p50_ms:.0f}ms,p99={self.p99_ms:.0f}ms,"
            f"failed={self.n_failed},drops={self.n_drop_events},"
            f"max_share={self.max_share:.2f}"
        )


RouteFn = Callable[[str, np.ndarray, np.ndarray], int]


class FleetTrafficSim:
    """Drives open-loop arrivals through routing + queueing + the network.

    `router` is either a scalar `Router` (its `select` receives the live
    latency history and utilization vector) or a plain callable
    ``(text, latency_hist, server_load) -> server_idx`` for synthetic
    policies (round-robin, least-loaded) in tests.  ``device`` is where
    the service draws are made (None: the card).
    """

    def __init__(
        self,
        platform: NetMCPPlatform,
        router: Union[Router, RouteFn],
        queue_cfg: QueueConfig = QueueConfig(),
        *,
        hedge_ms: Optional[float] = None,
        retry_budget: int = 2,
        deadline_ms: Optional[float] = None,
        seed: int = 0,
        obs: Optional[Observability] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.platform = platform
        self.router = router
        self.queues = [ServerQueue(queue_cfg) for _ in range(platform.n_servers)]
        self.hedge_ms = hedge_ms
        self.retry_budget = retry_budget
        self.deadline_ms = deadline_ms
        self.seed = seed
        # observability: counters mirror the TrafficReport tallies into the
        # shared registry; with tracing enabled, every request becomes a
        # serve/queue_wait span pair on the sim clock and every chaos fault
        # is rendered as structure on a dedicated "chaos" track
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._m_offered = reg.counter("sim_offered_total", "req")
        self._m_completed = reg.counter("sim_completed_total", "req")
        self._m_failed = reg.counter("sim_failed_total", "req")
        self._m_drops = reg.counter("sim_drops_total", "drops")
        self._m_crashes = reg.counter("sim_crashes_total", "crashes")
        self._m_hedges = reg.counter("sim_hedges_total", "hedges")
        self._m_routes = reg.counter("sim_routes_total", "routes")
        self._m_latency = reg.histogram("sim_latency_ms", "ms")
        self._heap: list = []
        self._seq = 0
        self._draws: np.ndarray = np.zeros((0,))
        self._draw_i = 0
        # per-tick observed-window cache: at mega-fleet scale the window
        # densification dominates _route, and every request arriving in
        # the same tick (with no feed-forward write in between) sees the
        # same history — key on (tick, platform.obs_version)
        self._win_key: tuple = (-1, -1)
        self._win: Optional[np.ndarray] = None

    # -- helpers -------------------------------------------------------------
    def _tick(self, t_ms: float) -> int:
        return int(np.clip(t_ms / 1000.0 / self.platform.dt_s,
                           0, self.platform.n_steps - 1))

    def _push(self, t_ms: float, kind: int, payload) -> None:
        heapq.heappush(self._heap, (t_ms, self._seq, kind, payload))
        self._seq += 1

    def _loads(self) -> np.ndarray:
        return np.asarray([q.utilization for q in self.queues], np.float32)

    def _service_draws(self, n: int) -> np.ndarray:
        """n Exp(1) service draws: f32 on the device from a generator
        seeded with ``seed``, widened to f64 on the host."""
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        x = torch.empty((n,), dtype=torch.float32, device=self.device)
        return x.exponential_(generator=gen).cpu().numpy().astype(np.float64)

    def _next_draw(self) -> float:
        d = float(self._draws[self._draw_i % self._draws.size])
        self._draw_i += 1
        return d

    def _window(self, tick: int) -> np.ndarray:
        key = (tick, self.platform.obs_version)
        if key != self._win_key:
            self._win = self.platform.latency_window(tick)
            self._win_key = key
        return self._win

    def _route(self, text: str, now_ms: float, failed: set = frozenset(),
               region: int = -1,
               affinity: Optional[np.ndarray] = None) -> int:
        tick = self._tick(now_ms)
        hist = self._window(tick)
        loads = self._loads()
        if isinstance(self.router, Router):
            kwargs = {}
            if getattr(self.router, "uses_staleness", False):
                kwargs["telemetry_age_s"] = self.platform.telemetry_age_s(tick)
            if getattr(self.router, "uses_failover", False) and failed:
                mask = np.zeros(len(self.queues), bool)
                mask[list(failed)] = True
                kwargs["failed_mask"] = mask
            if getattr(self.router, "uses_rtt", False):
                rtt = self.platform.client_rtt_ms(region, tick)
                if rtt is not None:
                    kwargs["client_rtt_ms"] = rtt
            if getattr(self.router, "uses_affinity", False) \
                    and affinity is not None:
                kwargs["affinity"] = affinity
            return self.router.select(text, hist, loads, **kwargs).server_idx
        return int(self.router(text, hist, loads))

    def _affinity(self, req: Request, now_ms: float) -> Optional[np.ndarray]:
        """Per-request session-warmth vector for affinity-aware routers.
        The base sim carries no session state; `sessions.sim` overrides
        this with the live `WarmthTracker` read."""
        return None

    def _fail_copy(self, req: Request, server: int, now_ms: float,
                   exclude: frozenset, server_dead: bool = False) -> None:
        """One copy was lost — queue overflow or a crashed station: record
        the outage (blackout permitting), charge the retry budget and
        re-route — the agent-side exception handler, seen from the fleet.
        `server_dead` additionally marks the server in the request's
        failed set (the SONAR-FT failover mask); overflow drops don't,
        since the station is alive, just saturated."""
        req.n_drops += 1
        if server_dead:
            req.failed_servers.add(server)
        # keep the registry aligned with TrafficReport: `sim_drops_total`
        # mirrors n_drop_events (queue overflow only); dead-station kills
        # are a separate series
        (self._m_crashes if server_dead else self._m_drops).inc()
        self.obs.tracer.instant(
            "crash" if server_dead else "drop", now_ms, cat="fault",
            args={"rid": req.rid, "server": server},
        )
        self.platform.record_observation(
            server, self._tick(now_ms), L.OFFLINE_MS
        )
        if req.budget > 0:
            req.budget -= 1
            self._dispatch(req, now_ms, exclude)
        elif req.live_copies == 0 and not req.done:
            req.failed = True
            self._m_failed.inc()
            self.obs.tracer.instant(
                "fail", now_ms, cat="fault", args={"rid": req.rid}
            )
            # adaptation feedback: a terminally-failed request is reward 0
            observe = getattr(self.router, "observe_outcome", None)
            if observe is not None:
                observe(0.0, ok=False, feats=req.feats)

    # -- event handlers ------------------------------------------------------
    def _dispatch(self, req: Request, now_ms: float, exclude: frozenset = frozenset()):
        server = self._route(req.text, now_ms, req.failed_servers, req.region,
                             self._affinity(req, now_ms))
        req.n_routes += 1
        self._m_routes.inc()
        # SONAR-ADAPT credit assignment: stash the winner features of the
        # routing decision that placed this copy; the outcome hooks in
        # `_finish` / `_fail_copy` feed them back with the shaped reward
        req.feats = getattr(self.router, "last_feats", None)
        if not self.platform.is_alive(server, self._tick(now_ms)):
            # connection refused: the station is crashed or partitioned
            self._fail_copy(req, server, now_ms, exclude, server_dead=True)
            return
        if server in exclude:
            # hedge copies must land on a *different* station; fall back to
            # the least-utilized non-excluded live server (infrastructure-
            # level placement, independent of the routing algorithm)
            loads = self._loads()
            alive = self.platform.alive_mask(self._tick(now_ms))
            order = np.argsort(loads, kind="stable")
            server = next(
                (int(s) for s in order
                 if int(s) not in exclude and alive[int(s)]), -1
            )
            if server < 0:      # every station excluded: nowhere to hedge
                return
        disp = _Dispatch(req, server, self._next_draw(), now_ms)
        q = self.queues[server]
        outcome = q.offer(disp, now_ms)
        if outcome == "start":
            req.live_copies += 1
            self._start_service(disp, now_ms)
        elif outcome == "queued":
            req.live_copies += 1
            if self.hedge_ms is not None and not req.hedged and req.hedge_ok:
                self._push(now_ms + self.hedge_ms, _HEDGE, req)
        else:  # dropped — waiting room full: an outage event, fed forward
            # so network-aware routers see the saturated station
            self._fail_copy(req, server, now_ms, exclude)

    def _start_service(self, disp: _Dispatch, now_ms: float) -> None:
        q = self.queues[disp.server]
        disp.service_ms = q.service_time(disp.draw_ms)
        q.record_service(disp.service_ms)
        disp.t_start_ms = now_ms
        disp.started = True
        self._push(now_ms + disp.service_ms, _FINISH, disp)

    def _finish(self, disp: _Dispatch, now_ms: float) -> None:
        q = self.queues[disp.server]
        nxt = q.finish(now_ms)
        if nxt is not None:
            self._start_service(nxt, now_ms)
        req = disp.req
        req.live_copies -= 1
        if req.done:
            return                      # a hedge sibling already won
        if not self.platform.is_alive(disp.server, self._tick(now_ms)):
            # the station crashed while this copy was in service: the work
            # (and its response) is lost — treat like a failed call
            self._fail_copy(req, disp.server, now_ms, frozenset(),
                            server_dead=True)
            return
        req.done = True
        # region-composed network latency: server-side QoS + propagation
        # RTT of the request's client region (zero for untagged requests)
        net_ms = self.platform.total_latency_at(
            disp.server, self._tick(now_ms), req.region
        )
        req.t_start_ms = disp.t_start_ms
        req.t_finish_ms = now_ms + net_ms
        req.service_ms = disp.service_ms
        req.net_ms = net_ms
        req.server_idx = disp.server
        self._m_completed.inc()
        self._m_latency.observe(req.t_finish_ms - req.t_arrival_ms)
        # serve (arrival -> client completion) wrapping queue_wait
        # (arrival -> service start of the winning copy), sim-clock ms
        emit_request_spans(
            self.obs.tracer, req.rid, req.t_arrival_ms,
            disp.t_start_ms, req.t_finish_ms, replica_idx=disp.server,
        )
        # feed-forward: the *client-observed* latency, queueing included
        self.platform.record_observation(
            disp.server, self._tick(req.t_finish_ms),
            req.t_finish_ms - req.t_arrival_ms,
        )
        # adaptation feedback: completion latency vs. SLO, shaped by the
        # learner itself (duck-typed so non-adaptive routers pay nothing)
        observe = getattr(self.router, "observe_outcome", None)
        if observe is not None:
            observe(req.t_finish_ms - req.t_arrival_ms, ok=True,
                    feats=req.feats)
        # cancel queued siblings (in-service ones run to completion as
        # wasted work, as real hedged requests do)
        for oq in self.queues:
            for item in list(oq.waiting):
                if item.req is req:
                    if oq.cancel_waiting(item):
                        req.live_copies -= 1

    def _hedge(self, req: Request, now_ms: float) -> None:
        if req.done or req.failed or req.budget <= 0 or not req.hedge_ok:
            return
        waiting = any(
            item.req is req for q in self.queues for item in q.waiting
        )
        if not waiting:
            return                      # already in service (or dropped out)
        hosts = frozenset(
            i for i, q in enumerate(self.queues)
            for item in q.waiting if item.req is req
        )
        if len(hosts) >= len(self.queues):
            return                      # no other station to hedge onto
        req.budget -= 1
        req.n_hedges += 1
        req.hedged = True
        self._m_hedges.inc()
        self.obs.tracer.instant(
            "hedge", now_ms, cat="fault", args={"rid": req.rid}
        )
        self._dispatch(req, now_ms, hosts)

    # -- driver --------------------------------------------------------------
    def run(
        self,
        arrivals_s: np.ndarray,
        texts: Sequence[str],
        regions: Optional[np.ndarray] = None,
    ) -> TrafficReport:
        """Simulate one arrival stream; texts are cycled over the arrivals.

        ``regions`` (optional, i32 aligned with ``arrivals_s``) tags each
        request with its client region — see `repro_torch.geo.regional_arrivals`.
        Tagged requests pay the propagation RTT of their region to the
        winning server on completion, and locality-aware routers receive
        their region's RTT row."""
        arrivals_s = np.asarray(arrivals_s, np.float64)
        order = np.argsort(arrivals_s, kind="stable")
        arrivals_s = arrivals_s[order]
        if regions is not None:
            regions = np.asarray(regions, np.int64)[order]
        n = arrivals_s.size
        # pre-sample every service draw from one stream (deterministic)
        n_draws = max(n * (2 + self.retry_budget), 1)
        self._draws = (self._service_draws(n_draws)
                       * self.queues[0].cfg.base_service_ms)
        self._draw_i = 0

        requests = [
            Request(
                rid=i, text=texts[i % len(texts)],
                t_arrival_ms=1000.0 * t, budget=self.retry_budget,
                region=int(regions[i]) if regions is not None else -1,
            )
            for i, t in enumerate(arrivals_s)
        ]
        self._heap, self._seq = [], 0
        self._m_offered.inc(n)
        if self.obs.tracer.enabled:
            # render the fault schedule (if any) before the request spans
            # so the chaos track aligns with what the requests experience
            emit_chaos_events(
                self.obs.tracer, self.platform.chaos, self.platform.dt_s
            )
        for req in requests:
            self._push(req.t_arrival_ms, _ARRIVAL, req)

        while self._heap:
            t_ms, _, kind, payload = heapq.heappop(self._heap)
            if kind == _ARRIVAL:
                self._dispatch(payload, t_ms)
            elif kind == _FINISH:
                self._finish(payload, t_ms)
            else:
                self._hedge(payload, t_ms)

        return self._report(requests, arrivals_s)

    def _report(self, requests: list, arrivals_s: np.ndarray) -> TrafficReport:
        done = [r for r in requests if r.done]
        lat = np.asarray([r.t_finish_ms - r.t_arrival_ms for r in done])
        if self.deadline_ms is not None:
            good = [r for r in done if r.t_finish_ms - r.t_arrival_ms <= self.deadline_ms]
        else:
            good = done
        horizon_s = float(arrivals_s[-1]) if arrivals_s.size else 0.0
        span_s = max(
            horizon_s,
            max((r.t_finish_ms for r in done), default=0.0) / 1000.0,
            1e-9,
        )
        served = np.zeros(len(self.queues), np.int64)
        for r in done:
            served[r.server_idx] += 1
        n_drops = int(sum(q.stats.dropped for q in self.queues))
        # normalize every station's busy integral by the common sim end time
        # (a queue's own clock stops at its last event, which would inflate
        # utilization for servers that went idle early)
        t_end_ms = max((q._last_t_ms for q in self.queues), default=0.0)
        utils = [
            q.stats.busy_ms / max(q.cfg.capacity * t_end_ms, 1e-9)
            for q in self.queues
        ]
        return TrafficReport(
            n_offered=len(requests),
            n_completed=len(done),
            n_failed=sum(r.failed for r in requests),
            n_drop_events=n_drops,
            n_hedges=sum(r.n_hedges for r in requests),
            goodput_rps=len(good) / span_s,
            p50_ms=float(np.percentile(lat, 50)) if lat.size else 0.0,
            p99_ms=float(np.percentile(lat, 99)) if lat.size else 0.0,
            mean_ms=float(lat.mean()) if lat.size else 0.0,
            per_server_served=[int(s) for s in served],
            max_share=float(served.max() / max(served.sum(), 1)),
            mean_utilization=float(np.mean(utils)) if utils else 0.0,
            requests=requests,
        )
