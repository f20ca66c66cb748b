"""Discrete-event session simulator: DAG release + task-level accounting,
twin of `repro.sessions.sim`.

`SessionTrafficSim` extends `traffic.simulator.FleetTrafficSim` so that a
"request" becomes one *node* of a session DAG:

  - root nodes arrive at the session's arrival time; every other node is
    released the instant its last parent's client-observed completion
    lands (the agent framework's dependency barrier);
  - a node that exhausts its retry budget fails its whole task — every
    not-yet-released descendant is *abandoned* (never offered to the
    fleet), which the accounting tracks separately from failures;
  - completions touch the session's `WarmthTracker`, and affinity-aware
    routers (SONAR-SESSION) receive the live warmth vector on every
    node's routing decision — the ``+eps*W`` sticky bonus;
  - hedging is DAG-aware: only critical-path nodes may hedge
    (``Request.hedge_ok``); off-path nodes have slack that absorbs
    stragglers without duplicated work.

Task-level accounting: a task (= session) succeeds iff **every** node
completes; its completion time is the last node's client-observed finish
minus the session arrival.  Node conservation holds per session and in
aggregate:

    offered nodes == completed + failed + abandoned

(`SessionReport.check_accounting` checks it), mirroring the serving
gateway's request-conservation invariant at the task level.  The service
draws come from the base simulator's `_service_draws` (a `torch.Generator`
on the simulator's device).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.trace import emit_chaos_events  # noqa: F401  (the reference's re-export)
from repro_torch.sessions.dag import SessionDAG, critical_path
from repro_torch.sessions.warmth import WarmthTracker
from repro_torch.traffic.simulator import (
    _ARRIVAL,
    _FINISH,
    FleetTrafficSim,
    Request,
)

__all__ = ["SessionReport", "SessionTrafficSim"]


class _SessionState:
    """Live bookkeeping for one in-flight session."""

    __slots__ = ("dag", "requests", "children", "pending_parents",
                 "resolved", "released", "t_arrival_ms",
                 "t_done_ms", "failed")

    def __init__(self, dag: SessionDAG, requests: list):
        self.dag = dag
        self.requests = requests            # Request per node, id-aligned
        self.children = dag.children()
        self.pending_parents = {
            n.node_id: len(n.parents) for n in dag.nodes
        }
        self.resolved: dict = {}            # node_id -> outcome str
        self.released: set = set()
        self.t_arrival_ms = 1000.0 * dag.t_arrival_s
        self.t_done_ms = self.t_arrival_ms
        self.failed = False

    @property
    def settled(self) -> bool:
        return len(self.resolved) == self.dag.n_nodes

    @property
    def succeeded(self) -> bool:
        return self.settled and all(
            v == "completed" for v in self.resolved.values()
        )


@dataclasses.dataclass
class SessionReport:
    """Task-level outcome of one session-workload run."""

    n_sessions: int
    n_tasks_succeeded: int
    n_tasks_failed: int
    task_success_rate: float
    task_p50_ms: float            # completion time of *successful* tasks
    task_p99_ms: float
    task_mean_ms: float
    n_nodes_offered: int          # nodes released to the fleet
    n_nodes_completed: int
    n_nodes_failed: int
    n_nodes_abandoned: int        # never released (upstream failure)
    n_hedges: int
    per_template: dict            # template -> (n, n_succeeded)
    requests: list                # every node Request (released or not)

    def check_accounting(self) -> None:
        """Node conservation: every DAG node is exactly one of
        completed / failed / abandoned, and offered == released."""
        total = (self.n_nodes_completed + self.n_nodes_failed
                 + self.n_nodes_abandoned)
        if self.n_nodes_offered + self.n_nodes_abandoned != total:
            raise AssertionError(
                f"node accounting leak: offered={self.n_nodes_offered} "
                f"completed={self.n_nodes_completed} "
                f"failed={self.n_nodes_failed} "
                f"abandoned={self.n_nodes_abandoned}"
            )
        if self.n_tasks_succeeded + self.n_tasks_failed != self.n_sessions:
            raise AssertionError("task accounting leak")

    def row(self, name: str) -> str:
        return (
            f"{name},tasks={self.n_sessions},"
            f"success={self.task_success_rate:.3f},"
            f"task_p99={self.task_p99_ms:.0f}ms,"
            f"abandoned={self.n_nodes_abandoned}"
        )


class SessionTrafficSim(FleetTrafficSim):
    """`FleetTrafficSim` driving session DAGs instead of a flat stream.

    Construction mirrors the base sim; additionally ``warmth_half_life_ms``
    sets the sticky-affinity decay (the W term SONAR-SESSION consumes) and
    ``warm_speedup`` models context reuse: a node landing on a server
    whose warmth for its session is >= ``warm_threshold`` runs at
    ``warm_speedup * service_time`` (KV cache / sandbox / fetched-context
    reuse).  The discount is a property of the *fleet*, not the router —
    every algorithm that happens to land warm gets it, so comparisons
    stay fair.
    """

    def __init__(self, *args, warmth_half_life_ms: float = 30_000.0,
                 warm_speedup: float = 0.6, warm_threshold: float = 0.5,
                 **kw):
        super().__init__(*args, **kw)
        if not 0.0 < warm_speedup <= 1.0:
            raise ValueError(f"warm_speedup must be in (0, 1], not {warm_speedup}")
        self.warm_speedup = float(warm_speedup)
        self.warm_threshold = float(warm_threshold)
        self.warmth = WarmthTracker(
            self.platform.n_servers, half_life_ms=warmth_half_life_ms
        )
        reg = self.obs.registry
        self._m_tasks = reg.counter("task_offered_total", "tasks")
        self._m_task_ok = reg.counter("task_completed_total", "tasks")
        self._m_task_fail = reg.counter("task_failed_total", "tasks")
        self._m_nodes_released = reg.counter(
            "task_nodes_released_total", "nodes"
        )
        self._m_nodes_ok = reg.counter("task_nodes_completed_total", "nodes")
        self._m_nodes_fail = reg.counter("task_nodes_failed_total", "nodes")
        self._m_nodes_abandoned = reg.counter(
            "task_nodes_abandoned_total", "nodes"
        )
        self._sessions: dict = {}

    # -- affinity hook -------------------------------------------------------
    def _affinity(self, req: Request, now_ms: float) -> Optional[np.ndarray]:
        if req.session_id < 0:
            return None
        return self.warmth.warmth(req.session_id, now_ms)

    # -- DAG release machinery ----------------------------------------------
    def _release(self, st: _SessionState, node_id: int, t_ms: float) -> None:
        req = st.requests[node_id]
        req.t_arrival_ms = t_ms
        st.released.add(node_id)
        self._m_nodes_released.inc()
        self._m_offered.inc()
        self._push(t_ms, _ARRIVAL, req)

    def _abandon_descendants(self, st: _SessionState, node_id: int) -> None:
        """Mark every not-yet-released descendant abandoned — with a
        failed ancestor its dependency barrier can never clear."""
        stack = list(st.children[node_id])
        while stack:
            c = stack.pop()
            if c in st.resolved or c in st.released:
                continue
            st.resolved[c] = "abandoned"
            self._m_nodes_abandoned.inc()
            stack.extend(st.children[c])

    def _advance_session(self, req: Request, now_ms: float) -> None:
        """Called after any event that may have settled a node: fold the
        node's outcome into its session and release unblocked children."""
        if req.session_id < 0 or req.session_id not in self._sessions:
            return
        st = self._sessions[req.session_id]
        nid = req.node_id
        if nid in st.resolved:
            return
        if req.done:
            st.resolved[nid] = "completed"
            self._m_nodes_ok.inc()
            st.t_done_ms = max(st.t_done_ms, req.t_finish_ms)
            # sticky affinity: the winning server now holds this
            # session's context warm
            self.warmth.touch(req.session_id, req.server_idx,
                              req.t_finish_ms)
            if not st.failed:
                for c in st.children[nid]:
                    st.pending_parents[c] -= 1
                    if st.pending_parents[c] == 0:
                        self._release(st, c, req.t_finish_ms)
            else:
                # the task already failed elsewhere: in-flight branches
                # run out, but no new work is released for a dead task
                self._abandon_descendants(st, nid)
        elif req.failed:
            st.resolved[nid] = "failed"
            self._m_nodes_fail.inc()
            st.t_done_ms = max(st.t_done_ms, now_ms)
            st.failed = True
            self._abandon_descendants(st, nid)
        else:
            return
        if st.settled:
            self._settle_session(st)

    def _settle_session(self, st: _SessionState) -> None:
        if st.succeeded:
            self._m_task_ok.inc()
        else:
            self._m_task_fail.inc()
        self.warmth.forget(st.dag.session_id)

    # -- event-hook overrides ------------------------------------------------
    def _start_service(self, disp, now_ms: float) -> None:
        req = disp.req
        if self.warm_speedup < 1.0 and req.session_id >= 0:
            w = self.warmth.warmth(req.session_id, now_ms)
            if w is not None and \
                    float(w[disp.server]) >= self.warm_threshold:
                disp.draw_ms *= self.warm_speedup
        super()._start_service(disp, now_ms)

    def _finish(self, disp, now_ms: float) -> None:
        super()._finish(disp, now_ms)
        self._advance_session(disp.req, now_ms)

    def _fail_copy(self, req: Request, server: int, now_ms: float,
                   exclude, server_dead: bool = False) -> None:
        super()._fail_copy(req, server, now_ms, exclude, server_dead)
        self._advance_session(req, now_ms)

    # -- driver --------------------------------------------------------------
    def run_sessions(self, sessions: Sequence[SessionDAG]) -> SessionReport:
        """Simulate a session workload (e.g. from `dag.generate_sessions`).

        Root nodes arrive at each session's ``t_arrival_s``; everything
        else is released by the DAG barrier.  Deterministic given the
        sim seed and the session list.
        """
        sessions = sorted(sessions, key=lambda d: (d.t_arrival_s,
                                                   d.session_id))
        n_nodes = sum(d.n_nodes for d in sessions)
        n_draws = max(n_nodes * (2 + self.retry_budget), 1)
        self._draws = (self._service_draws(n_draws)
                       * self.queues[0].cfg.base_service_ms)
        self._draw_i = 0

        self._heap, self._seq = [], 0
        self._sessions = {}
        rid = 0
        for dag in sessions:
            crit = critical_path(dag)
            reqs = []
            for node in dag.nodes:
                reqs.append(Request(
                    rid=rid, text=node.text,
                    t_arrival_ms=1000.0 * dag.t_arrival_s,
                    budget=self.retry_budget, region=dag.region,
                    session_id=dag.session_id, node_id=node.node_id,
                    hedge_ok=node.node_id in crit,
                ))
                rid += 1
            st = _SessionState(dag, reqs)
            self._sessions[dag.session_id] = st
            self._m_tasks.inc()
            for root in dag.roots():
                self._release(st, root, st.t_arrival_ms)

        while self._heap:
            t_ms, _, kind, payload = heapq.heappop(self._heap)
            if kind == _ARRIVAL:
                self._dispatch(payload, t_ms)
            elif kind == _FINISH:
                self._finish(payload, t_ms)
            else:
                self._hedge(payload, t_ms)

        return self._session_report(sessions)

    def _session_report(self, sessions: list) -> SessionReport:
        states = [self._sessions[d.session_id] for d in sessions]
        ok_tasks = [st for st in states if st.succeeded]
        task_lat = np.asarray([
            st.t_done_ms - st.t_arrival_ms for st in ok_tasks
        ])
        per_template: dict = {}
        for st in states:
            n, s = per_template.get(st.dag.template, (0, 0))
            per_template[st.dag.template] = (
                n + 1, s + (1 if st.succeeded else 0)
            )
        requests = [r for st in states for r in st.requests]
        outcomes = [v for st in states for v in st.resolved.values()]
        n_completed = sum(v == "completed" for v in outcomes)
        n_failed = sum(v == "failed" for v in outcomes)
        n_abandoned = sum(v == "abandoned" for v in outcomes)
        report = SessionReport(
            n_sessions=len(states),
            n_tasks_succeeded=len(ok_tasks),
            n_tasks_failed=len(states) - len(ok_tasks),
            task_success_rate=len(ok_tasks) / max(len(states), 1),
            task_p50_ms=float(np.percentile(task_lat, 50))
            if task_lat.size else math.nan,
            task_p99_ms=float(np.percentile(task_lat, 99))
            if task_lat.size else math.nan,
            task_mean_ms=float(task_lat.mean())
            if task_lat.size else math.nan,
            n_nodes_offered=n_completed + n_failed,
            n_nodes_completed=n_completed,
            n_nodes_failed=n_failed,
            n_nodes_abandoned=n_abandoned,
            n_hedges=sum(r.n_hedges for r in requests),
            per_template=per_template,
            requests=requests,
        )
        report.check_accounting()
        return report
