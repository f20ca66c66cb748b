"""Agent module (paper Sec. III-A Module 3), twin of `repro.core.agent`:
the call-chat loop.

Coordinates user query -> tool routing -> tool call -> evaluation,
alternating tool calls with (simulated) LLM chat turns until the task
completes or the turn budget is exhausted, retrying after timeouts and
outages.  The judge is an exact-match scorer in sim mode.

Two drivers share the episode semantics:

  `Agent`      — the scalar call-chat loop, one `Router.select` per turn.
  `BatchAgent` — the vectorized driver: every turn routes *all* tasks in
                 one `BatchRoutingEngine.route` call on per-query latency
                 windows (on the engine's device: the BM25, per-query QoS
                 and fused stage-2 kernels on the card), then executes the
                 calls against the platform traces in bulk on the host.
                 One host sync a turn, where the decisions come back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import latency as L
from repro_torch.core.batch_routing import BatchRoutingEngine
from repro_torch.core.dataset import Query
from repro_torch.core.platform import NetMCPPlatform, ToolResult  # noqa: F401
from repro_torch.core.routing import Decision, Router


@dataclasses.dataclass
class TaskRecord:
    query: Query
    success: bool
    n_calls: int
    n_failures: int
    decisions: list            # list[Decision], one per turn
    call_latencies_ms: list    # actual latency of every executed call
    select_latency_ms: float   # total selection latency across turns
    completion_ms: float       # end-to-end: selection + calls + chat turns
    final_server_idx: int
    final_expertise: float


class Agent:
    """Call-chat loop with routing feedback.

    On a failed call the agent re-routes (a fresh `select` against the
    updated latency history, the feed-forward path) and retries, up to
    `max_turns`.  A purely semantic router re-derives the same choice every
    turn, so PRAG keeps routing to the top-ranked tool on a server in
    downtime; SONAR's network term steers the retry away.

    Hedging (off by default): with `hedge_ms` set, a primary call slower
    than the threshold is raced against a duplicate to the highest-ranked
    candidate on a *different* server, and the episode takes whichever
    completes first (hedge completion = hedge_ms + duplicate latency).
    `retry_budget` bounds the extra calls (hedges and failure retries) a
    task may spend; None leaves the loop bounded by `max_turns` alone."""

    def __init__(
        self,
        platform: NetMCPPlatform,
        router: Router,
        max_turns: int = 8,
        chat_turn_ms: float = 150.0,
        ticks_per_turn: int = 1,
        hedge_ms: Optional[float] = None,
        retry_budget: Optional[int] = None,
    ):
        self.platform = platform
        self.router = router
        self.max_turns = max_turns
        self.chat_turn_ms = chat_turn_ms
        self.ticks_per_turn = ticks_per_turn
        self.hedge_ms = hedge_ms
        self.retry_budget = retry_budget

    def _hedge_decision(self, decision: Decision) -> Optional[Decision]:
        """Highest-ranked candidate tool hosted on a different server."""
        for tool in decision.candidate_tools:
            server = int(self.router.index.tool_server[tool])
            if server != decision.server_idx:
                return Decision(
                    server_idx=server,
                    tool_idx=int(tool),
                    expertise=0.0, network=0.0, fused=0.0,
                    select_latency_ms=0.0,
                    candidate_servers=decision.candidate_servers,
                    candidate_tools=decision.candidate_tools,
                )
        return None

    def _mark_failed(self, failed: Optional[np.ndarray], server_idx: int) -> np.ndarray:
        if failed is None:
            failed = np.zeros(len(self.platform.servers), bool)
        failed[server_idx] = True
        return failed

    def run_task(self, query: Query, t_idx: int) -> TaskRecord:
        decisions, latencies = [], []
        n_fail, sl_total, wall_ms = 0, 0.0, 0.0
        success = False
        t = t_idx
        budget = self.retry_budget if self.retry_budget is not None else -1
        # SONAR-FT: servers whose calls failed this episode are masked out
        # of later re-routes, and the router sees the telemetry ages
        uses_staleness = getattr(self.router, "uses_staleness", False)
        uses_failover = getattr(self.router, "uses_failover", False)
        failed: Optional[np.ndarray] = None

        for _turn in range(self.max_turns):
            hist = self.platform.latency_window(t)
            decision = self.router.select(
                query.text, hist,
                telemetry_age_s=self.platform.telemetry_age_s(t) if uses_staleness else None,
                failed_mask=failed,
            )
            decisions.append(decision)
            sl_total += decision.select_latency_ms
            wall_ms += decision.select_latency_ms

            result = self.platform.call_tool(decision, query, t)
            latencies.append(result.latency_ms)
            call_ms = result.latency_ms
            if hasattr(self.router, "observe"):   # adaptive alpha/beta hook
                self.router.observe(result.latency_ms, result.online)

            # hedge: race a duplicate on the runner-up server when the
            # primary is slow and budget remains
            if (
                self.hedge_ms is not None
                and budget != 0
                and result.latency_ms > self.hedge_ms
                and (alt := self._hedge_decision(decision)) is not None
            ):
                budget -= 1
                alt_result = self.platform.call_tool(alt, query, t)
                latencies.append(alt_result.latency_ms)
                if hasattr(self.router, "observe"):
                    self.router.observe(alt_result.latency_ms, alt_result.online)
                if not alt_result.online:
                    n_fail += 1
                    if uses_failover:      # the hedge server is known-dead
                        failed = self._mark_failed(failed, alt.server_idx)
                hedged_ms = self.hedge_ms + alt_result.latency_ms
                if alt_result.online and (not result.online or hedged_ms < result.latency_ms):
                    if not result.online:
                        n_fail += 1   # the out-raced primary still failed
                    decisions.append(alt)
                    decision, result = alt, alt_result
                    call_ms = hedged_ms
            wall_ms += call_ms + self.chat_turn_ms
            t += self.ticks_per_turn

            if not result.online:
                n_fail += 1       # server failure event (FR numerator)
                if uses_failover:
                    failed = self._mark_failed(failed, decision.server_idx)
                if budget == 0:
                    break         # retry budget exhausted: give up
                budget -= 1 if budget > 0 else 0
                continue          # re-route and retry
            # online call: the chat phase judges task completion
            success = result.success
            break

        final = decisions[-1]
        return TaskRecord(
            query=query,
            success=success,
            n_calls=len(latencies),
            n_failures=n_fail,
            decisions=decisions,
            call_latencies_ms=latencies,
            select_latency_ms=sl_total,
            completion_ms=wall_ms,
            final_server_idx=final.server_idx,
            final_expertise=final.expertise,
        )

    def run_benchmark(
        self,
        queries: list,
        t_start: int = 0,
        ticks_per_query: int = 4,
        seed: int = 0,
    ) -> list:
        """Run a query batch across the simulated horizon (uniformly spread
        so outage/fluctuation phases are sampled representatively)."""
        ticks = spread_start_ticks(
            len(queries), self.platform.n_steps, self.max_turns,
            self.ticks_per_turn, t_start, ticks_per_query, seed,
        )
        return [self.run_task(q, int(t)) for q, t in zip(queries, ticks)]


def spread_start_ticks(
    n: int,
    n_steps: int,
    max_turns: int,
    ticks_per_turn: int,
    t_start: int = 0,
    ticks_per_query: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """The start-time assignment of `Agent.run_benchmark` as a vector
    (numpy's ``default_rng``, so equal to the reference's)."""
    rng = np.random.default_rng(seed)
    horizon = n_steps - max_turns * ticks_per_turn - 1
    t = t_start + np.arange(n, dtype=np.int64) * ticks_per_query
    over = t >= horizon
    t[over] = rng.integers(0, horizon, size=int(over.sum()))
    return t


class BatchAgent:
    """Vectorized episode driver over the batched routing engine.

    Episodes are turn-synchronous: at turn k every still-unfinished task
    routes (one engine call on per-query latency windows), executes, and
    either completes or retries at turn k+1: the retry and feed-forward
    semantics of `Agent.run_task`, minus the scalar loop.  Sim-mode
    execution only.
    """

    def __init__(
        self,
        platform: NetMCPPlatform,
        engine: BatchRoutingEngine,
        max_turns: int = 8,
        chat_turn_ms: float = 150.0,
        ticks_per_turn: int = 1,
    ):
        if platform.mode != "sim":
            raise ValueError("BatchAgent drives sim-mode episodes")
        self.platform = platform
        self.engine = engine
        self.max_turns = max_turns
        self.chat_turn_ms = chat_turn_ms
        self.ticks_per_turn = ticks_per_turn

    def run_benchmark(
        self,
        queries: list,
        t_start: int = 0,
        ticks_per_query: int = 4,
        seed: int = 0,
    ) -> list:
        plat = self.platform
        n = len(queries)
        t_vec = spread_start_ticks(
            n, plat.n_steps, self.max_turns, self.ticks_per_turn,
            t_start, ticks_per_query, seed,
        )
        batch = self.engine.encode([q.text for q in queries])
        sl_per_decision = self.engine.select_latency_ms()
        domains = np.asarray([s.domain for s in plat.servers])
        intents = np.asarray([q.intent for q in queries])

        active = np.ones(n, dtype=bool)
        success = np.zeros(n, dtype=bool)
        n_fail = np.zeros(n, dtype=np.int64)
        wall_ms = np.zeros(n, dtype=np.float64)
        sl_total = np.zeros(n, dtype=np.float64)
        per_turn: list = []          # (active_mask, decisions, latencies)
        latencies: list = [[] for _ in range(n)]
        # SONAR-FT: per-query failed-server masks grown across turns, and
        # per-query telemetry ages, as the scalar Agent
        uses_staleness = getattr(self.engine, "uses_staleness", False)
        uses_failover = getattr(self.engine, "uses_failover", False)
        failed = np.zeros((n, len(plat.servers)), bool) if uses_failover else None

        for _turn in range(self.max_turns):
            # route the FULL batch every turn (constant shapes); results are
            # applied only to still-active tasks
            windows = plat.latency_windows(t_vec)
            dec = self.engine.route(
                batch, windows,
                telemetry_age_s=plat.telemetry_ages_s(t_vec) if uses_staleness else None,
                failed_mask=failed if (failed is not None and failed.any()) else None,
            )

            t_clip = np.clip(t_vec, 0, plat.n_steps - 1)
            lat = plat.traces[dec.server_idx, t_clip]
            online = lat < L.OFFLINE_MS
            ok = online & (domains[dec.server_idx] == intents)

            # feed-forward recording for executed (active) calls only
            plat.record_observations(dec.server_idx[active], t_clip[active], lat[active])

            sl_total[active] += sl_per_decision
            wall_ms[active] += sl_per_decision + lat[active] + self.chat_turn_ms
            n_fail[active & ~online] += 1
            success[active & online] = ok[active & online]
            if failed is not None:
                died = np.flatnonzero(active & ~online)
                failed[died, dec.server_idx[died]] = True
            for i in np.flatnonzero(active):
                latencies[i].append(float(lat[i]))
            per_turn.append((active.copy(), dec, lat))

            t_vec = t_vec + self.ticks_per_turn
            active = active & ~online           # only failed calls retry
            if not active.any():
                break

        return self._build_records(queries, per_turn, latencies, success, n_fail, sl_total,
                                   wall_ms)

    def _build_records(self, queries, per_turn, latencies, success, n_fail, sl_total,
                       wall_ms) -> list:
        n = len(queries)
        decisions: list = [[] for _ in range(n)]
        for mask, dec, _lat in per_turn:
            for i in np.flatnonzero(mask):
                decisions[i].append(
                    Decision(
                        server_idx=int(dec.server_idx[i]),
                        tool_idx=int(dec.tool_idx[i]),
                        expertise=float(dec.expertise[i]),
                        network=float(dec.network[i]),
                        fused=float(dec.fused[i]),
                        select_latency_ms=float(dec.select_latency_ms),
                        candidate_servers=[],
                        candidate_tools=[],
                    )
                )
        records = []
        for i, q in enumerate(queries):
            final = decisions[i][-1]
            records.append(
                TaskRecord(
                    query=q,
                    success=bool(success[i]),
                    n_calls=len(latencies[i]),
                    n_failures=int(n_fail[i]),
                    decisions=decisions[i],
                    call_latencies_ms=latencies[i],
                    select_latency_ms=float(sl_total[i]),
                    completion_ms=float(wall_ms[i]),
                    final_server_idx=final.server_idx,
                    final_expertise=final.expertise,
                )
            )
        return records
