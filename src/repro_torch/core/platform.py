"""NetMCP platform (paper Sec. III), twin of `repro.core.platform`: server
pool x network environment x dual-mode execution, with feed-forward
latency recording.

The platform binds together
  - a server pool (Module 1; `repro_torch.core.dataset`),
  - a network-status environment (Module 2; `repro_torch.core.latency`)
    that synthesizes one latency trace per server over a 24 h horizon on
    ``device`` (the card by default),
  - the dual-mode executor: `sim` mode returns deterministic expected task
    outcomes (free of external services); `live` mode calls an injected
    transport,
  - feed-forward recording: every executed call writes its *actual*
    latency into the host server's observed history so future routing
    decisions see up-to-date performance data (paper Sec. III-B),
  - optional chaos injection: a compiled fault schedule (duck-typed)
    overlays faults on the ground-truth traces, freezes the observed
    histories during telemetry blackouts (dropping feed-forward writes),
    and exposes `is_alive` / `telemetry_age_s`.

The traces and observed histories are host numpy arrays, as in the
reference; the routing engines copy the windows they are given to their
device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import latency as L
from repro_torch.core.dataset import WEBSEARCH, Query, Server
from repro_torch.core.routing import Decision


@dataclasses.dataclass
class ToolResult:
    latency_ms: float
    online: bool
    success: bool
    answer: str


# ---------------------------------------------------------------------------
# Scenario -> per-server latency-profile assignment (paper Sec. V-B, Fig. 6)
# ---------------------------------------------------------------------------

def _semantic_rank_websearch(servers: Sequence[Server]) -> list:
    """Rank websearch servers by their semantic (tool-level BM25) score
    against the canonical websearch intent, i.e. the order a purely
    semantic router (PRAG) prefers them in."""
    from repro_torch.core import bm25
    from repro_torch.core.routing import CANONICAL_DESCRIPTIONS

    ws = [i for i, s in enumerate(servers) if s.domain == WEBSEARCH]
    if not ws:
        return []
    docs, host = [], []
    for i in ws:
        for t in servers[i].tools:
            docs.append(f"{t.name.replace('_', ' ')} {t.description}")
            host.append(i)
    corpus = bm25.build_corpus(docs)
    scores = corpus.weights @ corpus.encode_query(CANONICAL_DESCRIPTIONS[WEBSEARCH])
    best_per_server = {}
    for j, h in enumerate(host):
        best_per_server[h] = max(best_per_server.get(h, -np.inf), float(scores[j]))
    return sorted(ws, key=lambda i: -best_per_server[i])


_MODERATE = dict(base_latency_ms=110.0, std_dev_ms=8.0)


def _hybrid_profiles(servers: Sequence[Server]) -> list:
    """5 websearch servers get the five canonical states; distractors ideal.

    The outage profile is pinned to the *semantically top-ranked* websearch
    server, the condition of Table II ("PRAG frequently routes requests to
    the top-ranked tool located on a server undergoing downtime"); the
    remaining four get fluctuating, high latency, high jitter, and low
    latency, in semantic-rank order."""
    ws_states = [
        L.outage_profile(base_ms=25.0, std_ms=4.0, probability=0.6),
        L.fluctuating_profile(base_ms=150.0, amplitude_ms=140.0, period_s=3600.0, phase=0.0),
        L.high_latency_profile(),
        L.high_jitter_profile(),
        L.LatencyProfile(base_latency_ms=20.0, std_dev_ms=4.0),  # low-latency
    ]
    ranked = _semantic_rank_websearch(servers)
    assign = {srv: ws_states[r % len(ws_states)] for r, srv in enumerate(ranked)}
    return [assign.get(i, L.ideal_profile()) for i in range(len(servers))]


def _fluctuating_profiles(servers: Sequence[Server]) -> list:
    """All websearch servers sinusoidal with distinct phase offsets;
    distractors get a stable-but-moderate profile (110 +- 8 ms), so the
    network term does not dominate semantics (Fig. 9)."""
    out, wi = [], 0
    for s in servers:
        if s.domain == WEBSEARCH:
            phase = 2.0 * np.pi * wi / 5.0
            out.append(
                L.fluctuating_profile(
                    base_ms=150.0, amplitude_ms=140.0, period_s=3600.0, phase=phase, std_ms=10.0,
                )
            )
            wi += 1
        else:
            out.append(L.LatencyProfile(**_MODERATE))
    return out


def _ideal_profiles(servers: Sequence[Server]) -> list:
    return [L.ideal_profile() for _ in servers]


def _high_latency_profiles(servers: Sequence[Server]) -> list:
    """All websearch servers in the high-latency state except the
    semantically *bottom*-ranked one, which stays ideal: one healthy escape
    hatch that a purely semantic router ranks last.  Distractors
    stable-moderate."""
    ranked = _semantic_rank_websearch(servers)
    assign = {srv: L.high_latency_profile() for srv in ranked[:-1]}
    if ranked:
        assign[ranked[-1]] = L.ideal_profile()
    return [assign.get(i, L.LatencyProfile(**_MODERATE)) for i in range(len(servers))]


def _high_jitter_profiles(servers: Sequence[Server]) -> list:
    """All websearch servers in the high-jitter state, with per-rank
    increasing jitter so the instability penalty has a gradient;
    distractors stable-moderate."""
    ranked = _semantic_rank_websearch(servers)
    assign = {
        srv: L.LatencyProfile(base_latency_ms=100.0, std_dev_ms=70.0 + 10.0 * r)
        for r, srv in enumerate(ranked)
    }
    return [assign.get(i, L.LatencyProfile(**_MODERATE)) for i in range(len(servers))]


def _diurnal_congestion_profiles(servers: Sequence[Server]) -> list:
    """A 24 h diurnal load rhythm on every websearch server,
    phase-staggered, plus congestion brownouts (outage state) on the
    semantically top-ranked server: peak-hour overload on the most popular
    replica."""
    ranked = _semantic_rank_websearch(servers)
    out: dict = {}
    for r, srv in enumerate(ranked):
        phase = 2.0 * np.pi * r / max(len(ranked), 1)
        out[srv] = L.LatencyProfile(
            base_latency_ms=140.0,
            std_dev_ms=15.0,
            amplitude_ms=110.0,
            period_s=24 * 3600.0,
            phase_shift=phase,
            outage_probability=0.35 if r == 0 else 0.0,
            outage_duration_min_s=20 * 60.0,
            outage_duration_max_s=60 * 60.0,
        )
    return [out.get(i, L.LatencyProfile(**_MODERATE)) for i in range(len(servers))]


# All five canonical network states of Fig. 4 appear as fleet assignments,
# plus the composed diurnal-congestion scenario.
SCENARIOS: dict = {
    "ideal": _ideal_profiles,
    "hybrid": _hybrid_profiles,
    "fluctuating": _fluctuating_profiles,
    "high_latency": _high_latency_profiles,
    "high_jitter": _high_jitter_profiles,
    "diurnal_congestion": _diurnal_congestion_profiles,
}


# ---------------------------------------------------------------------------
# Platform
# ---------------------------------------------------------------------------

class NetMCPPlatform:
    """Server pool x network environment x dual-mode execution.

    Parameters mirror `repro.core.platform.NetMCPPlatform`: ``servers``
    (None in template-tiled mode), ``scenario`` (a key of `SCENARIOS`,
    ignored when ``profiles`` is given), ``seed`` (trace synthesis; the
    same (seed, profiles, horizon, device type) always gives the same
    traces, memoized process-wide), ``horizon_s`` / ``dt_s`` in seconds
    (default 24 h at 10 s a tick, 8640 samples; latencies are ms),
    ``history_window`` (samples per window served to routers),
    ``profiles`` (per server, or per template in tiled mode),
    ``template_map`` (int [n_servers] template per server: tiled mode,
    traces [n_templates, T], feed-forward rows copied on first write),
    ``chaos`` and ``geo`` (duck-typed fault schedule and geo placement).
    ``device`` is where the traces are synthesized (None: the card).
    """

    def __init__(
        self,
        servers: Optional[Sequence[Server]] = None,
        scenario: str = "ideal",
        seed: int = 0,
        horizon_s: float = L.DEFAULT_HORIZON_S,
        dt_s: float = L.DEFAULT_DT_S,
        mode: str = "sim",
        history_window: int = 64,
        live_transport: Optional[Callable] = None,
        profiles: Optional[list] = None,
        chaos=None,
        template_map: Optional[np.ndarray] = None,
        geo=None,
        device=None,
    ):
        if mode not in ("sim", "live"):
            raise ValueError(f"mode must be 'sim' or 'live', not {mode!r}")
        self.servers = list(servers) if servers is not None else None
        self.template_map = (
            None if template_map is None else np.asarray(template_map, np.int64)
        )
        if self.template_map is not None:
            if profiles is None:
                raise ValueError("tiled mode needs a profile palette")
            if chaos is not None:
                raise ValueError("chaos injection needs dense traces")
            self.n_servers = int(self.template_map.size)
        else:
            if servers is None:
                raise ValueError("a dense platform needs its servers")
            self.n_servers = len(self.servers)
        self.scenario = scenario
        self.mode = mode
        self.dt_s = dt_s
        self.history_window = history_window
        self.live_transport = live_transport
        self.geo = geo
        if geo is not None and geo.server_region.size != self.n_servers:
            raise ValueError(
                f"geo placement covers {geo.server_region.size} servers, "
                f"platform has {self.n_servers}"
            )

        if profiles is None:
            profiles = SCENARIOS[scenario](self.servers)
        self.profiles = profiles
        packed = L.pack_profiles(profiles)
        n_steps = L.trace_horizon_steps(horizon_s, dt_s)
        # [n_servers, T] ms (or [n_templates, T] in tiled mode): ground-truth
        # network state, read-only (memoized)
        self.traces = L.generate_traces_cached(seed, packed, n_steps, dt_s, device=device)
        self.chaos = chaos
        # tiled mode: feed-forward writes copy-on-write per-server rows
        self._overlay: dict = {}
        # bumped on every feed-forward write; consumers key their per-tick
        # window caches on it
        self.obs_version = 0
        if chaos is not None:
            if chaos.down.shape != (self.n_servers, n_steps):
                raise ValueError(
                    f"chaos schedule shape {chaos.down.shape} != ({self.n_servers}, {n_steps})"
                )
            self.traces = chaos.apply_to_traces(self.traces)
            self.traces.setflags(write=False)
            # monitoring view: frozen (forward-filled) during blackouts
            self.observed = chaos.apply_staleness(self.traces)
        else:
            # observed histories: monitoring prefix + feed-forward records
            self.observed = self.traces.copy()
        self.n_steps = n_steps

    # -- network-state queries ------------------------------------------------
    def _window_of(self, arr: np.ndarray, t_idx: int, w: int) -> np.ndarray:
        """Rows' history up to (and including) tick t_idx, left-padded with
        the first sample when t_idx+1 < w so the shape is static."""
        lo = t_idx + 1 - w
        if lo >= 0:
            return arr[:, lo : t_idx + 1]
        pad = np.repeat(arr[:, :1], -lo, axis=1)
        return np.concatenate([pad, arr[:, : t_idx + 1]], axis=1)

    def latency_window(self, t_idx: int, window: Optional[int] = None) -> np.ndarray:
        """Observed latency history up to (and including) tick t_idx ->
        [n_servers, window] ms, what routers consume.  In tiled mode the
        window is densified from the template rows, overlaid with the
        copy-on-write feed-forward rows."""
        w = window or self.history_window
        t_idx = int(np.clip(t_idx, 0, self.n_steps - 1))
        if self.template_map is None:
            return self._window_of(self.observed, t_idx, w)
        out = self._window_of(self.observed, t_idx, w)[self.template_map]
        if self._overlay:
            idx = np.fromiter(self._overlay.keys(), np.int64)
            # slice each copied row to the window before stacking
            lo = t_idx + 1 - w
            rows = np.stack([self._overlay[s][max(lo, 0) : t_idx + 1] for s in idx])
            if lo < 0:
                rows = np.concatenate([np.repeat(rows[:, :1], -lo, axis=1), rows], axis=1)
            out[idx] = rows
        return out

    def compact_window(self, t_idx: int, window: Optional[int] = None) -> tuple:
        """Tiled mode: the observed window in template-compact form,
        ``([n_templates, window] ms, template_map [n_servers])``, what
        `ShardedRoutingEngine.route(telemetry_templates=...)` consumes.
        Only valid while no feed-forward observation has diverged a server
        from its template."""
        if self.template_map is None:
            raise ValueError("compact_window needs tiled mode")
        if self._overlay:
            raise ValueError(
                "feed-forward observations present: templates no longer "
                "describe every server; use latency_window"
            )
        w = window or self.history_window
        t_idx = int(np.clip(t_idx, 0, self.n_steps - 1))
        return self._window_of(self.observed, t_idx, w), self.template_map

    def latency_windows(self, t_indices: np.ndarray, window: Optional[int] = None) -> np.ndarray:
        """Vectorized `latency_window`: one observed-history slab per query
        time -> [n_q, n_servers, window], with the same left padding, what
        the batched engine consumes."""
        w = window or self.history_window
        t_indices = np.clip(np.asarray(t_indices, np.int64), 0, self.n_steps - 1)
        # per-query column indices [n_q, w]: t-w+1 .. t, clamped at 0
        cols = t_indices[:, None] + np.arange(-w + 1, 1)[None, :]
        cols = np.maximum(cols, 0)
        slab = self.observed[:, cols].transpose(1, 0, 2)
        if self.template_map is None:
            return slab
        out = slab[:, self.template_map]
        if self._overlay:
            idx = np.fromiter(self._overlay.keys(), np.int64)
            rows = np.stack([self._overlay[s][cols] for s in idx])
            out[:, idx] = rows.transpose(1, 0, 2)
        return out

    def latency_at(self, server_idx: int, t_idx: int) -> float:
        """Ground-truth latency (ms) of one server at tick t_idx."""
        t_idx = int(np.clip(t_idx, 0, self.n_steps - 1))
        if self.template_map is not None:
            return float(self.traces[self.template_map[server_idx], t_idx])
        return float(self.traces[server_idx, t_idx])

    # -- geo-state queries ---------------------------------------------------
    def client_rtt_ms(self, client_region: int, t_idx: Optional[int] = None) -> Optional[np.ndarray]:
        """f32 [n_servers] propagation RTT from one client region to every
        server at tick t; None without a geo placement or for an untagged
        (region < 0) client."""
        if self.geo is None or client_region is None or client_region < 0:
            return None
        return self.geo.client_rtt_ms(int(client_region), t_idx)

    def total_latency_at(self, server_idx: int, t_idx: int, client_region: int = -1) -> float:
        """Propagation RTT (client region -> host region at tick t) + the
        server-side latency; exactly `latency_at` without a placement or
        for an untagged client."""
        lat = self.latency_at(server_idx, t_idx)
        if self.geo is None or client_region < 0:
            return lat
        rtt = self.geo.topology.rtt_matrix(t_idx)[
            int(client_region), int(self.geo.server_region[server_idx])
        ]
        return lat + float(rtt)

    # -- chaos-state queries -------------------------------------------------
    def is_alive(self, server_idx: int, t_idx: int) -> bool:
        """False while the server is crashed/partitioned (chaos `down`)."""
        if self.chaos is None:
            return True
        return bool(self.chaos.alive_at(t_idx)[server_idx])

    def alive_mask(self, t_idx: int) -> np.ndarray:
        """bool [n_servers]: which servers answer at tick t."""
        if self.chaos is None:
            return np.ones(self.n_servers, bool)
        return self.chaos.alive_at(t_idx)

    def telemetry_age_s(self, t_idx: int) -> np.ndarray:
        """f32 [n_servers] seconds since each server's last fresh
        telemetry sample (zero without chaos), what SONAR-FT's staleness
        discount decays with."""
        if self.chaos is None:
            return np.zeros(self.n_servers, np.float32)
        return self.chaos.age_s(t_idx)

    def telemetry_ages_s(self, t_indices: np.ndarray) -> np.ndarray:
        """f32 [n_q, n_servers]: vectorized `telemetry_age_s`."""
        if self.chaos is None:
            return np.zeros((len(t_indices), self.n_servers), np.float32)
        return self.chaos.ages_s(t_indices)

    def record_observation(self, server_idx: int, t_idx: int, latency_ms: float) -> None:
        """Feed-forward recording (Sec. III-B): write an observed latency
        into the server's history.  Dropped during a telemetry blackout.
        In tiled mode the first write to a server copies its template row."""
        t_idx = int(np.clip(t_idx, 0, self.n_steps - 1))
        if self.chaos is not None and self.chaos.stale_at(server_idx, t_idx):
            return
        self.obs_version += 1
        if self.template_map is not None:
            row = self._overlay.get(int(server_idx))
            if row is None:
                row = self.observed[self.template_map[server_idx]].copy()
                self._overlay[int(server_idx)] = row
            row[t_idx] = latency_ms
            return
        self.observed[server_idx, t_idx] = latency_ms

    def record_observations(
        self, server_idx: np.ndarray, t_idx: np.ndarray, latency_ms: np.ndarray
    ) -> None:
        """Vectorized feed-forward recording with the same blackout gating
        (the batched episode driver's)."""
        server_idx = np.asarray(server_idx, np.int64)
        t_idx = np.clip(np.asarray(t_idx, np.int64), 0, self.n_steps - 1)
        latency_ms = np.asarray(latency_ms)
        if self.template_map is not None:
            for s, t, ms in zip(server_idx, t_idx, latency_ms):
                self.record_observation(int(s), int(t), float(ms))
            return
        if self.chaos is not None:
            keep = ~self.chaos.stale[server_idx, t_idx]
            server_idx, t_idx = server_idx[keep], t_idx[keep]
            latency_ms = latency_ms[keep]
        self.obs_version += 1
        self.observed[server_idx, t_idx] = latency_ms

    # -- execution --------------------------------------------------------------
    def call_tool(self, decision: Decision, query: Query, t_idx: int) -> ToolResult:
        """Execute the selected tool at simulated time t_idx."""
        if self.servers is None:
            raise ValueError(
                "call_tool needs materialized Server objects; a tiled "
                "mega-fleet platform (servers=None) is routing/monitoring-only"
            )
        lat = self.latency_at(decision.server_idx, t_idx)
        online = lat < L.OFFLINE_MS
        server = self.servers[decision.server_idx]

        if self.mode == "live" and self.live_transport is not None:
            answer, lat_live = self.live_transport(server, decision, query)
            lat = float(lat_live)
            online = lat < L.OFFLINE_MS
            success = online and answer == query.answer
        else:
            # sim mode: the right tool domain on an online server completes
            # the task (paper: "a simulated task success expectation")
            success = online and (server.domain == query.intent)
            answer = query.answer if success else ""

        # feed-forward: record the actual execution latency
        self.record_observation(decision.server_idx, t_idx, lat)
        return ToolResult(latency_ms=lat, online=online, success=success, answer=answer)
