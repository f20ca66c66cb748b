"""Network-aware inference gateway, twin of `repro.serving.gateway`.

A fleet of model-serving replicas stands in for the paper's MCP server
pool: each replica advertises a capability description (its arch + task
competences) and live latency telemetry.  The gateway routes every request
with SONAR: two-stage BM25 capability match (Eq. 1-5) fused with the QoS
score of each replica's telemetry (Eq. 7-8).  Feed-forward recording
closes the loop (Sec. III-B).

At fleet scale the hot loop is `route_batch` over the batched routing
engine: on the card, the BM25 kernel, the QoS kernel over the telemetry
window and the fused stage-2 kernel (`core.batch_routing`).  With
``shards=N`` it routes through the sharded engine (`core.mesh_routing`,
whose merge runs the fused selection kernel) and keeps the telemetry
window on the device in a ring buffer (`DeviceTelemetry`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adaptive as _adaptive
from repro_torch.core import latency as latlib
from repro_torch.core import routing
from repro_torch.core.batch_routing import BatchRoutingEngine
from repro_torch.core.dataset import Server, Tool
from repro_torch.core.mesh_routing import ShardedRoutingEngine
from repro_torch.core.qos import load_penalty, rtt_penalty
from repro_torch.core.routing import ALGORITHMS, RoutingConfig, SonarRouter  # noqa: F401
from repro_torch.obs import Observability
from repro_torch.sessions.warmth import WarmthTracker

ARCH_CAPABILITIES = {
    "dense": "general purpose text generation chat completion dense transformer",
    "moe": "mixture of experts text generation high throughput sparse compute",
    "hybrid": "long context document summarization state space hybrid generation",
    "ssm": "streaming long context low latency recurrent state generation",
    "audio": "speech transcription audio translation whisper encoder decoder",
    "vlm": "image understanding visual question answering multimodal vision language",
}


def replica_pool(
    archs: Sequence[tuple],          # [(arch_id, family)], one per replica
) -> list:
    servers = []
    for i, (arch_id, family) in enumerate(archs):
        cap = ARCH_CAPABILITIES[family]
        servers.append(
            Server(
                name=f"{arch_id}-replica-{i}",
                domain=family,
                description=f"{arch_id} serving replica: {cap}",
                tools=[Tool("generate", f"generate text with {arch_id}: {cap}")],
            )
        )
    return servers


@dataclasses.dataclass
class RouteResult:
    replica_idx: int
    latency_ms: float
    ok: bool
    expertise: float
    network: float


def _telemetry_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32


class _HostTelemetry:
    """Host telemetry window [n_replicas, history]: roll + assign per tick.

    ``dtype="bfloat16"`` rounds each sample to bf16 (round to nearest even)
    once as it enters the window and keeps the rounded value, held exactly
    in float32: every consumer sees the floats the reference's bf16 window
    upcasts to.
    """

    def __init__(self, init: np.ndarray, dtype: str = "float32"):
        self._bf16 = _telemetry_dtype(dtype) == torch.bfloat16
        self._win = self._round(np.array(init, np.float32))

    def _round(self, x: np.ndarray) -> np.ndarray:
        if not self._bf16:
            return x
        return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()

    def push(self, col: np.ndarray) -> None:
        self._win = np.roll(self._win, -1, axis=1)
        self._win[:, -1] = self._round(np.asarray(col, np.float32))

    def raw(self) -> np.ndarray:
        return self._win

    def host(self) -> np.ndarray:
        return self._win


class DeviceTelemetry:
    """Device-resident telemetry window [n_replicas, history], advanced in
    place per tick.

    The buffer is a ring: a push writes one column, at the slot of the
    oldest sample, and moves the head; nothing is shifted.  `raw()` hands
    the engines the window oldest-first (the QoS EWMA weighs samples by
    position), a contiguous copy made once per push at most and only when
    asked for.  bf16 storage rounds each sample once as it enters the ring.
    The host view (for scalar `Router.select` calls) is copied lazily and
    cached until the next push.
    """

    def __init__(self, init: np.ndarray, dtype: str = "float32", device=None):
        self.device = resolve_device(device)
        self.dtype = _telemetry_dtype(dtype)
        init = torch.from_numpy(np.array(init, np.float32))
        self._buf = init.to(device=self.device).to(self.dtype).contiguous()
        self._head = 0                  # column of the oldest sample
        self._window: Optional[torch.Tensor] = None
        self._host: Optional[np.ndarray] = None

    def push(self, col: np.ndarray) -> None:
        c = torch.from_numpy(np.asarray(col, np.float32)).to(self.device)
        self._buf[:, self._head] = c.to(self.dtype)
        self._head = (self._head + 1) % self._buf.shape[1]
        self._window = None
        self._host = None

    def raw(self) -> torch.Tensor:
        if self._window is None:
            h = self._head
            self._window = self._buf if h == 0 else torch.cat(
                (self._buf[:, h:], self._buf[:, :h]), dim=1)
        return self._window

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = self.raw().to(torch.float32).cpu().numpy()
        return self._host


class SonarGateway:
    """Routes requests across serving replicas with SONAR.

    Parameters mirror `repro.serving.gateway.SonarGateway`: ``replicas``
    (the routing corpus), ``profiles`` (per-replica network profiles,
    default all ideal), ``cfg``, ``seed`` (trace synthesis and the probe
    re-admission draws), ``history`` (telemetry window length),
    ``executor`` (``(replica_idx, text) -> latency_ms``; default replays the
    traces), ``use_kernels`` (`route_batch` through the batched engine;
    False routes each request through the scalar router), ``algo`` (any
    network-aware algorithm), ``slots_per_replica`` (capacity behind the
    load term), ``lb_chunk`` (chunk size of load-aware batched routing),
    ``eject_after`` / ``probe_prob`` (SONAR-FT health tracking), ``shards``
    (route batches through the sharded engine and keep the telemetry on the
    device), ``mesh`` (passed to the sharded engine), ``region_rtt_ms`` (f32
    [n_regions, n_replicas]), ``device_telemetry`` (the device ring even
    without ``shards``), ``telemetry_dtype`` ("float32" or "bfloat16"),
    ``obs`` (the `Observability` bundle whose registry `report()` reads)
    and ``session_half_life``.  ``device`` is where the traces are
    synthesized and the engines and the device ring live (None: the card).
    """

    def __init__(
        self,
        replicas: Sequence[Server],
        profiles: Optional[list] = None,
        cfg: RoutingConfig = RoutingConfig(top_s=8, top_k=8),
        seed: int = 0,
        history: int = 64,
        executor: Optional[Callable] = None,   # (replica_idx, request) -> latency_ms
        use_kernels: bool = False,
        algo: str = "sonar",
        slots_per_replica: int = 4,
        lb_chunk: int = 8,
        eject_after: int = 3,
        probe_prob: float = 0.15,
        shards: Optional[int] = None,
        mesh="auto",
        region_rtt_ms: Optional[np.ndarray] = None,
        device_telemetry: Optional[bool] = None,
        telemetry_dtype: str = "float32",
        obs: Optional[Observability] = None,
        session_half_life: float = 256.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.replicas = list(replicas)
        self.algo = algo.lower().replace("-", "_")
        self.router = routing.make_router(self.algo, self.replicas, cfg)
        if not self.router.uses_network:
            raise ValueError("the gateway routes on telemetry: pick a network-aware algorithm")
        self.history = history
        self.executor = executor
        self.use_kernels = use_kernels
        self.lb_chunk = lb_chunk
        self.shards = shards
        self._mesh_opt = mesh
        self.region_rtt_ms = (
            None if region_rtt_ms is None else np.asarray(region_rtt_ms, np.float32)
        )
        self._engine = None
        n = len(self.replicas)
        # in-flight accounting: callers running concurrent traffic use
        # begin()/finish() so the utilization the load term sees tracks
        # outstanding work; route()/route_batch() keep their own counts.
        self.in_flight = np.zeros(n, np.float32)
        self.capacity = float(max(slots_per_replica, 1))
        # health tracking (SONAR-FT): `eject_after` consecutive failures
        # eject a replica (masked out of routing); each later request
        # re-admits it as a candidate with probability `probe_prob`, and one
        # success readmits it.  Only failover-aware algorithms read the mask.
        self.eject_after = int(eject_after)
        self.probe_prob = float(probe_prob)
        self.fail_streak = np.zeros(n, np.int64)
        self.ejected = np.zeros(n, bool)
        self._probe_rng = np.random.default_rng(seed ^ 0x5EED)
        if profiles is None:
            profiles = [latlib.ideal_profile() for _ in range(n)]
        packed = latlib.pack_profiles(profiles)
        steps = latlib.trace_horizon_steps()
        self.traces = latlib.generate_traces_cached(seed, packed, steps, device=self.device)
        init = self.traces[:, :history]
        if device_telemetry is None:
            device_telemetry = bool(shards)
        self.telemetry_dtype = telemetry_dtype
        self._telemetry = (
            DeviceTelemetry(init, dtype=telemetry_dtype, device=self.device)
            if device_telemetry
            else _HostTelemetry(init, dtype=telemetry_dtype)
        )
        self.t = history
        self.stats: list = []
        # observability: all gateway accounting lives in the registry
        # (report() reads it back, one source of truth shared with the
        # layers bound to the same bundle)
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._m_requests = reg.counter("gateway_requests_total", "req")
        self._m_failures = reg.counter("gateway_failures_total", "req")
        self._m_ejections = reg.counter("gateway_ejections_total", "events")
        self._m_readmissions = reg.counter("gateway_readmissions_total", "events")
        self._m_latency = reg.histogram("gateway_latency_ms", "ms")
        self._m_in_flight = reg.gauge("gateway_in_flight", "req")
        self._m_unmatched = reg.counter("gateway_unmatched_finish_total", "req")
        self._m_ejected = reg.gauge("gateway_ejected", "replicas")
        self._m_phase = {
            ph: reg.histogram(f"gateway_phase_{ph}_ms", "ms")
            for ph in ("encode", "dispatch", "merge")
        }
        self._route_stats = self.obs.ensure_route_stats(n)
        # per-flush phase durations (wall ms), for span emission by the
        # serving drivers: [("encode", ms), ("dispatch", ms), ("merge", ms)]
        self.last_flush_phases: list = []
        # SONAR-ADAPT: the scalar router (route/begin+finish) and the batched
        # engine (route_batch) each hold learner state; the gauges publish
        # whichever one last moved.
        self.adaptive = hasattr(self.router, "observe_outcome")
        self._m_adapt_w = None
        self._m_adapt_baseline = None
        self._m_adapt_steps = None
        if self.adaptive:
            self._m_adapt_w = {
                name: reg.gauge(f"adapt_weight_{name}", "w")
                for name in ("alpha", "beta", "gamma", "delta")
            }
            self._m_adapt_baseline = reg.gauge("adapt_baseline", "reward")
            self._m_adapt_steps = reg.gauge("adapt_steps", "updates")
            self._publish_adapt(self.router.state)
        # begin()/finish() credit assignment: winner features stashed at
        # begin, popped (FIFO per replica) at finish; `abandon` expires the
        # head entry when a dispatch is shed before finishing
        self._pending_feats: dict = {}
        # SONAR-SESSION sticky affinity on the gateway's tick clock (one
        # tick per recorded completion); only affinity-aware routers read it
        self.session_warmth = WarmthTracker(n, half_life_ms=float(session_half_life))

    @property
    def telemetry(self) -> np.ndarray:
        """Host view of the telemetry window [n_replicas, history] ms (the
        scalar routing paths consume this)."""
        return self._telemetry.host()

    def _observe(self, idx: int, latency_ms: float):
        col = np.array(self.traces[:, min(self.t, self.traces.shape[1] - 1)], np.float32)
        col[idx] = latency_ms
        self._telemetry.push(col)
        self.t += 1

    def _utilization(self) -> np.ndarray:
        return self.in_flight / self.capacity

    def _rtt_row(self, client_region: Optional[int]) -> Optional[np.ndarray]:
        """[n_replicas] RTT row for one client region (None without an RTT
        matrix, for a locality-blind algorithm or an untagged request)."""
        if (
            self.region_rtt_ms is None
            or not getattr(self.router, "uses_rtt", False)
            or client_region is None
            or client_region < 0
        ):
            return None
        return self.region_rtt_ms[int(client_region)]

    def _session_affinity(self, session_id: Optional[int]) -> Optional[np.ndarray]:
        """[n_replicas] warmth row for one session (None when session-less,
        affinity-blind or fully cooled: None keeps the exact zero-affinity
        scoring path)."""
        if session_id is None or not getattr(self.router, "uses_affinity", False):
            return None
        return self.session_warmth.warmth(int(session_id), float(self.t))

    def _session_touch(self, session_id: Optional[int], idx: int, ok: bool) -> None:
        """A successful completion for ``session_id`` landed on replica
        ``idx``: mark the replica warm."""
        if ok and session_id is not None:
            self.session_warmth.touch(int(session_id), idx, float(self.t))

    # -- SONAR-ADAPT: weight-trajectory observability -----------------------
    def adapt_state(self):
        """The batched engine's live SONAR-ADAPT state (tensors on its
        device), or None before the engine is built or without a learner."""
        eng = self._engine
        return None if eng is None or eng.learner is None else eng.learner.state

    def _publish_adapt(self, state) -> None:
        """Mirror a live AdaptState into gauges and a trace instant."""
        if self._m_adapt_w is None or state is None:
            return
        w = state.weights.detach().cpu().numpy().astype(np.float32)
        for i, name in enumerate(("alpha", "beta", "gamma", "delta")):
            self._m_adapt_w[name].set(float(w[i]))
        self._m_adapt_baseline.set(float(state.baseline))
        self._m_adapt_steps.set(float(state.step))
        self.obs.tracer.instant(
            "adapt_weights", cat="adapt",
            args={
                "alpha": float(w[0]), "beta": float(w[1]),
                "gamma": float(w[2]), "delta": float(w[3]),
                "baseline": float(state.baseline),
                "step": int(state.step),
            },
        )

    def _batch_feats(
        self, idx: int, expertise: float, network: float, client_region: Optional[int],
    ) -> np.ndarray:
        """[C, N, -U, -R] at a batched pick, rebuilt from the decision and
        the load/RTT terms at dispatch time."""
        cfg = self.router.cfg
        u = 0.0
        if getattr(self.router, "uses_load", False) and cfg.gamma != 0.0:
            u = float(load_penalty(
                torch.tensor(self._utilization()[idx]), cfg.load_knee, cfg.load_sharp))
        r = 0.0
        rtt_row = self._rtt_row(client_region)
        if rtt_row is not None and cfg.delta != 0.0:
            r = float(rtt_penalty(torch.tensor(rtt_row[idx]), cfg.rtt_scale_ms))
        return _adaptive.decision_feats(expertise, network, u, r)

    # -- health tracking (SONAR-FT ejection + probe re-admission) -----------
    def _health_mask(self, n_requests: Optional[int] = None) -> Optional[np.ndarray]:
        """failed-mask for the next decision: ejected replicas are excluded
        unless the request probes them.  The probe is drawn per *request*
        ([n_replicas] for a scalar call, [n_requests, n_replicas] for
        `route_batch`).  Never masks the whole fleet for a request."""
        if not self.router.uses_failover or not self.ejected.any():
            return None
        rows = 1 if n_requests is None else n_requests
        probe = self._probe_rng.random((rows, len(self.ejected))) < self.probe_prob
        mask = self.ejected[None, :] & ~probe
        mask[mask.all(axis=1)] = False
        if not mask.any():
            return None
        return mask[0] if n_requests is None else mask

    def _record_outcome(self, idx: int, ok: bool) -> None:
        was_ejected = bool(self.ejected[idx])
        if ok:
            self.fail_streak[idx] = 0
            self.ejected[idx] = False           # probe succeeded: readmit
            if was_ejected:
                self._m_readmissions.inc()
                self._m_ejected.dec()
                self.obs.tracer.instant("readmit", cat="health", args={"replica": idx})
        else:
            self._m_failures.inc()
            self.fail_streak[idx] += 1
            if self.fail_streak[idx] >= self.eject_after:
                self.ejected[idx] = True
                if not was_ejected:
                    self._m_ejections.inc()
                    self._m_ejected.inc()
                    self.obs.tracer.instant("eject", cat="health", args={"replica": idx})

    def _account(self, res: RouteResult) -> RouteResult:
        """Single completion-accounting path (route / finish / route_batch)."""
        self.stats.append(res)
        self._m_requests.inc()
        self._m_latency.observe(res.latency_ms)
        return res

    # -- concurrent dispatch accounting (SONAR-LB) --------------------------
    def begin(
        self, request_text: str, client_region: Optional[int] = None,
        session_id: Optional[int] = None,
    ) -> RouteResult:
        """Route and dispatch without completing: the pick counts in flight
        until `finish`."""
        aff = self._session_affinity(session_id)
        with self.obs.tracer.span("begin", cat="gateway"):
            decision = self.router.select(
                request_text, self.telemetry, self._utilization(),
                failed_mask=self._health_mask(),
                client_rtt_ms=self._rtt_row(client_region),
                affinity=aff,
                audit=self.obs.audit_tap,
            )
        idx = decision.server_idx
        self.in_flight[idx] += 1.0
        self._m_in_flight.inc()
        if self.adaptive:
            # FIFO per replica: `finish` is keyed by replica index only
            self._pending_feats.setdefault(idx, []).append(
                getattr(self.router, "last_feats", None))
        return RouteResult(
            replica_idx=idx, latency_ms=0.0, ok=True,
            expertise=decision.expertise, network=decision.network,
        )

    def finish(
        self, replica_idx: int, latency_ms: float, session_id: Optional[int] = None,
    ) -> Optional[RouteResult]:
        """Complete a begun dispatch: record telemetry, release the slot.
        A finish with nothing outstanding on the replica is rejected,
        counted in ``gateway_unmatched_finish_total``, and returns None."""
        if self.in_flight[replica_idx] <= 0.0:
            self._m_unmatched.inc()
            self.obs.tracer.instant(
                "unmatched_finish", cat="gateway", args={"replica": int(replica_idx)})
            return None
        with self.obs.tracer.span("finish", cat="gateway"):
            self.in_flight[replica_idx] -= 1.0
            self._m_in_flight.dec()
            ok = latency_ms < latlib.OFFLINE_MS
            self._record_outcome(replica_idx, ok)
            self._observe(replica_idx, latency_ms)
            self._session_touch(session_id, replica_idx, ok)
            if self.adaptive:
                fifo = self._pending_feats.get(replica_idx)
                feats = fifo.pop(0) if fifo else None
                self.router.observe_outcome(latency_ms, ok=ok, feats=feats)
                self._publish_adapt(self.router.state)
            return self._account(RouteResult(
                replica_idx=replica_idx, latency_ms=latency_ms, ok=ok,
                expertise=0.0, network=0.0,
            ))

    def abandon(self, replica_idx: int) -> bool:
        """Release a begun dispatch that will never finish; expires the
        oldest pending feature stash of the replica.  False (and an
        unmatched finish counted) when nothing is outstanding."""
        if self.in_flight[replica_idx] <= 0.0:
            self._m_unmatched.inc()
            return False
        self.in_flight[replica_idx] -= 1.0
        self._m_in_flight.dec()
        if self.adaptive:
            fifo = self._pending_feats.get(replica_idx)
            if fifo:
                fifo.pop(0)
        return True

    def route(
        self, request_text: str, client_region: Optional[int] = None,
        session_id: Optional[int] = None,
    ) -> RouteResult:
        aff = self._session_affinity(session_id)
        with self.obs.tracer.span("route", cat="gateway"):
            decision = self.router.select(
                request_text, self.telemetry, self._utilization(),
                failed_mask=self._health_mask(),
                client_rtt_ms=self._rtt_row(client_region),
                affinity=aff,
                audit=self.obs.audit_tap,
            )
        idx = decision.server_idx
        if self.executor is not None:
            latency = float(self.executor(idx, request_text))
        else:
            latency = float(self.traces[idx, min(self.t, self.traces.shape[1] - 1)])
        ok = latency < latlib.OFFLINE_MS
        self._record_outcome(idx, ok)
        self._observe(idx, latency)
        self._session_touch(session_id, idx, ok)
        if self.adaptive:
            # synchronous path: the router's `last_feats` is this decision's
            self.router.observe_outcome(latency, ok=ok)
            self._publish_adapt(self.router.state)
        return self._account(RouteResult(
            replica_idx=idx, latency_ms=latency, ok=ok,
            expertise=decision.expertise, network=decision.network,
        ))

    def engine(self):
        """The batched engine over this fleet (built once, lazily), sharing
        the scalar router's ToolIndex; the sharded engine with ``shards``."""
        if self._engine is None:
            if self.shards:
                self._engine = ShardedRoutingEngine(
                    self.replicas, self.router.cfg, algo=self.algo,
                    n_shards=self.shards, mesh=self._mesh_opt,
                    index=self.router.index, device=self.device,
                )
            else:
                self._engine = BatchRoutingEngine(
                    self.replicas, self.router.cfg, algo=self.algo,
                    index=self.router.index, device=self.device,
                )
        return self._engine

    def route_batch(
        self,
        request_texts: Sequence[str],
        client_regions: Optional[Sequence[int]] = None,
        pad_to: Optional[int] = None,
        session_ids: Optional[Sequence] = None,
    ) -> list:
        """Fleet-scale batched routing: the request batch runs through the
        engine against one telemetry snapshot; executions are then recorded
        in arrival order (feed-forward).  ``client_regions`` tags each
        request's origin for locality-aware algorithms.

        The whole request set is encoded in one host pass.  With a
        load-aware algorithm the batch routes in `lb_chunk`-sized chunks,
        each chunk's picks counted in flight before the next routes (not
        for a single-replica pool).  ``pad_to`` pads each engine call with
        all-zero query rows to ``pad_to`` rows (``lb_chunk`` on the chunked
        path), so every call of a micro-batch server has one shape.  Padded
        rows draw no health probes, carry no region tag, and their
        decisions are dropped before any accounting; the real rows'
        decisions are those of the unpadded call."""
        if not request_texts:
            return []
        if not self.use_kernels:
            return [
                self.route(
                    t,
                    None if client_regions is None else client_regions[i],
                    None if session_ids is None else session_ids[i],
                )
                for i, t in enumerate(request_texts)
            ]
        eng = self.engine()
        use_geo = (
            client_regions is not None
            and self.region_rtt_ms is not None
            and getattr(self.router, "uses_rtt", False)
        )
        regions_arr = np.asarray(client_regions, np.int32) if use_geo else None
        use_aff = session_ids is not None and getattr(self.router, "uses_affinity", False)
        t_phase = time.perf_counter()
        enc = eng.encode(request_texts)
        encode_ms = 1000.0 * (time.perf_counter() - t_phase)
        dispatch_ms = 0.0
        picks: list = []
        chunked = self.router.uses_load and len(self.replicas) > 1
        step = self.lb_chunk if chunked else (pad_to or len(request_texts))
        step = max(step, 1)
        adapting = eng.learner is not None
        for lo in range(0, len(request_texts), step):
            n_chunk = min(step, len(request_texts) - lo)
            sub = enc.slice(lo, lo + n_chunk)
            mask = self._health_mask(n_chunk)
            reg = regions_arr[lo : lo + n_chunk] if use_geo else None
            if pad_to is not None and sub.n < step:
                sub = sub.pad_to(step)
                if mask is not None:
                    mask = np.concatenate(
                        [mask, np.zeros((step - n_chunk, mask.shape[1]), bool)], axis=0)
                if reg is not None:
                    reg = np.concatenate([reg, np.full(step - n_chunk, -1, np.int32)])
            geo_kw = {}
            if use_geo:
                geo_kw = dict(client_region=reg, region_rtt_ms=self.region_rtt_ms)
            aff = None
            if use_aff:
                # per-request warmth rows [sub.n, n_replicas]: cold,
                # session-less and padded rows stay zero; an all-zero matrix
                # is dropped so affinity-free chunks keep the exact scoring
                aff = np.zeros((sub.n, len(self.replicas)), np.float32)
                warm_any = False
                for qi in range(n_chunk):
                    row = self._session_affinity(session_ids[lo + qi])
                    if row is not None:
                        aff[qi] = row
                        warm_any = True
                if not warm_any:
                    aff = None
            t_phase = time.perf_counter()
            dec = eng.route(
                sub, self._telemetry.raw(), self._utilization(),
                failed_mask=mask,
                affinity=aff,
                route_stats=self._route_stats,
                n_real=n_chunk if sub.n != n_chunk else None,
                **geo_kw,
            )
            dispatch_ms += 1000.0 * (time.perf_counter() - t_phase)
            for qi in range(n_chunk):
                idx = int(dec.server_idx[qi])
                expertise = float(dec.expertise[qi])
                network = float(dec.network[qi])
                feats = None
                if adapting:
                    feats = self._batch_feats(
                        idx, expertise, network, None if reg is None else int(reg[qi]))
                self.in_flight[idx] += 1.0
                self._m_in_flight.inc()
                sid = None if session_ids is None else session_ids[lo + qi]
                picks.append((idx, expertise, network, feats, sid))
        t_phase = time.perf_counter()
        out = []
        for idx, expertise, network, feats, sid in picks:
            latency = float(self.traces[idx, min(self.t, self.traces.shape[1] - 1)])
            ok = latency < latlib.OFFLINE_MS
            self._record_outcome(idx, ok)
            self._observe(idx, latency)
            self._session_touch(sid, idx, ok)
            if feats is not None:
                eng.observe_feedback(latency, ok=ok, feats=feats)
            self.in_flight[idx] = max(self.in_flight[idx] - 1.0, 0.0)
            self._m_in_flight.dec()
            out.append(self._account(RouteResult(
                replica_idx=idx, latency_ms=latency, ok=ok,
                expertise=expertise, network=network,
            )))
        if adapting:
            self._publish_adapt(eng.learner.state)
        merge_ms = 1000.0 * (time.perf_counter() - t_phase)
        self.last_flush_phases = [
            ("encode", encode_ms), ("dispatch", dispatch_ms), ("merge", merge_ms),
        ]
        self._m_phase["encode"].observe(encode_ms)
        self._m_phase["dispatch"].observe(dispatch_ms)
        self._m_phase["merge"].observe(merge_ms)
        return out

    def report(self) -> dict:
        """Gateway summary, read from the metrics registry.  ``p99_ms`` is
        the log-bucket histogram quantile; count, mean and failure rate
        are exact."""
        reg = self.obs.registry
        n = int(self._m_latency.count)
        return {
            "n": n,
            "al_ms": self._m_latency.mean,
            "p99_ms": self._m_latency.p99,
            "failure_rate": self._m_failures.value / n if n else 0.0,
            "in_flight": self._m_in_flight.value,
            "unmatched_finish": self._m_unmatched.value,
            "ejected": self._m_ejected.value,
            "ejections": self._m_ejections.value,
            "readmissions": self._m_readmissions.value,
            "shed": reg.value("serving_shed_total"),
            "expired": reg.value("serving_expired_total"),
        }
