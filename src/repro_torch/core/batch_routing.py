"""Batched SONAR routing engine in PyTorch, twin of `repro.core.batch_routing`.

The scalar `Router.select` routes one query at a time through numpy
argsorts; this module runs the whole decision for a *batch* of queries as
tensor code on one device (paper Sec. IV, Eq. 1-9):

  1. stage-1 server scoring + top-s         (Eq. 1-2, BM25 product + top-s)
  2. stage-1 candidate mask over tools      (Eq. 3 mask)
  3. QoS score N per server                 (Eq. 6-7)
  4. stage-2 tool scoring, candidate top-k, softmax expertise, fusion and
     argmax                                 (Eq. 3-5, 8-9)

With ``use_kernels`` (the default on the card) steps 1, 3 and 4 run as the
port's three hand-written CUDA kernels (`kernels/ops`): BM25 scoring, QoS
scoring, and one fused stage-2 pass in which the [n_q, n_tools] score
matrix never exists in device memory.  Without it the unfused PyTorch
pipeline (`kernels/ref.fused_select_ref` on materialised matrices) runs:
the oracle the kernel path is held to.  PyTorch runs eagerly; there is no
compiled pipeline.

Selection parity: for identical inputs the engine is argmax-identical to
`Router.select` and to the reference engine for RAG / RerankRAG / PRAG /
SONAR / SONAR-LB / SONAR-FT / SONAR-GEO / SONAR-SESSION / SONAR-ADAPT: every top-s and
top-k is a stable sort (ties toward the lower index), invalid candidates
are excluded from the softmax mass and the argmax, and the argmax breaks
ties toward the higher-ranked candidate.

Telemetry can be shared ([n_servers, T], one snapshot for the batch) or
per-query ([n_q, n_servers, T], each query at its own simulated time).

SONAR-ADAPT (`core.adaptive`) learns the fusion weights online: outcomes
recorded by `observe_feedback` are folded into the [4] weight tensor by
EG steps (one per 64-outcome bucket) that run as tensor ops on the
engine's device just before the route (no host sync), and the route
fuses with those live weights.
With ``lr == 0`` the static program runs, byte-identical to the
hand-tuned variant whose operands are given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adaptive as _adaptive
from repro_torch.core import routing
from repro_torch.core.bm25 import bm25_scores, topk
from repro_torch.core.dataset import Server
from repro_torch.core.qos import (
    QosParams,
    load_penalty,
    network_score,
    rtt_penalty,
    staleness_discount,
)
from repro_torch.core.routing import (  # noqa: F401  (ALGORITHMS: the reference's re-export)
    ALGORITHMS,
    BM25_STAGE_MS,
    LLM_CALL_MS,
    LLM_RERANK_MS,
    RoutingConfig,
    ToolIndex,
    predict_tool_type,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.score_fuse import ToolCsr, tool_csr

NEG = kref.NEG


@dataclasses.dataclass
class EncodedBatch:
    """Host-encoded query batch (built once, routed many times)."""

    q_server: np.ndarray          # [n_q, V_server] term counts
    q_tool: np.ndarray            # [n_q, V_tool]
    q_rerank: Optional[np.ndarray]  # [n_q, V_tool] canonical intents (rerank)
    n: int

    def slice(self, lo: int, hi: int) -> "EncodedBatch":
        """Rows [lo, hi) as a new batch.  Encoding is strictly per row, so
        slicing a whole-set encoding equals encoding the chunk's texts."""
        hi = min(hi, self.n)
        return EncodedBatch(
            q_server=self.q_server[lo:hi],
            q_tool=self.q_tool[lo:hi],
            q_rerank=None if self.q_rerank is None else self.q_rerank[lo:hi],
            n=max(hi - lo, 0),
        )

    def pad_to(self, n_rows: int) -> "EncodedBatch":
        """Pad with all-zero query rows up to ``n_rows`` (no-op when already
        that long).  Zero rows carry no query terms and the caller discards
        their decisions; real rows are untouched (the pipeline is row-wise)."""
        pad = n_rows - self.n
        if pad <= 0:
            return self

        def z(m):
            return np.concatenate([m, np.zeros((pad, m.shape[1]), m.dtype)], axis=0)

        return EncodedBatch(
            q_server=z(self.q_server),
            q_tool=z(self.q_tool),
            q_rerank=None if self.q_rerank is None else z(self.q_rerank),
            n=n_rows,
        )


@dataclasses.dataclass
class BatchDecisions:
    """Struct-of-arrays routing decisions for one batch (host numpy)."""

    server_idx: np.ndarray        # [n_q] i32
    tool_idx: np.ndarray          # [n_q] i32
    expertise: np.ndarray         # [n_q] f32 — C(i*) (Eq. 5)
    network: np.ndarray           # [n_q] f32 — N(i*) (Eq. 7)
    fused: np.ndarray             # [n_q] f32 — S(i*) (Eq. 8)
    select_latency_ms: float      # per-query SL (same accounting as scalar)

    def __len__(self) -> int:
        return len(self.server_idx)


def check_n_real(batch: EncodedBatch, n_real) -> None:
    """``n_real``, the count of real rows ahead of the all-zero padding rows
    of a padded call (the device route statistics leave the padding out),
    must lie in [0, batch.n]."""
    if n_real is not None and not 0 <= int(n_real) <= batch.n:
        raise ValueError(f"n_real={n_real} outside [0, {batch.n}]")


def encode_for_index(
    index, uses_prediction: bool, rerank: bool, queries: Sequence[str]
) -> EncodedBatch:
    """Encode query strings against an index's corpora: the only per-query
    Python of the batched path.  ``uses_prediction`` applies the
    deterministic preprocess stand-in (PRAG/SONAR family); ``rerank`` also
    encodes the canonical-intent rerank queries (RerankRAG)."""
    if uses_prediction:
        qtexts = [predict_tool_type(q)[1] for q in queries]
    else:
        qtexts = list(queries)
    if not qtexts:
        v_s = len(index.server_corpus.vocab)
        v_t = len(index.tool_corpus.vocab)

        def empty(v):
            return np.zeros((0, v), np.float32)

        return EncodedBatch(
            q_server=empty(v_s), q_tool=empty(v_t),
            q_rerank=empty(v_t) if rerank else None, n=0,
        )
    q_server = index.server_corpus.encode_queries(qtexts)
    q_tool = index.tool_corpus.encode_queries(qtexts)
    q_rerank = None
    if rerank:
        q_rerank = index.tool_corpus.encode_queries(
            [predict_tool_type(q)[1] for q in queries]
        )
    return EncodedBatch(
        q_server=q_server, q_tool=q_tool, q_rerank=q_rerank, n=len(queries)
    )


def _per_tool(per_server: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-server row ([n_servers] or [n_q, n_servers]) to the
    tools of each server."""
    return per_server[:, ts] if per_server.ndim == 2 else per_server[ts]


def _route_pipeline(
    q_server: torch.Tensor,          # [n_q, V_s]
    q_tool: torch.Tensor,            # [n_q, V_t]
    q_rerank: Optional[torch.Tensor],
    w_server_t: torch.Tensor,        # [V_s, n_servers]: the server weights, transposed
    w_tool: torch.Tensor,            # [n_tools, V_t]
    tool_server: torch.Tensor,       # [n_tools] i32
    tool_server_l: torch.Tensor,     # the same, i64 (the gathers' index)
    tool_csr: Optional[ToolCsr],     # server -> tools map of tool_server (kernel path)
    latency_hist: Optional[torch.Tensor],  # [n_servers, T] or [n_q, n_servers, T]
    server_load: Optional[torch.Tensor],   # [n_servers] or [n_q, n_servers] rho
    telemetry_age: Optional[torch.Tensor],  # [n_servers] or [n_q, n_servers] s
    dead_mask: Optional[torch.Tensor],      # [n_servers] or [n_q, n_servers] 0/1
    client_rtt: Optional[torch.Tensor],     # [n_servers] or [n_q, n_servers] ms
    region_idx: Optional[torch.Tensor],     # [n_q] i32 client region per request
    region_rtt: Optional[torch.Tensor],     # [n_regions, n_servers] ms
    affinity: Optional[torch.Tensor] = None,  # [n_servers] or [n_q, n_servers] W
    adapt_w: Optional[torch.Tensor] = None,   # [4] f32 live [alpha, beta, gamma,
                                              # delta] (SONAR-ADAPT); None: static
    *,
    top_s: int,
    top_k: int,
    alpha: float,
    beta: float,
    gamma: float,
    load_knee: float,
    load_sharp: float,
    delta: float,
    rtt_scale: float,
    temp: float,
    stale_half_life: float,
    use_network: bool,
    use_load: bool,
    use_staleness: bool,
    use_failover: bool,
    use_rtt: bool,
    use_aff: bool = False,
    eps: float = 0.0,
    rerank: bool,
    use_kernels: bool,
    qos_params: QosParams,
):
    n_q = q_server.shape[0]
    n_servers = w_server_t.shape[1]
    n_tools = w_tool.shape[0]
    ts = tool_server_l
    dev = q_server.device

    # -- stage 1: server scores + top-s candidates (Eq. 1-2) --
    if use_kernels:
        s_scores = ops.bm25_scores(q_server, w_server_t)
    else:
        s_scores = bm25_scores(w_server_t.t(), q_server)
    # SONAR-FT: demote known-failed servers below every live one before
    # the top-s (NEG ties re-fill in index order)
    if use_failover and dead_mask is not None:
        dm_server = dead_mask if dead_mask.ndim == 2 else dead_mask[None, :]
        s_scores = torch.where(dm_server > 0.0, NEG, s_scores)
    _, cand_servers = topk(s_scores, min(top_s, n_servers))

    # -- stage 2 (unfused path only): tool scores masked outside candidate
    # servers (Eq. 3-4) plus the rerank re-valuation --
    if not use_kernels:
        member = torch.zeros((n_q, n_servers), dtype=torch.bool, device=dev)
        member.scatter_(1, cand_servers, True)              # [n_q, n_servers]
        sel = torch.where(member[:, ts], bm25_scores(w_tool, q_tool), NEG)
        val = bm25_scores(w_tool, q_rerank) if rerank else sel

    # -- QoS N per tool (Eq. 6-7) --
    if use_network and latency_hist is not None:
        qos_fn = ops.qos_scores if use_kernels else network_score
        if latency_hist.ndim == 3:                          # per-query windows
            flat = latency_hist.reshape(n_q * n_servers, latency_hist.shape[-1])
            n_server = qos_fn(flat, qos_params).reshape(n_q, n_servers)
        else:
            n_server = qos_fn(latency_hist, qos_params)
        # SONAR-FT staleness discount: elementwise per server, commutes
        # with the per-tool broadcast below
        if use_staleness and telemetry_age is not None:
            n_server = n_server * staleness_discount(telemetry_age, stale_half_life)
        tool_qos = _per_tool(n_server, ts)
        # SONAR-ADAPT: the live weights replace the static floats only on
        # the active terms; inactive terms keep their structural literals
        eff_alpha, eff_beta = (alpha, beta) if adapt_w is None else (adapt_w[0], adapt_w[1])
    else:
        tool_qos = torch.zeros((n_tools,), dtype=torch.float32, device=dev)
        eff_alpha, eff_beta = 1.0, 0.0                      # S = C (scalar path)

    # -- SONAR-LB load term --
    if use_load and server_load is not None:
        tool_load = _per_tool(load_penalty(server_load, load_knee, load_sharp), ts)
        eff_gamma = gamma if adapt_w is None else adapt_w[2]
    else:
        tool_load = torch.zeros((n_tools,), dtype=torch.float32, device=dev)
        eff_gamma = 0.0

    # -- SONAR-GEO locality term: an explicit RTT row, or a per-request
    # region index gathered from the [n_regions, n_servers] matrix --
    if use_rtt and (
        client_rtt is not None or (region_idx is not None and region_rtt is not None)
    ):
        if client_rtt is None:
            # untagged requests carry region -1: R(0) = 0, no penalty
            client_rtt = region_rtt[torch.clamp_min(region_idx, 0).long()]
            client_rtt = torch.where((region_idx >= 0)[:, None], client_rtt, 0.0)
        tool_rtt = _per_tool(rtt_penalty(client_rtt, rtt_scale), ts)
        eff_delta = delta if adapt_w is None else adapt_w[3]
    else:
        tool_rtt = torch.zeros((n_tools,), dtype=torch.float32, device=dev)
        eff_delta = 0.0

    # -- SONAR-SESSION warm-affinity bonus and SONAR-FT failed mask --
    tool_aff = _per_tool(affinity, ts) if use_aff and affinity is not None else None
    tool_dead = (
        _per_tool(dead_mask, ts) if use_failover and dead_mask is not None else None
    )

    # -- stage 2 + candidate top-k + Eq. 5 softmax + Eq. 8 fusion + argmax:
    # one fused kernel pass on the kernel path; the unfused oracle otherwise --
    if use_kernels:
        tool_idx, c, n, s = ops.fused_score_select(
            q_tool, w_tool, tool_server, cand_servers,
            tool_qos, tool_load, tool_dead,
            q_rerank if rerank else None,
            k=top_k, alpha=eff_alpha, beta=eff_beta, gamma=eff_gamma,
            tool_rtt=tool_rtt, delta=eff_delta, tool_aff=tool_aff, eps=eps,
            temp=temp, tool_csr=tool_csr,
        )
    else:
        tool_idx, c, n, s = kref.fused_select_ref(
            sel, val, tool_qos, tool_load, tool_dead,
            k=top_k, alpha=eff_alpha, beta=eff_beta, gamma=eff_gamma,
            tool_rtt=tool_rtt, delta=eff_delta, tool_aff=tool_aff, eps=eps,
            temp=temp,
        )
    server_idx = tool_server[tool_idx.long()]
    return server_idx, tool_idx, c, n, s


class BatchRoutingEngine:
    """Vectorized drop-in for a fleet of `Router.select` calls.

    One engine per (server pool, algorithm, config, device); `encode` turns
    query strings into term-count matrices on the host, `route` runs the
    decision for the batch on ``device`` (None: the CUDA card, raising
    when there is none; pass ``"cpu"`` for the plain versions).
    ``use_kernels`` defaults to True on the card.  ``adapt`` (an
    `AdaptConfig`, implied by ``algo="sonar_adapt"``) turns on the
    SONAR-ADAPT learner, whose state lives on ``device``.
    """

    def __init__(
        self,
        servers: Sequence[Server],
        cfg: RoutingConfig = RoutingConfig(),
        algo: str = "sonar",
        use_kernels: Optional[bool] = None,
        index: Optional[ToolIndex] = None,
        adapt: Optional[_adaptive.AdaptConfig] = None,
        device=None,
    ):
        router_cls = routing.algorithm(algo)
        self.device = resolve_device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        self.cfg = cfg
        self.algo = algo.lower().replace("-", "_")
        self.uses_prediction = router_cls.uses_prediction
        self.uses_network = router_cls.uses_network
        self.uses_load = router_cls.uses_load
        self.uses_staleness = router_cls.uses_staleness
        self.uses_failover = router_cls.uses_failover
        self.uses_rtt = router_cls.uses_rtt
        self.uses_affinity = router_cls.uses_affinity
        self.rerank = router_cls.rerank
        self.use_kernels = use_kernels
        self.index = index if index is not None else ToolIndex(servers)
        self._tool_server = self._to(self.index.tool_server, torch.int32)
        self._tool_server_l = self._tool_server.long()
        # the server weights are kept transposed, [V_s, n_servers]: the
        # layout the BM25 kernel reads (a used term is one contiguous row);
        # the plain path reads the [n_servers, V_s] view without a copy
        self._w_server_t = self._to(self.index.server_corpus.weights.T, torch.float32)
        self.n_servers = int(self._w_server_t.shape[1])
        self._w_tool = self._to(self.index.tool_corpus.weights, torch.float32)
        self._tool_csr = tool_csr(self._tool_server, self.n_servers)
        # SONAR-ADAPT learner (None for the hand-tuned algorithms)
        self.learner = _adaptive.FeedbackLearner.for_engine(self.algo, cfg, adapt, self.device)

    def _to(self, x, dtype) -> torch.Tensor:
        """Host array (or tensor) -> this engine's device, cast to ``dtype``
        (float64 numpy inputs become float32 here)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=dtype).contiguous()

    # -- host side ----------------------------------------------------------
    def encode(self, queries: Sequence[str]) -> EncodedBatch:
        """Strings -> term-count matrices (the only per-query Python)."""
        return encode_for_index(
            self.index, self.uses_prediction, self.rerank, queries
        )

    def select_latency_ms(self) -> float:
        """Per-query SL with the same accounting as the scalar router."""
        sl = LLM_CALL_MS + 2 * BM25_STAGE_MS
        if self.rerank:
            sl += LLM_RERANK_MS
        return sl

    # -- SONAR-ADAPT feedback -----------------------------------------------
    @property
    def adapt_weights(self) -> Optional[np.ndarray]:
        """Live [alpha, beta, gamma, delta] (host copy), or None."""
        return None if self.learner is None else self.learner.weights

    def observe_feedback(self, latency_ms: float, ok: bool = True, feats=None) -> None:
        """Record one completed call's outcome; the next `route` folds it
        into the weights."""
        if self.learner is not None:
            self.learner.observe(latency_ms, ok, feats)

    # -- device side --------------------------------------------------------
    def route(
        self,
        batch: EncodedBatch,
        latency_hist=None,
        server_load=None,
        telemetry_age_s=None,
        failed_mask=None,
        client_rtt_ms=None,
        client_region=None,
        region_rtt_ms=None,
        affinity=None,
        route_stats=None,
        n_real=None,
    ) -> BatchDecisions:
        """Route an encoded batch.

        Every telemetry input is *shared* (one snapshot for the batch) or
        *per-query*: ``latency_hist`` f32 [n_servers, T] or [n_q,
        n_servers, T] ms, newest sample last; ``server_load`` utilization,
        ``telemetry_age_s`` seconds, ``failed_mask`` bool (SONAR-FT),
        ``client_rtt_ms`` ms and ``affinity`` warmth in [0, 1], each
        [n_servers] or [n_q, n_servers]; or ``client_region`` i32 [n_q]
        with ``region_rtt_ms`` [n_regions, n_servers] (SONAR-GEO, ignored
        when ``client_rtt_ms`` is given).  Each is read only by the
        algorithms that use it.  numpy arrays or tensors.
        ``route_stats`` (a `repro_torch.obs.DeviceRouteStats`) is handed
        this call's device outputs before they are copied to the host;
        ``n_real`` counts the real rows of a call padded with all-zero query
        rows (`EncodedBatch.pad_to`), which route like any other row and
        which the statistics leave out.

        Returns struct-of-arrays decisions, each [n_q], argmax-identical to
        a scalar `Router.select` loop over the same inputs.  Deterministic.
        SONAR-ADAPT with ``lr != 0`` first applies the pending feedback.
        """
        check_n_real(batch, n_real)
        if batch.n == 0:
            z = np.zeros((0,), np.float32)
            return BatchDecisions(
                server_idx=z.astype(np.int32), tool_idx=z.astype(np.int32),
                expertise=z, network=z, fused=z,
                select_latency_ms=self.select_latency_ms(),
            )
        f32 = torch.float32
        lat = None
        if self.uses_network and latency_hist is not None:
            lat = self._to(latency_hist, f32)
        load = None
        if self.uses_load and server_load is not None and self.cfg.gamma != 0.0:
            load = self._to(server_load, f32)
        age = None
        if self.uses_staleness and telemetry_age_s is not None:
            age = self._to(telemetry_age_s, f32)
        dead = None
        if self.uses_failover and failed_mask is not None:
            dead = self._to(failed_mask, f32)
        rtt = reg_idx = reg_rtt = None
        if self.uses_rtt and self.cfg.delta != 0.0:
            if client_rtt_ms is not None:
                rtt = self._to(client_rtt_ms, f32)
            elif client_region is not None and region_rtt_ms is not None:
                reg_idx = self._to(client_region, torch.int32)
                reg_rtt = self._to(region_rtt_ms, f32)
        aff = None
        if self.uses_affinity and affinity is not None and self.cfg.eps != 0.0:
            aff = self._to(affinity, f32)
        cfg = self.cfg
        adapt_w = None if self.learner is None else self.learner.pending_weights()
        with torch.profiler.record_function("netmcp.route_pipeline"):
            server_idx, tool_idx, c, n, s = _route_pipeline(
                self._to(batch.q_server, f32),
                self._to(batch.q_tool, f32),
                None if batch.q_rerank is None else self._to(batch.q_rerank, f32),
                self._w_server_t, self._w_tool, self._tool_server, self._tool_server_l,
                self._tool_csr if self.use_kernels else None,
                lat, load, age, dead, rtt, reg_idx, reg_rtt, aff, adapt_w,
                top_s=cfg.top_s, top_k=cfg.top_k, alpha=cfg.alpha,
                beta=cfg.beta, gamma=cfg.gamma, load_knee=cfg.load_knee,
                load_sharp=cfg.load_sharp, delta=cfg.delta,
                rtt_scale=cfg.rtt_scale_ms, temp=cfg.expertise_temp,
                stale_half_life=cfg.stale_half_life_s,
                use_network=self.uses_network and lat is not None,
                use_load=load is not None,
                use_staleness=age is not None,
                use_failover=dead is not None,
                use_rtt=rtt is not None or reg_idx is not None,
                use_aff=aff is not None,
                eps=cfg.eps if aff is not None else 0.0,
                rerank=self.rerank,
                use_kernels=self.use_kernels,
                qos_params=cfg.qos,
            )
        if route_stats is not None:
            route_stats.accumulate(server_idx, c, n, s, n_real=n_real)
        return BatchDecisions(
            server_idx=server_idx.cpu().numpy(),
            tool_idx=tool_idx.cpu().numpy(),
            expertise=c.cpu().numpy(),
            network=n.cpu().numpy(),
            fused=s.cpu().numpy(),
            select_latency_ms=self.select_latency_ms(),
        )

    def route_texts(
        self,
        queries: Sequence[str],
        latency_hist=None,
        server_load=None,
        telemetry_age_s=None,
        failed_mask=None,
        client_rtt_ms=None,
        client_region=None,
        region_rtt_ms=None,
        affinity=None,
    ) -> BatchDecisions:
        return self.route(
            self.encode(queries), latency_hist, server_load,
            telemetry_age_s, failed_mask, client_rtt_ms,
            client_region, region_rtt_ms, affinity,
        )

    def route_failover(
        self,
        batch: EncodedBatch,
        latency_hist=None,
        server_load=None,
        telemetry_age_s=None,
        alive: Optional[np.ndarray] = None,      # [n_servers] or [n_q, n_servers] bool
        failed_mask: Optional[np.ndarray] = None,
        budget: Optional[int] = None,
        client_rtt_ms=None,
    ) -> tuple[BatchDecisions, np.ndarray]:
        """Vectorized failover loop: route the batch, probe every pick
        against `alive`, mask the dead picks per query and re-route — at
        most `budget` extra rounds; the batched mirror of
        `Router.select_failover`.  Returns the final decisions and the
        per-query failover counts."""
        budget = self.cfg.failover_budget if budget is None else int(budget)
        n = batch.n
        n_servers = self.n_servers
        mask = np.zeros((n, n_servers), bool)
        if failed_mask is not None:
            mask |= np.asarray(failed_mask, bool)
        up = None if alive is None else np.asarray(alive, bool)
        failovers = np.zeros(n, np.int64)
        dec = self.route(
            batch, latency_hist, server_load, telemetry_age_s,
            mask if mask.any() else None, client_rtt_ms,
        )
        if up is None or n == 0:
            return dec, failovers
        for _ in range(budget):
            picks = np.asarray(dec.server_idx)
            pick_up = up[np.arange(n), picks] if up.ndim == 2 else up[picks]
            todo = ~pick_up & (failovers < budget)
            if not todo.any():
                break
            mask[np.flatnonzero(todo), picks[todo]] = True
            failovers[todo] += 1
            dec = self.route(
                batch, latency_hist, server_load, telemetry_age_s, mask,
                client_rtt_ms,
            )
        return dec, failovers


def make_engine(
    algo: str,
    servers: Sequence[Server],
    cfg: RoutingConfig = RoutingConfig(),
    **kw,
) -> BatchRoutingEngine:
    return BatchRoutingEngine(servers, cfg, algo=algo, **kw)
