"""Tool-routing algorithms (paper Sec. IV + baselines of Sec. V-B), port of
`repro.core.routing`.

  RAG        — two-stage coarse-to-fine BM25 on the *raw* query.
  RerankRAG  — RAG + a canonical-intent rerank over the candidate set
               (charged the paper's ~20 s/query LLM cost).
  PRAG       — tool prediction (q -> q_pre) + two-stage BM25.
  SONAR      — PRAG + network-QoS fusion S = alpha*C + beta*N (Eq. 8-9).
  SONAR-LB   — SONAR - gamma*U(rho), the host server's load penalty.
  SONAR-FT   — SONAR-LB with staleness-discounted QoS and failed-server
               argmax masking + a bounded failover loop.
  SONAR-GEO  — SONAR-LB - delta*R(rtt), the client->server RTT penalty.
  SONAR-SESSION — SONAR-GEO + eps*W, the session's warm-affinity bonus.
  SONAR-ADAPT — SONAR-GEO + staleness + failover with learned weights
               (`repro_torch.core.adaptive`, registered on import).

The scalar `Router.select` stays numpy on the host, one query at a time:
it is the oracle the batched engine is held to.  Its QoS, load, RTT and
staleness terms call the port's torch functions on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bm25
from repro_torch.core.dataset import Server, WEBSEARCH
from repro_torch.core.qos import (
    DEFAULT_QOS,
    QosParams,
    load_penalty,
    network_score,
    rtt_penalty,
    staleness_discount,
)

# Simulated component latencies (ms) — calibrated to Fig. 7's SL axis.
LLM_CALL_MS = 300.0          # one short LLM call (predict / translate)
BM25_STAGE_MS = 2.0          # one vectorized BM25 stage
LLM_RERANK_MS = 20_000.0     # LLM rerank over the candidate set (Fig. 7)


# ---------------------------------------------------------------------------
# Tool prediction (Sec. IV-A) — deterministic stand-in for the LLM preprocess
# ---------------------------------------------------------------------------

_INTENT_KEYWORDS = {
    "coding": ["refactor", "bug", "compile", "repository", "pull", "diff", "function"],
    "product": ["order", "cart", "buy", "purchase", "amazon", "shipping", "catalog"],
    "database": ["sql", "database", "schema", "join", "postgres"],
    "weather": ["forecast", "temperature", "rain", "humidity"],
    "finance": ["stock", "ticker", "portfolio", "dividend", "earnings"],
    "travel": ["flight", "hotel", "itinerary", "booking", "airport"],
    "business": ["linkedin", "profile", "recruiter", "resume"],
    "filesystem": ["file", "directory", "folder", "path"],
    "email": ["email", "inbox", "mailbox", "etiquette"],
    "calendar": ["schedule", "meeting", "calendar", "appointment"],
    # serving-gateway intents (model-capability routing; DESIGN.md §2)
    "audio_ai": ["transcribe", "audio", "speech", "recording", "spoken"],
    "vision_ai": ["image", "photo", "picture", "visual"],
}

_QUESTION_WORDS = ("who", "what", "when", "where", "which", "why", "how")

CANONICAL_DESCRIPTIONS = {
    # The websearch intent enumerates the synonym families an LLM would emit
    # ("web/internet/online search/lookup/retrieval of real-time/live/current
    # information") so equivalently-capable replicas with polished
    # descriptions score comparably (paper Sec. V-A: identical backends).
    WEBSEARCH: (
        "a web search tool to search lookup and retrieve real-time live "
        "current fresh up-to-date information news facts articles and "
        "results online on the internet web www"
    ),
    "coding": "a code modification tool to edit refactor and fix code",
    "product": "a product search tool to search the amazon catalog for a product and its price",
    "database": "a database tool to execute a sql query against a database",
    "weather": "a weather tool to get the weather forecast for a location",
    "finance": "a finance tool to get a stock quote and company financials",
    "travel": "a travel tool to search flights and hotels",
    "business": "a professional network tool to look up a company profile and people",
    "filesystem": "a filesystem tool to read and write files",
    "email": "an email tool to send and search email",
    "calendar": "a calendar tool to create events and schedule meetings",
    "audio_ai": "an audio model for speech transcription and audio translation",
    "vision_ai": "a vision language model for image understanding and visual question answering",
}


def predict_tool_type(query: str) -> tuple[str, str]:
    """q -> (intent, q_pre).  Mirrors the paper's LLM preprocessing: strips
    redundant phrasing down to a standardized tool-type description.  The
    known failure mode (paper Sec. IV-A / our `hard` queries): leading
    domain-dominant vocabulary drags the intent away from websearch."""
    toks = bm25.tokenize(query)
    scores = {k: 0.0 for k in _INTENT_KEYWORDS}
    for pos, t in enumerate(toks):
        for intent, kws in _INTENT_KEYWORDS.items():
            if t in kws:
                # early tokens dominate — the "misleading keyword" effect
                scores[intent] += 2.0 if pos <= 2 else 1.0
    best_intent, best = WEBSEARCH, 1.0  # prior mass on info-seeking
    if toks and toks[0] in _QUESTION_WORDS:
        best = 2.5
    for intent, s in scores.items():
        if s > best:
            best_intent, best = intent, s
    return best_intent, CANONICAL_DESCRIPTIONS[best_intent]


# ---------------------------------------------------------------------------
# Routing decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Decision:
    server_idx: int
    tool_idx: int                  # global tool index in the pool
    expertise: float               # C(i*) — softmax-normalized (Eq. 5)
    network: float                 # N(i*) — QoS score (Eq. 7); 0 if unused
    fused: float                   # S(i*) (Eq. 8)
    select_latency_ms: float       # SL contribution of this decision
    candidate_servers: list
    candidate_tools: list


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    top_s: int = 5                 # #filter_server (stage 1, Eq. 2)
    top_k: int = 10                # #filter_tool   (stage 2, Eq. 4)
    alpha: float = 0.5             # semantic weight (Eq. 8)
    beta: float = 0.5              # network weight  (Eq. 8)
    # Load-aware extension (SONAR-LB): S = alpha*C + beta*N - gamma*U(rho),
    # with U the convex utilization penalty of core.qos.load_penalty.
    # Only consulted when the algorithm `uses_load` AND a server_load vector
    # is supplied; gamma=0 or load=None reduces exactly to SONAR.
    gamma: float = 0.35            # load weight
    load_knee: float = 0.75        # utilization where the penalty turns convex
    load_sharp: float = 4.0        # superlinear coefficient past the knee
    # Failover-aware extension (SONAR-FT): the QoS term is discounted by
    # telemetry age, N' = staleness_discount(age) * N (age 0 => exactly
    # SONAR/SONAR-LB), and servers in a failed-mask are excluded from the
    # final argmax.  `failover_budget` bounds the re-route loop of
    # `select_failover` / `BatchRoutingEngine.route_failover`.
    stale_half_life_s: float = 180.0
    failover_budget: int = 2
    # Locality-aware extension (SONAR-GEO): S -= delta * R(rtt) with
    # R(rtt) = rtt / (rtt + rtt_scale_ms) the saturating propagation-RTT
    # penalty of core.qos.rtt_penalty.  Only consulted when the algorithm
    # `uses_rtt` AND a client RTT vector is supplied; delta=0 or
    # rtt=None (or an all-zero RTT topology) reduces exactly to SONAR-LB.
    delta: float = 0.4             # locality weight
    rtt_scale_ms: float = 150.0    # RTT at which the penalty reaches 0.5
    # Session-affinity extension (SONAR-SESSION): S += eps * W(server,
    # session) with W in [0, 1] the warm-context bonus of servers that
    # recently served this session (exponentially decayed by the warmth
    # tracker).  Only consulted when the algorithm `uses_affinity` AND an
    # affinity vector is supplied; eps=0, affinity=None, or an all-zero
    # warmth vector reduces byte-identically to SONAR-GEO.
    eps: float = 0.25              # affinity weight
    # Softmax temperature of Eq. 5 ("amplifies the relative differences
    # between expert tools and non-expert tools").
    expertise_temp: float = 1.0
    qos: QosParams = DEFAULT_QOS


class ToolIndex:
    """Compiled two-level BM25 index over a server pool (built once)."""

    def __init__(self, servers: Sequence[Server]):
        self.servers = list(servers)
        self.server_corpus = bm25.build_corpus([s.description for s in servers])
        tool_docs, tool_server, self.tool_names = [], [], []
        for si, s in enumerate(servers):
            for t in s.tools:
                tool_docs.append(f"{t.name.replace('_', ' ')} {t.description}")
                tool_server.append(si)
                self.tool_names.append(t.name)
        self.tool_corpus = bm25.build_corpus(tool_docs)
        self.tool_server = np.asarray(tool_server, dtype=np.int32)
        self.n_tools = len(tool_docs)

    @classmethod
    def from_corpora(
        cls,
        servers: Sequence[Server],
        server_corpus: bm25.Bm25Corpus,
        tool_corpus: bm25.Bm25Corpus,
        tool_server: np.ndarray,
        tool_names: Sequence[str],
    ) -> "ToolIndex":
        """An index over already-compiled corpora (no re-tokenising)."""
        self = cls.__new__(cls)
        self.servers = list(servers)
        self.server_corpus = server_corpus
        self.tool_corpus = tool_corpus
        self.tool_server = np.asarray(tool_server, dtype=np.int32)
        self.tool_names = list(tool_names)
        self.n_tools = int(self.tool_server.shape[0])
        return self

    @staticmethod
    def _row_scores(weights: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Row-deterministic matvec: ``(W * q).sum(axis=1)`` reduces every
        row in the same traversal order, so *identical* rows (replica
        fleets) score bit-identically.  BLAS ``W @ q`` does not guarantee
        that: its remainder-row kernels can round tail rows one ulp apart."""
        return np.asarray((weights * q[None, :]).sum(axis=1, dtype=np.float32))

    def server_scores(self, qtext: str) -> np.ndarray:
        q = self.server_corpus.encode_query(qtext)
        return self._row_scores(self.server_corpus.weights, q)

    def tool_scores(self, qtext: str) -> np.ndarray:
        q = self.tool_corpus.encode_query(qtext)
        return self._row_scores(self.tool_corpus.weights, q)


def _cpu(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


class Router:
    """Base class: two-stage semantic retrieval shared by all algorithms."""

    name = "base"
    uses_prediction = False
    uses_network = False
    uses_load = False
    uses_staleness = False
    uses_failover = False
    uses_rtt = False
    uses_affinity = False
    rerank = False

    def __init__(self, servers: Sequence[Server], cfg: RoutingConfig = RoutingConfig()):
        self.cfg = cfg
        self.index = ToolIndex(servers)

    # -- semantic stages ----------------------------------------------------
    def _preprocess(self, query: str) -> tuple[str, float]:
        if self.uses_prediction:
            _, q_pre = predict_tool_type(query)
            return q_pre, LLM_CALL_MS
        # RAG baseline still pays one LLM call for translation (Sec. V-B).
        return query, LLM_CALL_MS

    def _candidates(self, qtext: str, failed_mask: Optional[np.ndarray] = None):
        """Stage 1 (Eq. 1-2) then stage 2 (Eq. 3-4) -> candidate tool ids.

        Known-failed servers are demoted below every live server *before*
        the stage-1 top-s; when fewer than top_s remain alive, dead ones
        re-fill the tail in index order."""
        s_scores = self.index.server_scores(qtext)
        if failed_mask is not None:
            s_scores = np.where(np.asarray(failed_mask, bool), -np.inf, s_scores)
        top_s = min(self.cfg.top_s, len(s_scores))
        cand_servers = np.argsort(-s_scores, kind="stable")[:top_s]
        in_cand = np.isin(self.index.tool_server, cand_servers)
        t_scores = self.index.tool_scores(qtext)
        t_scores = np.where(in_cand, t_scores, -np.inf)
        top_k = min(self.cfg.top_k, int(in_cand.sum()))
        cand_tools = np.argsort(-t_scores, kind="stable")[:top_k]
        return cand_servers, cand_tools, t_scores[cand_tools]

    def _expertise(self, scores: np.ndarray) -> np.ndarray:
        """Eq. 5 softmax normalization over the candidate set."""
        z = (scores - scores.max()) / self.cfg.expertise_temp
        e = np.exp(z)
        return e / e.sum()

    # -- selection ----------------------------------------------------------
    def select(
        self,
        query: str,
        latency_hist: Optional[np.ndarray] = None,
        server_load: Optional[np.ndarray] = None,
        telemetry_age_s: Optional[np.ndarray] = None,
        failed_mask: Optional[np.ndarray] = None,
        client_rtt_ms: Optional[np.ndarray] = None,
        affinity: Optional[np.ndarray] = None,
        audit=None,
    ) -> Decision:
        """Route one query (Algorithm 1): two-stage retrieval, Eq. 5
        softmax expertise, QoS/load/staleness/locality/affinity fusion,
        argmax.  Arrays are per server: ``latency_hist`` f32 [n_servers, T]
        ms (newest last), ``server_load`` utilization, ``telemetry_age_s``
        seconds, ``failed_mask`` bool, ``client_rtt_ms`` ms, ``affinity``
        warmth in [0, 1].  Each is read only by the algorithms that use it;
        None reduces the fusion to the simpler variant.  An ``audit``
        (`repro_torch.obs.AuditTap`) records the arrays the argmax fused.
        Deterministic."""
        qtext, sl = self._preprocess(query)
        fm = failed_mask if self.uses_failover else None
        cand_servers, cand_tools, scores = self._candidates(qtext, fm)
        sl += 2 * BM25_STAGE_MS
        cand_hosts = self.index.tool_server[cand_tools]

        if self.rerank:
            # rerank: re-score candidates against the canonical intent
            # description, charged the ~20 s LLM cost.
            _, q_pre = predict_tool_type(query)
            q = self.index.tool_corpus.encode_query(q_pre)
            scores = ToolIndex._row_scores(
                self.index.tool_corpus.weights[cand_tools], q
            )
            sl += LLM_RERANK_MS

        C = self._expertise(scores)

        network_used = self.uses_network and latency_hist is not None
        if network_used:
            hist = np.asarray(latency_hist)[cand_hosts]
            N = network_score(_cpu(hist), self.cfg.qos).numpy()
            if self.uses_staleness and telemetry_age_s is not None:
                age = np.asarray(telemetry_age_s, np.float32)[cand_hosts]
                N = staleness_discount(
                    _cpu(age), self.cfg.stale_half_life_s
                ).numpy() * N
            S = self.cfg.alpha * C + self.cfg.beta * N
        else:
            N = np.zeros_like(C)
            S = C

        U = None
        if self.uses_load and server_load is not None and self.cfg.gamma != 0.0:
            rho = np.asarray(server_load, np.float32)[cand_hosts]
            U = load_penalty(_cpu(rho), self.cfg.load_knee, self.cfg.load_sharp).numpy()
            S = S - self.cfg.gamma * U

        R = None
        if self.uses_rtt and client_rtt_ms is not None and self.cfg.delta != 0.0:
            rtt = np.asarray(client_rtt_ms, np.float32)[cand_hosts]
            R = rtt_penalty(_cpu(rtt), self.cfg.rtt_scale_ms).numpy()
            S = S - self.cfg.delta * R

        A = None
        if self.uses_affinity and affinity is not None and self.cfg.eps != 0.0:
            A = np.asarray(affinity, np.float32)[cand_hosts]
            S = S + self.cfg.eps * A

        dead = None
        if self.uses_failover and failed_mask is not None:
            # known-failed servers are removed from the argmax but keep
            # their softmax mass
            dead = np.asarray(failed_mask, bool)[cand_hosts]
            S = np.where(dead, -np.inf, S)

        best = int(np.argmax(S))
        tool_idx = int(cand_tools[best])
        decision = Decision(
            server_idx=int(self.index.tool_server[tool_idx]),
            tool_idx=tool_idx,
            expertise=float(C[best]),
            network=float(N[best]),
            fused=float(S[best]),
            select_latency_ms=float(sl),
            candidate_servers=[int(s) for s in cand_servers],
            candidate_tools=[int(t) for t in cand_tools],
        )
        if audit is not None:
            audit.record(
                algo=self.name, query=query, cfg=self.cfg,
                cand_servers=cand_servers, cand_tools=cand_tools,
                cand_hosts=cand_hosts, expertise=C,
                network=N if network_used else None,
                load_pen=U, rtt_pen=R, dead=dead, fused=S,
                best=best, decision=decision, aff_bonus=A,
            )
        return decision

    def select_failover(
        self,
        query: str,
        latency_hist: Optional[np.ndarray] = None,
        server_load: Optional[np.ndarray] = None,
        telemetry_age_s: Optional[np.ndarray] = None,
        alive: Optional[np.ndarray] = None,      # [n_servers] bool probe result
        failed_mask: Optional[np.ndarray] = None,
        budget: Optional[int] = None,
        client_rtt_ms: Optional[np.ndarray] = None,
        affinity: Optional[np.ndarray] = None,
        audit=None,
    ) -> tuple[Decision, int]:
        """Failover loop (SONAR-FT): route, probe the pick against `alive`,
        and on a dead pick re-route with that server masked out — at most
        `budget` (default cfg.failover_budget) extra routes.  Returns the
        final decision and the number of failovers taken.  An ``audit`` tap
        records every hop, so a failover chain reads as consecutive
        records."""
        budget = self.cfg.failover_budget if budget is None else int(budget)
        n_servers = len(self.index.servers)
        mask = (
            np.zeros(n_servers, bool)
            if failed_mask is None
            else np.array(failed_mask, bool).copy()
        )
        up = None if alive is None else np.asarray(alive, bool)
        failovers = 0
        while True:
            d = self.select(
                query, latency_hist, server_load,
                telemetry_age_s=telemetry_age_s,
                failed_mask=mask if mask.any() else None,
                client_rtt_ms=client_rtt_ms,
                affinity=affinity,
                audit=audit,
            )
            if up is None or up[d.server_idx] or failovers >= budget:
                return d, failovers
            mask[d.server_idx] = True
            failovers += 1


class RagRouter(Router):
    name = "RAG"


class RerankRagRouter(Router):
    name = "RerankRAG"
    rerank = True


class PragRouter(Router):
    name = "PRAG"
    uses_prediction = True


class SonarRouter(PragRouter):
    """Algorithm 1: PRAG semantic stages + network-aware joint optimization."""

    name = "SONAR"
    uses_network = True


class SonarLBRouter(SonarRouter):
    """SONAR-LB: S = alpha*C + beta*N - gamma*U(rho); without a load vector
    (or with gamma=0) exactly SONAR."""

    name = "SONAR-LB"
    uses_load = True


class SonarFTRouter(SonarLBRouter):
    """SONAR-FT: SONAR-LB with staleness-discounted QoS N' = 0.5**(age/h) * N
    and failed-server argmax masking; with fresh telemetry and no mask
    exactly SONAR-LB."""

    name = "SONAR-FT"
    uses_staleness = True
    uses_failover = True


class SonarGeoRouter(SonarLBRouter):
    """SONAR-GEO: SONAR-LB - delta*R(rtt) with R(rtt) = rtt / (rtt + scale);
    with no RTT vector, delta=0 or all-zero RTTs exactly SONAR-LB."""

    name = "SONAR-GEO"
    uses_rtt = True


class SonarSessionRouter(SonarGeoRouter):
    """SONAR-SESSION: SONAR-GEO + eps*W(host, session), the warm-context
    bonus in [0, 1]; with no affinity, eps=0 or all-zero warmth exactly
    SONAR-GEO."""

    name = "SONAR-SESSION"
    uses_affinity = True


ALGORITHMS = {
    "rag": RagRouter,
    "rerank_rag": RerankRagRouter,
    "prag": PragRouter,
    "sonar": SonarRouter,
    "sonar_lb": SonarLBRouter,
    "sonar_ft": SonarFTRouter,
    "sonar_geo": SonarGeoRouter,
    "sonar_session": SonarSessionRouter,
}


def algorithm(name: str) -> type:
    """Router class of an algorithm name (``sonar-lb`` == ``sonar_lb``).
    ``sonar_adapt`` lives in `core.adaptive`, which imports this module and
    registers itself; it is imported here on first use."""
    key = name.lower().replace("-", "_")
    if key == "sonar_adapt" and key not in ALGORITHMS:
        from repro_torch.core import adaptive  # noqa: F401  (registers sonar_adapt)
    return ALGORITHMS[key]


def make_router(name: str, servers: Sequence[Server], cfg: RoutingConfig = RoutingConfig()) -> Router:
    return algorithm(name)(servers, cfg)
