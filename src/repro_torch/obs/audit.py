"""Score-decomposition audit tap, twin of `repro.obs.audit`: "why did
SONAR pick that server".

`Router.select` accepts ``audit=<AuditTap>`` and, after the argmax,
hands the tap the exact candidate component arrays it fused: softmax
expertise C, effective network score N (post staleness discount), load
penalty U, RTT penalty R, warm affinity W, the dead mask, and the fused S.
The tap stores them as one `ScoreAudit` per decision.

`ScoreAudit.recompose()` re-applies the fusion

    S = α·C + β·N  −  γ·U  −  δ·R  (+ ε·W),   dead → −inf

with the same numpy operations in the same order on the same dtypes as
the port's `Router.select`, so the recomposed array is bit-identical to
the score vector the argmax saw.  `terms()` splits the winner's score
into its α/β/γ/δ (and ε) contributions for dashboards and logs.

The tap costs nothing when absent: ``audit=None`` (the default) is a
single ``is not None`` check in `select`.  numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["AuditTap", "ScoreAudit"]


@dataclasses.dataclass
class ScoreAudit:
    """Full decomposition of one routing decision's fused scores.

    Arrays are over the candidate tool set (aligned with
    ``cand_tools``); ``None`` marks a term the algorithm did not use for
    this decision, mirroring the branch structure of `Router.select`.
    """

    algo: str
    query: str
    alpha: float
    beta: float
    gamma: float
    delta: float
    cand_servers: np.ndarray        # stage-1 winners (server ids)
    cand_tools: np.ndarray          # stage-2 winners (global tool ids)
    cand_hosts: np.ndarray          # host server of each candidate tool
    expertise: np.ndarray           # C, Eq. 5 softmax
    network: Optional[np.ndarray]   # N after staleness discount (None: unused)
    load_pen: Optional[np.ndarray]  # U(rho) (None: unused)
    rtt_pen: Optional[np.ndarray]   # R(rtt) (None: unused)
    dead: Optional[np.ndarray]      # bool exclusion mask (None: unused)
    fused: np.ndarray               # S as argmaxed (recorded, not derived)
    best: int                       # argmax position in the candidate set
    server_idx: int                 # winning server (global id)
    tool_idx: int                   # winning tool (global id)
    eps: float = 0.0
    aff_bonus: Optional[np.ndarray] = None  # W warm-affinity (None: unused)

    def recompose(self) -> np.ndarray:
        """Rebuild S from the recorded components, replicating
        `Router.select`'s op order and dtypes exactly."""
        C = self.expertise
        if self.network is not None:
            S = self.alpha * C + self.beta * self.network
        else:
            S = C
        if self.load_pen is not None:
            S = S - self.gamma * self.load_pen
        if self.rtt_pen is not None:
            S = S - self.delta * self.rtt_pen
        if self.aff_bonus is not None:
            S = S + self.eps * self.aff_bonus
        if self.dead is not None:
            S = np.where(self.dead, -np.inf, S)
        return S

    def terms(self) -> dict:
        """The winner's score split into per-term contributions.  Summing
        them in fusion order reproduces the winning fused score exactly
        (same scalar ops `select` performed elementwise)."""
        b = self.best
        f32 = np.float32
        if self.network is not None:
            t = {
                "expertise": f32(self.alpha) * self.expertise[b],
                "network": f32(self.beta) * self.network[b],
            }
        else:
            t = {"expertise": self.expertise[b], "network": f32(0.0)}
        t["load"] = (
            -(f32(self.gamma) * self.load_pen[b])
            if self.load_pen is not None else f32(0.0)
        )
        t["rtt"] = (
            -(f32(self.delta) * self.rtt_pen[b])
            if self.rtt_pen is not None else f32(0.0)
        )
        if self.aff_bonus is not None:
            # only affinity-scored decisions carry the term: zero-affinity
            # audits keep the historical four-term split byte-for-byte
            t["affinity"] = f32(self.eps) * self.aff_bonus[b]
        return {k: float(v) for k, v in t.items()}

    def winning_score(self) -> float:
        """Term-by-term scalar recomposition of the winning score: the
        identical op sequence `select` applied elementwise, evaluated at
        the winner only.  Bit-equal to ``Decision.fused``."""
        return float(self.recompose()[self.best])

    def explain(self) -> str:
        """One-line human rendering for logs/dashboard."""
        t = self.terms()
        parts = " ".join(f"{k}={v:+.4f}" for k, v in t.items())
        return (
            f"[{self.algo}] server {self.server_idx} tool {self.tool_idx} "
            f"S={self.winning_score():.4f} ({parts})"
        )


class AuditTap:
    """Bounded sink of `ScoreAudit` records (newest kept, oldest dropped).

    Pass one as ``Router.select(..., audit=tap)`` — or thread it through
    `SonarGateway` scalar routing — and read `records` back.
    """

    def __init__(self, max_records: int = 10_000):
        self.max_records = int(max_records)
        self.records: list = []
        self.n_dropped = 0

    def record(self, *, algo, query, cfg, cand_servers, cand_tools,
               cand_hosts, expertise, network, load_pen, rtt_pen, dead,
               fused, best, decision, aff_bonus=None) -> None:
        """Called by `Router.select` after the argmax (copies the arrays:
        audits must stay valid after the router moves on)."""
        if len(self.records) >= self.max_records:
            self.n_dropped += 1
            return
        self.records.append(ScoreAudit(
            algo=algo,
            query=query,
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma, delta=cfg.delta,
            eps=getattr(cfg, "eps", 0.0),
            aff_bonus=None if aff_bonus is None else np.array(aff_bonus),
            cand_servers=np.array(cand_servers),
            cand_tools=np.array(cand_tools),
            cand_hosts=np.array(cand_hosts),
            expertise=np.array(expertise),
            network=None if network is None else np.array(network),
            load_pen=None if load_pen is None else np.array(load_pen),
            rtt_pen=None if rtt_pen is None else np.array(rtt_pen),
            dead=None if dead is None else np.array(dead),
            fused=np.array(fused),
            best=int(best),
            server_idx=int(decision.server_idx),
            tool_idx=int(decision.tool_idx),
        ))

    @property
    def last(self) -> Optional[ScoreAudit]:
        return self.records[-1] if self.records else None

    def clear(self) -> None:
        self.records = []
        self.n_dropped = 0
