"""Session workloads, twin of `repro.sessions`: session-DAG templates and
their seeded generator (`dag`), per-(session, server) warmth, the W term of
SONAR-SESSION (`warmth`), and `SessionTrafficSim`, the discrete-event
simulator that releases DAG nodes on parent completion and accounts
success and latency per task (`sim`)."""
from repro_torch.sessions.dag import (
    DAG_TEMPLATES,
    SessionDAG,
    SessionNode,
    chain,
    critical_path,
    fanout_fanin,
    generate_sessions,
    map_reduce,
    retry_loop,
)
from repro_torch.sessions.sim import SessionReport, SessionTrafficSim
from repro_torch.sessions.warmth import WarmthTracker

__all__ = [
    "DAG_TEMPLATES",
    "SessionDAG",
    "SessionNode",
    "SessionReport",
    "SessionTrafficSim",
    "WarmthTracker",
    "chain",
    "critical_path",
    "fanout_fanin",
    "generate_sessions",
    "map_reduce",
    "retry_loop",
]
