"""Per-(session, server) sticky-affinity state: the W of SONAR-SESSION,
twin of `repro.sessions.warmth` (host numpy, as the reference).

A server that has just served a session holds that session's context
warm — KV cache, tool sandboxes, fetched documents — so routing the
session's *next* DAG node to the same server is cheaper than a cold
replica, all else equal.  `WarmthTracker` keeps one warmth vector per
live session:

    W[server] <- 1.0                    on a completion for the session
    W[server] <- W[server] * 2^(-dt/h)  lazily, h = half_life_ms

Decay is applied lazily at read time from the stored last-touch
timestamp, so the tracker costs O(1) per touch and O(n_servers) per
read, with no background clock.  Warmth is bounded in [0, 1] by
construction, which keeps the ``+eps*W`` bonus commensurate with the
other fused-score terms.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["WarmthTracker"]


class WarmthTracker:
    """Lazily-decayed per-(session, server) warmth vectors."""

    def __init__(self, n_servers: int, half_life_ms: float = 30_000.0,
                 floor: float = 1e-4):
        assert n_servers > 0 and half_life_ms > 0
        self.n_servers = int(n_servers)
        self.half_life_ms = float(half_life_ms)
        self.floor = float(floor)     # prune threshold after decay
        self._w: dict = {}            # session_id -> np.ndarray [n_servers]
        self._t: dict = {}            # session_id -> last-touch time (ms)

    def _decay(self, sid: int, now_ms: float) -> np.ndarray:
        w = self._w[sid]
        dt = max(now_ms - self._t[sid], 0.0)
        if dt > 0.0:
            w *= np.float32(2.0 ** (-dt / self.half_life_ms))
            self._t[sid] = now_ms
        return w

    def touch(self, session_id: int, server: int, now_ms: float) -> None:
        """A completion for ``session_id`` landed on ``server``."""
        sid = int(session_id)
        if sid not in self._w:
            self._w[sid] = np.zeros(self.n_servers, np.float32)
            self._t[sid] = now_ms
        w = self._decay(sid, now_ms)
        w[int(server)] = 1.0

    def warmth(self, session_id: int, now_ms: float) -> Optional[np.ndarray]:
        """Current [n_servers] warmth for the session (None if cold —
        callers pass None through to the router, which keeps untracked
        sessions on the exact zero-affinity path)."""
        sid = int(session_id)
        if sid not in self._w:
            return None
        w = self._decay(sid, now_ms)
        if float(w.max()) < self.floor:
            del self._w[sid], self._t[sid]
            return None
        return w

    def forget(self, session_id: int) -> None:
        """Drop a finished session's state (bounds live memory by the
        number of in-flight sessions)."""
        self._w.pop(int(session_id), None)
        self._t.pop(int(session_id), None)

    def __len__(self) -> int:
        return len(self._w)
