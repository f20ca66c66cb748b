"""Per-server queue/capacity model for the fleet traffic simulator, twin of
`repro.traffic.queueing` (host Python, the same semantics).

Each server is an M/G/c/(c+B) station: `capacity` concurrent service slots,
a bounded FIFO waiting room of `queue_limit` requests, and
utilization-dependent service-time inflation — a busy server answers each
request slower (cache pressure, GC, connection churn), which is the
mechanism behind the measured "server-side queueing dominates MCP tail
latency under concurrency".

The station only manages occupancy and statistics; the discrete-event
simulator owns the clock and the event heap.  Service times are supplied by
the caller (sampled from the simulator's PRNG stream) and inflated here by
the utilization at service start:

    service = draw * (1 + inflation * rho^2),   rho = in_service / capacity

Work conservation by construction: `finish` immediately starts the head of
the waiting queue whenever a slot frees, and `offer` only queues a request
when every slot is occupied.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """One station's capacity model (M/G/c with a bounded FIFO room).

    Attributes
    ----------
    capacity : int
        c concurrent service slots.
    queue_limit : int
        Bounded waiting room beyond the slots; offers past it are dropped
        (recorded as offline events by the simulator).
    base_service_ms : float
        Mean service time at zero load, **ms** (draws are exponential,
        scaled by this).
    inflation : float
        Utilization-dependent service inflation coefficient
        (dimensionless): service = draw * (1 + inflation * rho^2) with
        rho the in-service occupancy at start.
    """

    capacity: int = 4
    queue_limit: int = 16
    base_service_ms: float = 200.0
    inflation: float = 1.0


@dataclasses.dataclass
class QueueStats:
    offered: int = 0               # requests presented to the station
    served: int = 0                # service completions
    dropped: int = 0               # rejected (waiting room full)
    busy_ms: float = 0.0           # integral of busy slots over time (slot-ms)
    service_ms_sum: float = 0.0    # sum of (inflated) service durations


class ServerQueue:
    """One station: occupancy state + drop/start/finish transitions."""

    def __init__(self, cfg: QueueConfig):
        self.cfg = cfg
        self.in_service = 0
        self.waiting: deque = deque()
        self.stats = QueueStats()
        self._last_t_ms = 0.0

    # -- load signals --------------------------------------------------------
    @property
    def demand(self) -> int:
        """In-service + queued — the quantity the load term penalizes."""
        return self.in_service + len(self.waiting)

    @property
    def utilization(self) -> float:
        """rho = demand / capacity (can exceed 1 when the queue is deep)."""
        return self.demand / max(self.cfg.capacity, 1)

    # -- time accounting -----------------------------------------------------
    def _advance(self, now_ms: float) -> None:
        self.stats.busy_ms += self.in_service * max(now_ms - self._last_t_ms, 0.0)
        self._last_t_ms = max(self._last_t_ms, now_ms)

    # -- transitions ---------------------------------------------------------
    def service_time(self, draw_ms: float) -> float:
        """Inflate a sampled service draw by the utilization at start."""
        rho = self.in_service / max(self.cfg.capacity, 1)
        return draw_ms * (1.0 + self.cfg.inflation * rho * rho)

    def offer(self, item, now_ms: float) -> str:
        """Present a request: -> 'start' | 'queued' | 'dropped'."""
        self._advance(now_ms)
        self.stats.offered += 1
        if self.in_service < self.cfg.capacity:
            self.in_service += 1
            return "start"
        if len(self.waiting) < self.cfg.queue_limit:
            self.waiting.append(item)
            return "queued"
        self.stats.dropped += 1
        return "dropped"

    def finish(self, now_ms: float) -> Optional[object]:
        """Complete one service; returns the queued item that starts next
        (work conservation: the freed slot is re-filled immediately), or
        None if the waiting room is empty."""
        self._advance(now_ms)
        self.in_service -= 1
        self.stats.served += 1
        if self.waiting:
            self.in_service += 1
            return self.waiting.popleft()
        return None

    def cancel_waiting(self, item) -> bool:
        """Remove a queued request (hedge winner elsewhere); False if it
        already started."""
        try:
            self.waiting.remove(item)
            return True
        except ValueError:
            return False

    def record_service(self, service_ms: float) -> None:
        self.stats.service_ms_sum += service_ms
