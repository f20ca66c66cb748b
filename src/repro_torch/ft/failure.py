"""Fault tolerance and straggler mitigation for multi-pod training fleets,
twin of `repro.ft.failure`.

The paper's technique on the training substrate: a pod's per-step wall
times are a latency sequence like an MCP server's request latencies, so
SONAR's QoS scorer (EWMA / trend / outage / instability, Eq. 7) runs
unchanged on fleet telemetry:

  * `FleetMonitor` keeps a [n_pods, history] step-time window on its
    device (feed-forward recording) and scores every pod once per recorded
    step through `kernels.ops.qos_scores`, which launches the QoS kernel on
    the card and runs its plain version `core.qos.network_score` on the CPU;
  * pods scoring below ``exclude_threshold`` (persistent stragglers) or
    clamped offline (crash / hang, score -1) are excluded;
  * `ElasticPlan` keeps the surviving pods and rescales the per-pod batch
    so the global batch is preserved;
  * the training driver checkpoints when the fleet shrinks
    (`repro_torch.launch.train`).

`FailureInjector` is the controlled chaos of the tests and the driver
(crash, straggle, heal).  It draws from numpy's ``default_rng`` like the
reference's, so the same seed gives the same step times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qos import QosParams, network_score  # noqa: F401  (the reference's re-export)
from repro_torch.kernels import ops


def step_time_qos(base_step_s: float) -> QosParams:
    ms = base_step_s * 1000.0
    return QosParams(
        ideal_low_ms=0.0,
        ideal_high_ms=1.5 * ms,
        base_scale_ms=2.0 * ms,
        outage_risk_ms=4.0 * ms,
        offline_ms=10.0 * ms,
        window=16,
    )


class FleetMonitor:
    """Per-pod step times [n_pods, history] in ms (f32) on ``device`` (None:
    the card), scored with Eq. 7 under `step_time_qos`.  `scores` runs the
    scorer once per `record` and keeps the result until the next one."""

    def __init__(self, n_pods: int, base_step_s: float, history: int = 64,
                 exclude_threshold: float = 0.25, device=None):
        self.n_pods = n_pods
        self.qos = step_time_qos(base_step_s)
        self.history = history
        self.exclude_threshold = exclude_threshold
        init_ms = base_step_s * 1000.0
        self.telemetry = torch.full((n_pods, history), init_ms, dtype=torch.float32,
                                    device=resolve_device(device))
        self._scores: Optional[np.ndarray] = None

    def record(self, step_times_s: np.ndarray):
        """Feed-forward: append one step's per-pod wall time (seconds)."""
        col = torch.from_numpy(np.asarray(step_times_s, np.float32) * 1000.0)
        self.telemetry = torch.roll(self.telemetry, -1, dims=1)
        self.telemetry[:, -1] = col.to(self.telemetry.device)
        self._scores = None

    def scores(self) -> np.ndarray:
        """N in [-1, 1] per pod (host f32), computed once per recorded step."""
        if self._scores is None:
            self._scores = ops.qos_scores(self.telemetry, self.qos).cpu().numpy()
        return self._scores

    def healthy_pods(self) -> np.ndarray:
        s = self.scores()
        return np.where(s >= self.exclude_threshold)[0]


@dataclasses.dataclass
class ElasticPlan:
    """Remapping decision after exclusions."""
    healthy: list
    n_pods: int
    per_pod_batch: int
    changed: bool


def plan_elastic(
    monitor: FleetMonitor, global_batch: int, prev_healthy: Optional[list] = None
) -> ElasticPlan:
    healthy = [int(i) for i in monitor.healthy_pods()]
    if not healthy:                       # never kill the whole fleet
        healthy = [int(np.argmax(monitor.scores()))]
    n = len(healthy)
    per_pod = max(global_batch // n, 1)
    changed = prev_healthy is not None and set(healthy) != set(prev_healthy)
    return ElasticPlan(healthy=healthy, n_pods=n, per_pod_batch=per_pod, changed=changed)


class FailureInjector:
    """Deterministic chaos for tests: schedules per-pod behaviours."""

    def __init__(self, n_pods: int, base_step_s: float, seed: int = 0):
        self.n_pods = n_pods
        self.base = base_step_s
        self.rng = np.random.default_rng(seed)
        self.crashed: set = set()
        self.straggling: dict = {}       # pod -> slowdown factor

    def crash(self, pod: int):
        self.crashed.add(pod)

    def straggle(self, pod: int, factor: float = 5.0):
        self.straggling[pod] = factor

    def heal(self, pod: int):
        self.crashed.discard(pod)
        self.straggling.pop(pod, None)

    def step_times(self) -> np.ndarray:
        """Simulated per-pod wall time for one training step (seconds)."""
        t = self.base * (1.0 + 0.05 * self.rng.standard_normal(self.n_pods))
        for pod, f in self.straggling.items():
            t[pod] *= f
        for pod in self.crashed:
            t[pod] = self.base * 1000.0   # hang: far beyond offline threshold
        return np.maximum(t, 1e-4)
