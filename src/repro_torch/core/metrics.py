"""Evaluation metrics (paper Sec. III-A Module 5), twin of `repro.core.metrics`.

  SSR — Selection Success Rate: fraction of tasks whose *final* selected
        server is a websearch-capable server.
  EE  — Expected Expertise: mean softmax expertise C(i*) of final selections.
  AL  — Average Latency (ms) of the selected servers across executed calls.
  SL  — Select Latency (ms): mean per-query tool-selection latency.
  FR  — Failure Rate: server-failure executions / total executions
        (latency >= 1000 ms counts as an outage event).
  TSR / ACT — task success rate and average completion time.

Host numpy over the episode records, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.dataset import WEBSEARCH


@dataclasses.dataclass
class Report:
    ssr: float          # %
    ee: float           # %
    al_ms: float
    sl_ms: float
    fr: float           # %
    tsr: float          # %
    act_ms: float       # average completion time
    n_tasks: int
    n_calls: int

    def row(self, name: str) -> str:
        return (
            f"{name},{self.ssr:.1f},{self.ee:.1f},{self.al_ms:.2f},"
            f"{self.sl_ms:.1f},{self.fr:.1f},{self.tsr:.1f},{self.act_ms:.1f}"
        )

    HEADER = "method,SSR%,EE%,AL_ms,SL_ms,FR%,TSR%,ACT_ms"


def evaluate(records: Sequence, servers: Sequence) -> Report:
    n_tasks = len(records)
    ssr = np.mean([servers[r.final_server_idx].domain == WEBSEARCH for r in records])
    ee = np.mean([r.final_expertise for r in records])
    all_lat = np.concatenate([np.asarray(r.call_latencies_ms) for r in records])
    sl = np.mean([r.select_latency_ms / max(r.n_calls, 1) for r in records])
    n_calls = int(sum(r.n_calls for r in records))
    n_failures = int(sum(r.n_failures for r in records))
    tsr = np.mean([r.success for r in records])
    act = np.mean([r.completion_ms for r in records])
    return Report(
        ssr=float(100 * ssr),
        ee=float(100 * ee),
        al_ms=float(all_lat.mean()),
        sl_ms=float(sl),
        fr=float(100 * n_failures / max(n_calls, 1)),
        tsr=float(100 * tsr),
        act_ms=float(act),
        n_tasks=n_tasks,
        n_calls=n_calls,
    )
