"""Routing traffic for a tiled MCP-server fleet, from the seed.

* ``n_windows`` batches of ``batch`` agent queries: every batch holds the
  same multiset of the pool's task texts (the texts in turn, ``batch``
  of them), in its own order drawn from the seed, so the work of a batch
  does not change with the seed;
* per batch, the fleet's state at successive time steps: a compact
  telemetry window [n_tel_templates, T] of latencies in ms (each server
  reads the row ``tel_map[server]``), each server's load (utilisation in
  [0, ``load_max``)), its telemetry age in s (in [0, ``age_max_s``)) and a
  failed flag (probability ``failed_share``).

The telemetry templates follow the five canonical network states in turn
(ideal, high latency, high jitter, fluctuating, outage-prone), each with
its own level drawn from the seed, sampled every ``dt_s`` seconds; the
windows are consecutive slices of one trace per template, so batch b sees
the network at step b.  ``tel_map`` is a Knuth-stride map of servers onto
templates, co-prime with the description round-robin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

OFFLINE_MS = 1200.0


@dataclasses.dataclass
class FleetTraffic:
    texts: list          # n_windows lists of ``batch`` query strings
    telemetry: list      # n_windows f32 [n_tel_templates, T]
    load: list           # n_windows f32 [n_servers]
    age_s: list          # n_windows f32 [n_servers]
    failed: list         # n_windows bool [n_servers]
    tel_map: np.ndarray  # int64 [n_servers]


def tel_map(n_servers: int, n_templates: int) -> np.ndarray:
    return (np.arange(n_servers, dtype=np.int64) * 2654435761) % n_templates


def traces(rng: np.random.Generator, n_templates: int, n_steps: int, dt_s: float) -> np.ndarray:
    """[n_templates, n_steps] latencies (ms) of the five canonical states."""
    t = np.arange(n_steps) * dt_s
    out = np.empty((n_templates, n_steps), np.float64)
    for i in range(n_templates):
        kind = i % 5
        noise = rng.standard_normal(n_steps)
        if kind == 0:        # ideal
            out[i] = 20.0 + 15.0 * rng.random() + (3.0 + 4.0 * rng.random()) * noise
        elif kind == 1:      # high latency
            out[i] = 250.0 + 150.0 * rng.random() + 15.0 * noise
        elif kind == 2:      # high jitter
            out[i] = 100.0 + (50.0 + 30.0 * rng.random()) * noise
        elif kind == 3:      # fluctuating
            phase = 2.0 * np.pi * rng.random()
            out[i] = 150.0 + 120.0 * np.sin(2.0 * np.pi * t / 120.0 + phase) + 10.0 * noise
        else:                # outage-prone: offline stretches, risky spikes before them
            out[i] = 60.0 + 10.0 * noise
            p = 0.2 + 0.3 * rng.random()
            down = rng.random(n_steps) < p / 8.0
            for s in np.flatnonzero(down):
                out[i, s:s + 8] = OFFLINE_MS
                out[i, max(s - 4, 0):s] = 850.0 + 100.0 * rng.random()
    return np.maximum(out, 1.0).astype(np.float32)


def make(seed: int, t: dict, cfg: dict, tasks: list) -> FleetTraffic:
    """The batches of traffic mix ``t`` on fleet ``cfg`` (a configuration
    file's ``fleet``)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    n, nw, B = cfg["n_servers"], t["n_windows"], t["batch"]
    T, M = cfg["telemetry_window"], cfg["n_tel_templates"]
    trace = traces(rng, M, nw + T - 1, t["dt_s"])
    texts = [[tasks[j % len(tasks)] for j in rng.permutation(B)] for _ in range(nw)]
    return FleetTraffic(
        texts=texts,
        telemetry=[np.ascontiguousarray(trace[:, w:w + T]) for w in range(nw)],
        load=[(rng.random(n, dtype=np.float32) * np.float32(t["load_max"])) for _ in range(nw)],
        age_s=[(rng.random(n, dtype=np.float32) * np.float32(t["age_max_s"]))
               for _ in range(nw)],
        failed=[rng.random(n, dtype=np.float32) < t["failed_share"] for _ in range(nw)],
        tel_map=tel_map(n, M),
    )
