"""Canonical fleets for traffic experiments, port of `repro.traffic.fleet`.

A pool of *identical* websearch replicas is the adversarial case for
load-blind routing: semantic scores tie, QoS ties on a healthy network, so
argmax herds every request onto one replica.  A mega fleet (10^5-10^6
servers) tiles the canonical pool's templates and never densifies its
index or its telemetry.  The platforms synthesize their traces on
``device`` (None: the card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import latency as L
from repro_torch.core.dataset import WEBSEARCH, Server, Tool
from repro_torch.core.platform import NetMCPPlatform


def replica_fleet(n: int) -> list:
    """n equivalently-capable websearch replicas (identical descriptions)."""
    return [
        Server(
            name=f"websearch-replica-{i}",
            domain=WEBSEARCH,
            description="web search engine for live internet information retrieval",
            tools=[
                Tool("web_search", "search the web for real-time information news and facts")
            ],
        )
        for i in range(n)
    ]


def ideal_platform(
    servers: list,
    seed: int = 0,
    horizon_s: float = 900.0,
    dt_s: float = 1.0,
    geo=None,
    device=None,
) -> NetMCPPlatform:
    """Healthy network for every replica, at a 1 s observation tick so the
    feed-forward loop is responsive on traffic timescales.  An optional
    geo placement (duck-typed) composes propagation RTTs on top."""
    return NetMCPPlatform(
        servers,
        profiles=[L.ideal_profile() for _ in servers],
        scenario="ideal",
        seed=seed,
        horizon_s=horizon_s,
        dt_s=dt_s,
        geo=geo,
        device=device,
    )


def mega_fleet_index(
    n_servers: int,
    templates: Optional[Sequence[Server]] = None,
    seed: int = 0,
    weights_dtype: str = "float32",
):
    """Template-tiled index over ``n_servers`` instances of the canonical
    15-server pool (5 websearch + 10 distractor templates, round-robin).

    Returns a `core.mesh_routing.TiledFleetIndex`: BM25 weights stored once
    per template with expanded-corpus statistics, so building it costs
    O(templates), not O(n_servers).  ``weights_dtype`` ("float32" /
    "bfloat16" / "int8") rounds the weights once (`core.quantize`).
    """
    from repro_torch.core import dataset
    from repro_torch.core.mesh_routing import TiledFleetIndex

    if templates is None:
        templates = dataset.build_server_pool(seed=seed)
    tmap = np.arange(n_servers) % len(templates)
    return TiledFleetIndex(templates, tmap, weights_dtype=weights_dtype)


def telemetry_palette(n_templates: int = 16, seed: int = 0) -> list:
    """``n_templates`` latency profiles cycling through the five canonical
    network states (ideal / high-latency / high-jitter / fluctuating /
    outage), each jittered by numpy's ``default_rng(seed)``, so the palette
    equals the reference's."""
    rng = np.random.default_rng(seed)
    palette = []
    for i in range(n_templates):
        kind = i % 5
        if kind == 0:
            p = L.LatencyProfile(
                base_latency_ms=20.0 + 15.0 * rng.random(),
                std_dev_ms=3.0 + 4.0 * rng.random(),
            )
        elif kind == 1:
            p = L.LatencyProfile(base_latency_ms=250.0 + 150.0 * rng.random(), std_dev_ms=15.0)
        elif kind == 2:
            p = L.LatencyProfile(base_latency_ms=100.0, std_dev_ms=50.0 + 30.0 * rng.random())
        elif kind == 3:
            p = L.fluctuating_profile(
                base_ms=150.0, amplitude_ms=120.0, period_s=3600.0,
                phase=float(2.0 * np.pi * rng.random()),
            )
        else:
            p = L.outage_profile(probability=0.2 + 0.3 * rng.random())
        palette.append(p)
    return palette


def mega_platform(
    n_servers: int,
    n_tel_templates: int = 16,
    seed: int = 0,
    horizon_s: float = 900.0,
    dt_s: float = 1.0,
    device=None,
) -> NetMCPPlatform:
    """Tiled `NetMCPPlatform` for a mega fleet: traces synthesized once per
    telemetry template ([n_tel_templates, T]); servers map onto them with
    a stride co-prime to the description round-robin, so semantic ties and
    network ties decorrelate.  Storage is O(templates x T) + O(servers)."""
    palette = telemetry_palette(n_tel_templates, seed)
    # int64: the Knuth multiplier overflows 32-bit integers
    tel_map = (np.arange(n_servers, dtype=np.int64) * 2654435761) % n_tel_templates
    return NetMCPPlatform(
        servers=None,
        profiles=palette,
        template_map=tel_map,
        seed=seed,
        horizon_s=horizon_s,
        dt_s=dt_s,
        device=device,
    )
