"""Canonical fleets for traffic experiments, port of `repro.traffic.fleet`.

A pool of *identical* websearch replicas is the adversarial case for
load-blind routing: semantic scores tie, QoS ties on a healthy network, so
argmax herds every request onto one replica.  A mega fleet (10^5-10^6
servers) tiles the canonical pool's templates and never densifies its
index.  Both are numpy and dataset code.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.dataset import WEBSEARCH, Server, Tool


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
