"""Server placement, client populations and region-tagged demand, twin of
`repro.geo.placement`.

`GeoPlacement` binds a `WanTopology` to a concrete fleet:

  - ``server_region`` [n_servers] — which region hosts each server.  The
    map is just an int array, so it composes with *any* fleet
    representation: materialized `Server` pools, template-tiled
    `TiledFleetIndex` mega-fleets (placement is independent of the
    description templates) and the chaos subsystem (a region maps to a
    server tuple that a `PartitionFault` takes verbatim).
  - ``client_weights`` [n_regions] — the client population split driving
    region-tagged arrivals.
  - the **region->server RTT matrix** [n_regions, n_servers]: the
    topology's region->region shortest-path RTT gathered through the
    placement map.  This is exactly the `region_rtt_ms` input of the
    batched/sharded SONAR-GEO engines and the source of the per-request
    ``client_rtt_ms`` rows the scalar router consumes.

Region-tagged arrivals (`regional_arrivals`): each region emits a diurnal
Poisson stream at its population share of the total rate, with the
sinusoidal phase offset by the region's *timezone* — us-east peaks while
ap-northeast sleeps — and the merged stream carries a per-arrival region
tag for the traffic simulator.  The streams are drawn from one
`torch.Generator`, region after region (the reference folds its key per
region).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.geo.topology import WanTopology

__all__ = [
    "GeoPlacement",
    "place_servers",
    "client_populations",
    "regional_arrivals",
]


def place_servers(
    n_servers: int,
    n_regions: int,
    seed: int = 0,
    skew: float = 0.0,
) -> np.ndarray:
    """i32 [n_servers] region assignment.

    ``skew=0`` is a balanced round-robin (every region gets within one
    server of n/R); larger skew concentrates capacity Zipf-style on the
    low-index regions (region r's share ~ (r+1)^-skew), with at least one
    server per region whenever n_servers >= n_regions.  Seeded and
    deterministic.
    """
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, not {n_regions}")
    if skew <= 0.0:
        return (np.arange(n_servers) % n_regions).astype(np.int32)
    w = (1.0 + np.arange(n_regions)) ** (-float(skew))
    w = w / w.sum()
    counts = np.floor(w * n_servers).astype(np.int64)
    if n_servers >= n_regions:
        counts = np.maximum(counts, 1)
    rng = np.random.default_rng(seed)
    while counts.sum() > n_servers:
        counts[int(np.argmax(counts))] -= 1
    while counts.sum() < n_servers:
        counts[int(rng.integers(n_regions))] += 1
    out = np.repeat(np.arange(n_regions), counts).astype(np.int32)
    return out[:n_servers]


def client_populations(
    n_regions: int, skew: float = 0.0
) -> np.ndarray:
    """f32 [n_regions] normalized client-population weights; ``skew=0`` is
    uniform, larger skew concentrates demand Zipf-style on region 0 (the
    'most clients sit far from most capacity' stress case when combined
    with a balanced server placement)."""
    w = (1.0 + np.arange(n_regions)) ** (-float(max(skew, 0.0)))
    w = w / w.sum()
    return w.astype(np.float32)


@dataclasses.dataclass
class GeoPlacement:
    """A fleet placed onto a WAN topology.

    Attributes
    ----------
    topology : WanTopology
    server_region : np.ndarray
        i32 [n_servers].
    client_weights : np.ndarray
        f32 [n_regions], normalized (defaults to uniform).
    """

    topology: WanTopology
    server_region: np.ndarray
    client_weights: Optional[np.ndarray] = None

    def __post_init__(self):
        self.server_region = np.asarray(self.server_region, np.int32)
        R = self.topology.n_regions
        if self.server_region.min() < 0 or self.server_region.max() >= R:
            raise ValueError(f"server regions must lie in 0..{R - 1}")
        if self.client_weights is None:
            self.client_weights = np.full(R, 1.0 / R, np.float32)
        self.client_weights = np.asarray(self.client_weights, np.float32)
        if self.client_weights.shape != (R,):
            raise ValueError(f"client weights of shape {self.client_weights.shape}, not ({R},)")

    @property
    def n_servers(self) -> int:
        return int(self.server_region.size)

    @property
    def n_regions(self) -> int:
        return self.topology.n_regions

    # -- RTT views -----------------------------------------------------------
    def region_server_rtt(self, t_idx: Optional[int] = None) -> np.ndarray:
        """f32 [n_regions, n_servers] — the region->server propagation RTT
        matrix at tick t (None: static baseline).  Row r is the
        ``client_rtt_ms`` vector of a client in region r; the whole matrix
        is the ``region_rtt_ms`` input of the batched/sharded engines."""
        return self.topology.rtt_matrix(t_idx)[:, self.server_region]

    def client_rtt_ms(
        self, client_region: int, t_idx: Optional[int] = None
    ) -> np.ndarray:
        """f32 [n_servers] — RTT row of one client region.  Indexes the
        cached [R, R] matrix row directly (O(n_servers)); the traffic
        simulator calls this once per dispatch, so materializing the full
        [R, n_servers] gather here would cost O(R * n_servers) per routed
        request at mega-fleet scale."""
        row = self.topology.rtt_matrix(t_idx)[int(client_region)]
        return row[self.server_region]

    # -- composition with the chaos subsystem --------------------------------
    def region_servers(self, region_idx: int) -> tuple:
        """Server ids hosted in one region (a chaos fault group)."""
        return tuple(
            int(s) for s in np.flatnonzero(self.server_region == region_idx)
        )

    def regional_partition(
        self, region_idx: int, start_s: float, duration_s: float
    ):
        """A chaos `PartitionFault` taking the whole region down together
        (shared-zone failure) — the geo layer's fault group composed
        directly from the placement map."""
        from repro_torch.chaos.faults import PartitionFault

        return PartitionFault(
            servers=self.region_servers(region_idx),
            start_s=float(start_s),
            duration_s=float(duration_s),
        )


def regional_arrivals(
    gen: torch.Generator,
    placement: GeoPlacement,
    rate_rps: float,
    horizon_s: float,
    depth: float = 0.6,
    period_s: float = 24 * 3600.0,
) -> tuple:
    """Region-tagged diurnal demand over the placement's client split.

    Each region r emits an independent diurnal Poisson stream at
    ``rate_rps * client_weights[r]`` whose sinusoidal modulation is
    phase-shifted by the region's timezone (`WanTopology.tz_phase`), so
    global demand follows the sun.  The regions draw from ``gen`` in index
    order; streams are merged and sorted.

    Returns
    -------
    (arrivals_s, regions) : (f64 [n], i32 [n])
        Sorted arrival times (seconds) and the originating client region
        of each arrival — the ``regions`` argument of
        `FleetTrafficSim.run`.
    """
    from repro_torch.traffic.arrivals import diurnal_arrivals

    times, tags = [], []
    for r in range(placement.n_regions):
        w = float(placement.client_weights[r])
        if w <= 0.0:
            continue
        t = diurnal_arrivals(
            gen,
            rate_rps * w,
            horizon_s,
            depth=depth,
            period_s=period_s,
            phase=placement.topology.tz_phase(r, period_s),
        )
        times.append(t)
        tags.append(np.full(t.size, r, np.int32))
    if not times:
        return np.zeros((0,), np.float64), np.zeros((0,), np.int32)
    times_all = np.concatenate(times)
    tags_all = np.concatenate(tags)
    order = np.argsort(times_all, kind="stable")
    return times_all[order], tags_all[order]
