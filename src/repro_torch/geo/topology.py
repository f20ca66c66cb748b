"""Seeded multi-region WAN topology (the geographic layer of NetMCP), twin
of `repro.geo.topology`.

The paper frames production MCP fragility geographically: clients and MCP
servers live in *regions*, and the latency a client observes decomposes as

    observed latency = propagation RTT (client region -> server region)
                     + server-side QoS (queueing, congestion, outages)

This module models the first half.  A `WanTopology` is

  - a set of `Region`s drawn from a small cloud-style catalog
    (lat/lon for great-circle distances, a UTC offset for diurnal demand
    phase);
  - a set of undirected `WanLink`s between regions, each carrying a
    **great-circle-derived propagation RTT** plus one of the five
    canonical latency states of `core.latency` (ideal / high_latency /
    high_jitter / fluctuating / outage) as its time-varying jitter/loss
    overlay — the same profile machinery, reused per *edge* instead of
    per server;
  - shortest-path composition: the region->region RTT matrix at tick t is
    the all-pairs shortest path over the link weights at t
    (Floyd-Warshall), so a congested direct link can be routed around via
    an intermediate region, exactly like real WAN backbones.

Everything is seeded and deterministic.  Link states and profiles come
from numpy's ``default_rng(seed)`` and equal the reference's; the [E, T]
link overlays go through `core.latency.generate_traces_cached`, drawn on
``device`` (the card by default) from a `torch.Generator`, so the same
(regions, links, seed, horizon, device type) always gives byte-identical
overlays (not the reference's stream).  The edge weights and the per-tick
Floyd-Warshall stay f64 numpy on the host, as in the reference (R <= 8).

Invariants:

  - RTT matrices are symmetric with a zero diagonal and nonnegative;
  - `path_rtt_ms` is monotone in the path: appending a hop never reduces
    the RTT (all link weights and the per-hop overhead are nonnegative);
  - the shortest-path matrix satisfies the triangle inequality.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import latency as L

# Speed of light in fiber is ~2/3 c: ~204 km per ms one-way.  Real WAN
# paths are not great circles (cable routes, detours), so the distance is
# inflated before conversion.
FIBER_KM_PER_MS = 204.0
ROUTE_INFLATION = 1.3
# Fixed per-link overhead (routers, amplification, transit handoff), ms.
HOP_OVERHEAD_MS = 2.0


@dataclasses.dataclass(frozen=True)
class Region:
    """One deployment region: a name, coordinates and a demand timezone."""

    name: str
    lat_deg: float
    lon_deg: float
    tz_offset_h: float            # UTC offset driving the diurnal phase


# Cloud-style catalog (coordinates are metro approximations).  Topologies
# take the first `n_regions` entries, so region indices are stable across
# seeds — fixtures and tests can name regions by position.
REGION_CATALOG: tuple = (
    Region("us-east", 39.0, -77.5, -5.0),
    Region("eu-west", 53.3, -6.3, 0.0),
    Region("ap-northeast", 35.7, 139.7, 9.0),
    Region("us-west", 37.4, -122.1, -8.0),
    Region("ap-south", 19.1, 72.9, 5.5),
    Region("sa-east", -23.5, -46.6, -3.0),
    Region("eu-central", 50.1, 8.7, 1.0),
    Region("af-south", -33.9, 18.4, 2.0),
)


def great_circle_km(a: Region, b: Region) -> float:
    """Haversine distance between two regions in km."""
    r_earth = 6371.0
    la1, lo1, la2, lo2 = map(
        np.radians, (a.lat_deg, a.lon_deg, b.lat_deg, b.lon_deg)
    )
    h = (
        np.sin((la2 - la1) / 2.0) ** 2
        + np.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2.0) ** 2
    )
    return float(2.0 * r_earth * np.arcsin(np.sqrt(h)))


def propagation_rtt_ms(distance_km: float) -> float:
    """Great-circle distance -> fiber propagation round-trip time (ms)."""
    one_way_ms = distance_km * ROUTE_INFLATION / FIBER_KM_PER_MS
    return 2.0 * one_way_ms


# The five canonical latency states, reused as per-link jitter/loss
# overlays.  A link's time-varying weight is base_rtt + overlay(t): the
# outage state models loss/brownout windows (the overlay pins at its
# severity, making the link transiently unusable so traffic re-routes).
LINK_STATES: tuple = (
    "ideal", "fluctuating", "high_jitter", "high_latency", "outage"
)


def _link_profile(state: str, rng: np.random.Generator) -> L.LatencyProfile:
    """A per-link overlay profile: the canonical state's shape, scaled to
    WAN-overlay magnitudes and phase-jittered by the topology seed."""
    if state == "ideal":
        return L.LatencyProfile(base_latency_ms=3.0, std_dev_ms=0.5)
    if state == "high_latency":
        return L.LatencyProfile(
            base_latency_ms=60.0 + 30.0 * rng.random(), std_dev_ms=4.0
        )
    if state == "high_jitter":
        return L.LatencyProfile(
            base_latency_ms=15.0, std_dev_ms=12.0 + 6.0 * rng.random()
        )
    if state == "fluctuating":
        return L.fluctuating_profile(
            base_ms=25.0, amplitude_ms=20.0, period_s=3600.0,
            phase=float(2.0 * np.pi * rng.random()), std_ms=3.0,
        )
    if state == "outage":
        return L.outage_profile(
            base_ms=3.0, std_ms=0.5, probability=0.15 + 0.15 * rng.random(),
            duration_min_s=10 * 60.0, duration_max_s=30 * 60.0,
        )
    raise KeyError(f"unknown link state {state!r}")


@dataclasses.dataclass(frozen=True)
class WanLink:
    """One undirected inter-region backbone link."""

    a: int                        # region index
    b: int                        # region index
    base_rtt_ms: float            # great-circle propagation RTT
    state: str                    # canonical latency state of the overlay
    profile: L.LatencyProfile     # the overlay's synthesis profile


class WanTopology:
    """Region graph with time-varying shortest-path RTT composition.

    Parameters
    ----------
    regions : Sequence[Region]
    links : Sequence[WanLink]
        Must connect the graph (checked on the base RTT matrix).
    seed : int
        Link-overlay trace synthesis seed (deterministic/memoized).
    device : torch.device or str, optional
        Where the overlays are synthesized (None: the card).
    horizon_s, dt_s : float
        Overlay trace horizon and tick, matching the platform's
        conventions (`core.latency` defaults).
    rtt_scale : float
        Multiplies every *total* edge cost (propagation + overlay + hop
        overhead).  0.0 collapses the topology to a single site — every
        RTT exactly 0, so SONAR-GEO is byte-identical to SONAR-LB.
    """

    def __init__(
        self,
        regions: Sequence[Region],
        links: Sequence[WanLink],
        seed: int = 0,
        horizon_s: float = L.DEFAULT_HORIZON_S,
        dt_s: float = L.DEFAULT_DT_S,
        rtt_scale: float = 1.0,
        device=None,
    ):
        self.regions = list(regions)
        self.links = list(links)
        self.seed = int(seed)
        self.dt_s = float(dt_s)
        self.rtt_scale = float(rtt_scale)
        if self.rtt_scale < 0.0:
            raise ValueError(f"rtt_scale must be >= 0, not {rtt_scale}")
        self.n_steps = L.trace_horizon_steps(horizon_s, dt_s)
        self.n_regions = len(self.regions)
        for ln in self.links:
            if not (0 <= ln.a < self.n_regions and 0 <= ln.b < self.n_regions):
                raise ValueError(f"link {ln.a}-{ln.b} names a region outside 0..{self.n_regions - 1}")
            if ln.a == ln.b:
                raise ValueError("self-links are not meaningful")
            if ln.base_rtt_ms < 0.0:
                raise ValueError(f"link {ln.a}-{ln.b} has a negative base RTT")
        # [E, n_steps] per-link overlay traces (memoized synthesis)
        packed = L.pack_profiles([ln.profile for ln in self.links]) if self.links else None
        self._overlays = (
            L.generate_traces_cached(self.seed, packed, self.n_steps, dt_s, device=device)
            if self.links else np.zeros((0, self.n_steps), np.float32)
        )
        self._rtt_cache: dict = {}
        base = self.rtt_matrix(None)
        if not np.all(np.isfinite(base)):
            raise ValueError("region graph is disconnected: some region pair has no path")

    # -- edge weights --------------------------------------------------------
    def edge_weights(self, t_idx: Optional[int] = None) -> np.ndarray:
        """f32 [R, R] direct-link weight matrix at tick t: base propagation
        RTT + overlay(t) + the per-hop overhead; +inf where no link exists,
        0 on the diagonal.  ``t_idx=None`` uses each overlay's *static*
        component (the profile base latency) — the deterministic baseline
        the golden fixtures freeze."""
        w = np.full((self.n_regions, self.n_regions), np.inf, np.float32)
        np.fill_diagonal(w, 0.0)
        for e, ln in enumerate(self.links):
            if t_idx is None:
                overlay = float(ln.profile.base_latency_ms)
            else:
                t = int(np.clip(t_idx, 0, self.n_steps - 1))
                overlay = float(self._overlays[e, t])
            cost = self.rtt_scale * (
                ln.base_rtt_ms + overlay + HOP_OVERHEAD_MS
            )
            w[ln.a, ln.b] = min(w[ln.a, ln.b], cost)
            w[ln.b, ln.a] = w[ln.a, ln.b]
        return w

    # -- composition ---------------------------------------------------------
    def rtt_matrix(self, t_idx: Optional[int] = None) -> np.ndarray:
        """f32 [R, R] all-pairs shortest-path RTT at tick t
        (Floyd-Warshall over `edge_weights`).  Symmetric, zero diagonal,
        monotone under hop composition.  Cached per tick."""
        key = -1 if t_idx is None else int(np.clip(t_idx, 0, self.n_steps - 1))
        hit = self._rtt_cache.get(key)
        if hit is not None:
            return hit
        d = self.edge_weights(None if key == -1 else key).astype(np.float64)
        for k in range(self.n_regions):
            d = np.minimum(d, d[:, k : k + 1] + d[k : k + 1, :])
        out = d.astype(np.float32)
        out.setflags(write=False)
        self._rtt_cache[key] = out
        return out

    def path_rtt_ms(
        self, path: Sequence[int], t_idx: Optional[int] = None
    ) -> float:
        """RTT of one explicit region path (sum of its link weights).
        Monotone: extending the path never reduces the total, since every
        link weight (propagation + overlay + hop overhead) is
        nonnegative.  Returns inf if a consecutive pair has no link."""
        w = self.edge_weights(t_idx)
        total = 0.0
        for a, b in zip(path[:-1], path[1:]):
            total += float(w[a, b])
        return total

    def tz_phase(self, region_idx: int, period_s: float = 24 * 3600.0) -> float:
        """Diurnal phase offset (radians) of a region's local timezone:
        two regions 12 h apart peak in antiphase."""
        frac = self.regions[region_idx].tz_offset_h * 3600.0 / period_s
        return float(2.0 * np.pi * frac)


def build_topology(
    n_regions: int = 4,
    seed: int = 0,
    horizon_s: float = L.DEFAULT_HORIZON_S,
    dt_s: float = L.DEFAULT_DT_S,
    link_states: Optional[Sequence[str]] = None,
    rtt_scale: float = 1.0,
    device=None,
) -> WanTopology:
    """Canonical seeded topology: the first `n_regions` catalog regions,
    fully meshed with great-circle backbone links whose overlay states
    cycle through `link_states` (default: the five canonical states),
    phase/intensity-jittered by `seed`.  ``rtt_scale`` multiplies every
    total edge cost (propagation + overlay + hop overhead) — the knob the
    geo benchmark sweeps to move from a collapsed single-site topology
    (0.0: every RTT exactly zero, SONAR-GEO byte-identical to SONAR-LB)
    to an RTT-dominated WAN.  ``device`` is where the link overlays are
    synthesized (None: the card)."""
    if not 2 <= n_regions <= len(REGION_CATALOG):
        raise ValueError(f"n_regions must be in 2..{len(REGION_CATALOG)}, not {n_regions}")
    regions = list(REGION_CATALOG[:n_regions])
    states = list(link_states) if link_states is not None else list(LINK_STATES)
    rng = np.random.default_rng(seed)
    links, e = [], 0
    for i in range(n_regions):
        for j in range(i + 1, n_regions):
            base = propagation_rtt_ms(great_circle_km(regions[i], regions[j]))
            links.append(
                WanLink(
                    a=i, b=j, base_rtt_ms=base,
                    state=states[e % len(states)],
                    profile=_link_profile(states[e % len(states)], rng),
                )
            )
            e += 1
    return WanTopology(
        regions, links, seed=seed, horizon_s=horizon_s, dt_s=dt_s,
        rtt_scale=rtt_scale, device=device,
    )
