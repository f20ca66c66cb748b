"""Multi-region WAN layer, twin of `repro.geo`: regions, great-circle
propagation RTTs, per-link latency states, server placement maps, client
populations and region-tagged demand, the geographic scenario axis behind
SONAR-GEO (``core.routing.SonarGeoRouter``).  Link overlays are drawn on
the card unless ``device="cpu"`` is asked for."""
from repro_torch.geo.placement import (
    GeoPlacement,
    client_populations,
    place_servers,
    regional_arrivals,
)
from repro_torch.geo.topology import (
    FIBER_KM_PER_MS,
    HOP_OVERHEAD_MS,
    LINK_STATES,
    REGION_CATALOG,
    ROUTE_INFLATION,
    Region,
    WanLink,
    WanTopology,
    build_topology,
    great_circle_km,
    propagation_rtt_ms,
)

__all__ = [
    "FIBER_KM_PER_MS",
    "HOP_OVERHEAD_MS",
    "LINK_STATES",
    "REGION_CATALOG",
    "ROUTE_INFLATION",
    "GeoPlacement",
    "Region",
    "WanLink",
    "WanTopology",
    "build_topology",
    "client_populations",
    "great_circle_km",
    "place_servers",
    "propagation_rtt_ms",
    "regional_arrivals",
]
