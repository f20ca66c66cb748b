"""Fleet traffic, twin of `repro.traffic`: fleet and platform builders,
open-loop arrival processes and the live request sources the serving
front-ends replay.  The queueing stations and the discrete-event simulator
are `ROADMAP.md` queue 1, item 8."""
from repro_torch.traffic.arrivals import (
    ARRIVAL_PROCESSES,
    diurnal_arrivals,
    flash_crowd_arrivals,
    merge_arrivals,
    mmpp_arrivals,
    poisson_arrivals,
    thinned_arrivals,
)
from repro_torch.traffic.fleet import (
    ideal_platform,
    mega_fleet_index,
    mega_platform,
    replica_fleet,
    telemetry_palette,
)
from repro_torch.traffic.source import LiveRequest, request_schedule

__all__ = [
    "ARRIVAL_PROCESSES",
    "LiveRequest",
    "diurnal_arrivals",
    "flash_crowd_arrivals",
    "ideal_platform",
    "mega_fleet_index",
    "mega_platform",
    "merge_arrivals",
    "mmpp_arrivals",
    "poisson_arrivals",
    "replica_fleet",
    "request_schedule",
    "telemetry_palette",
    "thinned_arrivals",
]
