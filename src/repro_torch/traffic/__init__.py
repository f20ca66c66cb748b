"""Fleet traffic, twin of `repro.traffic`: fleet and platform builders,
open-loop arrival processes, per-server queueing stations, the
discrete-event simulator that closes the load->latency loop around the
routing stack, and the live request sources the serving front-ends
replay."""
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
from repro_torch.traffic.queueing import QueueConfig, ServerQueue
from repro_torch.traffic.simulator import FleetTrafficSim, Request, TrafficReport
from repro_torch.traffic.source import LiveRequest, request_schedule

__all__ = [
    "ARRIVAL_PROCESSES",
    "FleetTrafficSim",
    "LiveRequest",
    "QueueConfig",
    "Request",
    "ServerQueue",
    "TrafficReport",
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
