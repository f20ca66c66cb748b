"""Fleets for traffic experiments, port of `repro.traffic` (fleet builders
only; the simulators come with a later slice of the port)."""
from repro_torch.traffic.fleet import mega_fleet_index, replica_fleet

__all__ = ["mega_fleet_index", "replica_fleet"]
