"""Chaos fault injection, twin of `repro.chaos`: fault models (crash/restart,
gradual degradation, correlated partitions, flapping, telemetry
blackouts) compiled into dense schedules that inject into both the static
trace platform and the discrete-event traffic simulator.  The
crash/restart draws run on a `torch.Generator` on the card unless
``device="cpu"`` is asked for."""
from repro_torch.chaos.faults import (
    FAULT_KINDS,
    CrashRestartFault,
    DegradationFault,
    FlappingFault,
    PartitionFault,
    TelemetryBlackoutFault,
)
from repro_torch.chaos.schedule import (
    ChaosSchedule,
    build_schedule,
    standard_fault_mix,
)

__all__ = [
    "FAULT_KINDS",
    "ChaosSchedule",
    "CrashRestartFault",
    "DegradationFault",
    "FlappingFault",
    "PartitionFault",
    "TelemetryBlackoutFault",
    "build_schedule",
    "standard_fault_mix",
]
