"""Fault models for the chaos-injection subsystem, twin of `repro.chaos.faults`.

Each fault is a frozen spec compiled into deterministic per-(server, tick)
masks by ``repro_torch.chaos.schedule.build_schedule``:

  CrashRestartFault      — two-state semi-Markov crash/repair process with
                           exponential MTTF/MTTR; the server is hard-down
                           while crashed.
  DegradationFault       — latency multiplied by a factor that ramps
                           linearly from 1 to ``max_factor`` over
                           ``ramp_s``, optionally restored at ``end_s``.
  PartitionFault         — a whole server group goes down together for one
                           interval.
  FlappingFault          — square wave with ``period_s`` and ``duty``
                           fraction spent down.
  TelemetryBlackoutFault — the observed history freezes at the last fresh
                           sample while the server keeps running;
                           feed-forward writes during the blackout drop.

The clock-driven masks are host numpy and equal the reference's.  The
crash/restart process draws its randomness from a `torch.Generator` on the
generator's device (the card by default): every step's entry uniform and
repair exponential are drawn up front, and `crash_restart_recurrence` runs
the reference's per-step rule over time on the fault's rows.  The
reference draws from `jax.random` keys split per server and per step;
those streams cannot be reproduced, so the recurrence takes its draws as
arguments and a parity test feeds it the reference's own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CrashRestartFault:
    """Exponential MTTF/MTTR crash-restart process on each listed server."""

    servers: Tuple[int, ...]
    mttf_s: float                   # mean time to failure (up-dwell)
    mttr_s: float                   # mean time to repair (down-dwell)
    start_s: float = 0.0            # no crashes before this time


@dataclasses.dataclass(frozen=True)
class DegradationFault:
    """Latency multiplier ramping 1 -> max_factor over [start, start+ramp]."""

    servers: Tuple[int, ...]
    start_s: float
    ramp_s: float
    max_factor: float = 4.0
    end_s: Optional[float] = None   # restored (factor 1) from here; None = never


@dataclasses.dataclass(frozen=True)
class PartitionFault:
    """Correlated regional partition: the whole group is down together."""

    servers: Tuple[int, ...]
    start_s: float
    duration_s: float


@dataclasses.dataclass(frozen=True)
class FlappingFault:
    """Square-wave up/down oscillation (duty = fraction of a period down)."""

    servers: Tuple[int, ...]
    period_s: float
    duty: float = 0.5
    start_s: float = 0.0
    end_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TelemetryBlackoutFault:
    """Observed history freezes for the window; the server keeps running."""

    servers: Tuple[int, ...]
    start_s: float
    duration_s: float


FAULT_KINDS = (
    CrashRestartFault,
    DegradationFault,
    PartitionFault,
    FlappingFault,
    TelemetryBlackoutFault,
)


# ---------------------------------------------------------------------------
# Stochastic mask synthesis
# ---------------------------------------------------------------------------

def crash_restart_params(fault: CrashRestartFault, dt_s: float) -> tuple:
    """The recurrence's constants in f32, as the reference computes them:
    per-step hazard ``1 - exp(-dt / MTTF)``, mean repair in steps
    ``max(MTTR / dt, 1)`` and the first step index that may fail
    (``t >= start_s / dt`` compared in f32)."""
    mttf = torch.tensor(fault.mttf_s, dtype=torch.float32)
    mttr = torch.tensor(fault.mttr_s, dtype=torch.float32)
    hazard = 1.0 - torch.exp(-dt_s / torch.clamp_min(mttf, 1e-6))
    mean_repair_steps = torch.clamp_min(mttr / dt_s, 1.0)
    start_step = torch.tensor(fault.start_s / dt_s, dtype=torch.float32)
    return hazard, mean_repair_steps, start_step


def crash_restart_recurrence(
    u_enter: torch.Tensor,
    e_repair: torch.Tensor,
    hazard: torch.Tensor,
    mean_repair_steps: torch.Tensor,
    start_step: torch.Tensor,
) -> torch.Tensor:
    """The crash/repair on-off process of every row -> bool [rows, n_steps]
    (True = down), from its per-step draws ``u_enter`` (U[0, 1)) and
    ``e_repair`` (Exp(1)), both f32 [n_steps, rows] on one device.

    Up-dwell is geometric with per-step hazard (the discretized
    exponential); a crash draws its repair as ``max(e * mean_repair_steps,
    1)`` steps, so no down run is shorter than one tick.  Per step, as the
    reference's scan:

        fail      = remaining <= 0 and t >= start_step and u_enter < hazard
        remaining = repair if fail else max(remaining - 1, 0)
        down      = remaining > 0
    """
    n_steps, rows = u_enter.shape
    dev = u_enter.device
    hazard = hazard.to(dev)
    enter = u_enter < hazard
    repair = torch.clamp_min(e_repair * mean_repair_steps.to(dev), 1.0)
    steps = torch.arange(n_steps, dtype=torch.float32, device=dev)
    first = int(torch.count_nonzero(steps < start_step.to(dev)))
    down = torch.zeros((n_steps, rows), dtype=torch.bool, device=dev)
    remaining = torch.zeros(rows, dtype=torch.float32, device=dev)
    for t in range(first, n_steps):
        fail = (remaining <= 0.0) & enter[t]
        remaining = torch.where(fail, repair[t], torch.clamp_min(remaining - 1.0, 0.0))
        down[t] = remaining > 0.0
    return down.t()


def crash_restart_masks(
    gen: torch.Generator,
    fault: CrashRestartFault,
    n_steps: int,
    dt_s: float,
) -> np.ndarray:
    """Independent crash processes for every server of the fault, drawn on
    the generator's device -> host bool [len(servers), n_steps].  The
    entry uniforms [n_steps, rows] come first, then the repair
    exponentials of the same shape."""
    rows, dev = len(fault.servers), gen.device
    u_enter = torch.rand((n_steps, rows), generator=gen, device=dev)
    e_repair = torch.empty((n_steps, rows), dtype=torch.float32, device=dev)
    e_repair.exponential_(generator=gen)
    down = crash_restart_recurrence(u_enter, e_repair, *crash_restart_params(fault, dt_s))
    return down.cpu().numpy()


# ---------------------------------------------------------------------------
# Deterministic (clock-driven) masks
# ---------------------------------------------------------------------------

def window_mask(
    n_steps: int, dt_s: float, start_s: float, end_s: Optional[float]
) -> np.ndarray:
    """bool [n_steps]: True inside [start_s, end_s)."""
    t = np.arange(n_steps, dtype=np.float64) * dt_s
    m = t >= start_s
    if end_s is not None:
        m &= t < end_s
    return m


def flapping_mask(fault: FlappingFault, n_steps: int, dt_s: float) -> np.ndarray:
    """bool [n_steps]: down during the trailing `duty` fraction of each period."""
    t = np.arange(n_steps, dtype=np.float64) * dt_s
    active = window_mask(n_steps, dt_s, fault.start_s, fault.end_s)
    phase = np.mod(t - fault.start_s, fault.period_s) / fault.period_s
    duty = float(np.clip(fault.duty, 0.0, 1.0))
    return active & (phase >= 1.0 - duty)


def degradation_factor(
    fault: DegradationFault, n_steps: int, dt_s: float
) -> np.ndarray:
    """f32 [n_steps] latency multiplier: 1 -> max_factor over the ramp."""
    t = np.arange(n_steps, dtype=np.float64) * dt_s
    ramp = np.clip((t - fault.start_s) / max(fault.ramp_s, dt_s), 0.0, 1.0)
    factor = 1.0 + (fault.max_factor - 1.0) * ramp
    if fault.end_s is not None:
        factor = np.where(t >= fault.end_s, 1.0, factor)
    return factor.astype(np.float32)
