"""Compiled fault schedules and their injection into platform state, twin
of `repro.chaos.schedule`.

``build_schedule`` compiles a list of fault specs (``repro_torch.chaos.faults``)
into a ``ChaosSchedule`` — three dense per-(server, tick) arrays:

  down     bool [n, T]   server is dead: calls fail, latency pinned at
                         ``severity_ms`` (the paper's offline clamp)
  degrade  f32  [n, T]   multiplicative latency inflation (>= 1)
  stale    bool [n, T]   telemetry frozen: the observed history holds the
                         last fresh sample and feed-forward writes drop

The schedule then injects into both execution backends:

  - the static trace platform (``core.platform.NetMCPPlatform``) applies
    ``apply_to_traces`` to its ground-truth traces and ``apply_staleness``
    to the observed histories routers consume, and gates
    ``record_observation`` on the stale mask;
  - the discrete-event traffic simulator (``traffic.simulator``) consults
    ``alive_at`` on dispatch/finish so crashed stations reject work and
    kill in-flight service.

``standard_fault_mix`` builds the canonical benchmark mix (crash/restart +
partition + flapping + degradation-under-blackout) parameterized by a
single intensity knob, as ``benchmarks/chaos_recovery.py`` uses it.

The masks are host numpy, as in the reference.  The crash/restart draws
come from one `torch.Generator` per fault on ``device`` (the card by
default), seeded from ``(seed, fault index)``: a fault's draws do not
depend on the faults listed before it, as with the reference's
``fold_in``, but the streams are not the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chaos.faults import (
    CrashRestartFault,
    DegradationFault,
    FlappingFault,
    PartitionFault,
    TelemetryBlackoutFault,
    crash_restart_masks,
    degradation_factor,
    flapping_mask,
    window_mask,
)
from repro_torch.core.latency import OFFLINE_MS


@dataclasses.dataclass
class ChaosSchedule:
    """Dense fault state for one fleet over one horizon."""

    down: np.ndarray          # bool [n_servers, n_steps]
    degrade: np.ndarray       # f32  [n_servers, n_steps], >= 1
    stale: np.ndarray         # bool [n_servers, n_steps]
    dt_s: float
    severity_ms: float = OFFLINE_MS

    def __post_init__(self):
        if not self.down.shape == self.degrade.shape == self.stale.shape:
            raise ValueError(
                f"mask shapes differ: down {self.down.shape}, degrade "
                f"{self.degrade.shape}, stale {self.stale.shape}"
            )
        # last fresh tick <= t per (server, t): the index the frozen
        # telemetry replays and the age the staleness discount decays with
        idx = np.arange(self.n_steps)[None, :]
        fresh = np.where(~self.stale, idx, -1)
        self._fresh_idx = np.maximum(np.maximum.accumulate(fresh, axis=1), 0)

    @property
    def n_servers(self) -> int:
        return self.down.shape[0]

    @property
    def n_steps(self) -> int:
        return self.down.shape[1]

    def _clip(self, t_idx) -> np.ndarray:
        return np.clip(np.asarray(t_idx, np.int64), 0, self.n_steps - 1)

    # -- injection into the trace platform ----------------------------------
    def apply_to_traces(self, traces: np.ndarray) -> np.ndarray:
        """Ground-truth latency with faults injected: degradation multiplies,
        downtime pins at `severity_ms` (>= the offline clamp)."""
        lat = np.asarray(traces, np.float32) * self.degrade
        return np.where(self.down, np.maximum(lat, self.severity_ms), lat)

    def apply_staleness(self, traces: np.ndarray) -> np.ndarray:
        """What monitoring *observes*: during a blackout each server's
        history replays its last fresh sample while the ground truth moves
        on — 'observed history stops updating while the server keeps
        degrading'."""
        return np.take_along_axis(
            np.asarray(traces, np.float32), self._fresh_idx, axis=1
        )

    # -- queries -------------------------------------------------------------
    def alive_at(self, t_idx: int) -> np.ndarray:
        """bool [n_servers]: which servers answer at tick t."""
        return ~self.down[:, int(self._clip(t_idx))]

    def stale_at(self, server_idx: int, t_idx: int) -> bool:
        return bool(self.stale[server_idx, int(self._clip(t_idx))])

    def age_s(self, t_idx: int) -> np.ndarray:
        """f32 [n_servers]: telemetry age (seconds since the last fresh
        sample) at tick t.  Zero everywhere outside blackouts."""
        t = int(self._clip(t_idx))
        return ((t - self._fresh_idx[:, t]) * self.dt_s).astype(np.float32)

    def ages_s(self, t_indices) -> np.ndarray:
        """f32 [len(t), n_servers] — vectorized `age_s`."""
        t = self._clip(t_indices)
        return ((t[:, None] - self._fresh_idx[:, t].T) * self.dt_s).astype(
            np.float32
        )


def fault_generator(seed: int, fault_index: int, device) -> torch.Generator:
    """The generator of one fault: seeded from ``(seed, fault_index)``
    through numpy's `SeedSequence`, so each fault has its own stream."""
    state = np.random.SeedSequence([int(seed) % 2**63, int(fault_index)]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def build_schedule(
    faults: Sequence,
    n_servers: int,
    n_steps: int,
    dt_s: float,
    seed: int = 0,
    severity_ms: float = OFFLINE_MS,
    device=None,
) -> ChaosSchedule:
    """Compile fault specs into dense per-(server, tick) masks.

    Parameters
    ----------
    faults : Sequence
        Fault specs from `repro_torch.chaos.faults` (crash/restart, degradation,
        partition, flapping, blackout).
    n_servers : int
        Fleet size; mask rows.
    n_steps : int
        Trace horizon in ticks; mask columns.
    dt_s : float
        Seconds per tick (fault durations in specs are **seconds** and are
        converted to ticks here).
    seed : int
        Stochastic faults draw from a generator seeded from (seed, fault
        index) (`fault_generator`), so schedules are reproducible and
        independent of spec-list mutations elsewhere; the same (faults,
        seed, device type) always compiles the same schedule.
    severity_ms : float
        Latency (ms) pinned onto downed servers (default: the offline
        clamp).
    device : torch.device or str, optional
        Where the crash/restart draws and recurrence run (None: the card).

    Returns
    -------
    ChaosSchedule
        ``down``/``stale`` bool [n_servers, n_steps] and ``degrade`` f32
        multipliers, plus the alive/age query helpers the platform and
        simulator consume.
    """
    down = np.zeros((n_servers, n_steps), bool)
    degrade = np.ones((n_servers, n_steps), np.float32)
    stale = np.zeros((n_servers, n_steps), bool)
    dev = resolve_device(device)

    for fi, fault in enumerate(faults):
        srv = list(fault.servers)
        if any(s < 0 or s >= n_servers for s in srv):
            raise ValueError(
                f"fault #{fi} targets servers {srv} outside 0..{n_servers - 1}"
            )
        if isinstance(fault, CrashRestartFault):
            masks = crash_restart_masks(
                fault_generator(seed, fi, dev), fault, n_steps, dt_s
            )
            down[srv] |= masks
        elif isinstance(fault, PartitionFault):
            w = window_mask(
                n_steps, dt_s, fault.start_s, fault.start_s + fault.duration_s
            )
            down[srv] |= w[None, :]
        elif isinstance(fault, FlappingFault):
            down[srv] |= flapping_mask(fault, n_steps, dt_s)[None, :]
        elif isinstance(fault, DegradationFault):
            factor = degradation_factor(fault, n_steps, dt_s)
            degrade[srv] = np.maximum(degrade[srv], factor[None, :])
        elif isinstance(fault, TelemetryBlackoutFault):
            w = window_mask(
                n_steps, dt_s, fault.start_s, fault.start_s + fault.duration_s
            )
            stale[srv] |= w[None, :]
        else:
            raise TypeError(f"unknown fault spec: {type(fault).__name__}")

    return ChaosSchedule(
        down=down, degrade=degrade, stale=stale,
        dt_s=dt_s, severity_ms=severity_ms,
    )


def standard_fault_mix(
    intensity: float,
    n_servers: int,
    horizon_s: float,
) -> list:
    """The canonical chaos scenario at `intensity` in [0, 1]; empty at 0.
    The spec geometry is deterministic in its arguments; stochastic draws
    (crash/restart timing) happen in `build_schedule`, keyed by its seed.

    Exercises every fault model at once, arranged adversarially for
    telemetry-trusting routers:

      - a correlated partition takes down the group containing server 0
        (the semantically top-ranked pick on an identical-replica fleet)
        mid-horizon, *under a telemetry blackout* that starts just before
        it — monitoring keeps replaying healthy samples and feed-forward
        failure recordings are dropped, so a stale-blind router re-picks
        the dead group every retry;
      - crash/restart churn (shrinking MTTF with intensity) on the next
        servers — visible to telemetry, testing ordinary avoidance;
      - one flapping server and one gradually-degrading server whose decay
        is hidden behind its own blackout.
    """
    if intensity <= 0.0 or n_servers < 2:
        return []
    x = float(np.clip(intensity, 0.0, 1.0))
    group = tuple(range(0, max(n_servers // 3, 1)))          # region incl. 0
    part_start = 0.40 * horizon_s
    part_dur = (0.10 + 0.20 * x) * horizon_s
    faults: list = [
        PartitionFault(servers=group, start_s=part_start, duration_s=part_dur),
        TelemetryBlackoutFault(
            servers=group,
            start_s=part_start - 0.05 * horizon_s,
            duration_s=part_dur + 0.10 * horizon_s,
        ),
    ]
    n_crash = int(round(x * max((n_servers - len(group) - 2), 0)))
    crash = tuple(range(len(group), len(group) + n_crash))
    if crash:
        faults.append(
            CrashRestartFault(
                servers=crash,
                mttf_s=(0.5 - 0.3 * x) * horizon_s,
                mttr_s=0.04 * horizon_s,
            )
        )
    if n_servers - 2 >= len(group) + n_crash:
        faults.append(
            FlappingFault(
                servers=(n_servers - 2,),
                period_s=max(0.02 * horizon_s, 4.0),
                duty=0.3 + 0.3 * x,
                start_s=0.65 * horizon_s,
            )
        )
    if n_servers - 1 >= len(group) + n_crash:
        deg_start = 0.10 * horizon_s
        faults.append(
            DegradationFault(
                servers=(n_servers - 1,),
                start_s=deg_start,
                ramp_s=0.30 * horizon_s,
                max_factor=2.0 + 6.0 * x,
            )
        )
        faults.append(
            TelemetryBlackoutFault(
                servers=(n_servers - 1,),
                start_s=deg_start,
                duration_s=0.70 * horizon_s,
            )
        )
    return faults
