"""Network-state latency synthesis (NetMCP Module 2), twin of `repro.core.latency`.

Generates per-server historical latency traces for the five canonical
network states of the paper (Sec. III-A, Fig. 4):

  1. fluctuating  — sinusoidal load rhythm (amplitude/period/phase) + noise
  2. outage       — intermittent downtime intervals (prob/duration/severity)
  3. high_latency — elevated stable baseline (e.g. 350 ms, low variance)
  4. high_jitter  — moderate baseline, high Gaussian variance (e.g. 100±70 ms)
  5. ideal        — low stable baseline (e.g. 30±5 ms)

A whole fleet is synthesized in one call as tensor code on the device of
an explicit `torch.Generator` (the card by default).  The reference draws
from `jax.random`; those streams cannot be reproduced here, so the port's
traces are checked by the states' signatures, and parity tests hand both
packages the same arrays.  Traces are "historical": the platform
retrieves the prefix up to any time index t.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device

# Default simulation tick: one sample per 10 simulated seconds => a 24h trace
# is 8640 samples.  Matches the paper's "24h" horizon in Fig. 4.
DEFAULT_DT_S: float = 10.0
DEFAULT_HORIZON_S: float = 24 * 3600.0

# Latency (ms) above which a server counts as offline (paper Sec. III-A FR
# metric and Sec. IV-C hard clamp).
OFFLINE_MS: float = 1000.0
# Latency above which a sample counts as an outage-risk event (Sec. IV-C).
OUTAGE_RISK_MS: float = 800.0


@dataclasses.dataclass(frozen=True)
class LatencyProfile:
    """Configuration of one server's network behaviour (paper Fig. 4)."""

    base_latency_ms: float = 30.0
    std_dev_ms: float = 5.0
    # Periodic oscillation (fluctuating state); amplitude 0 disables.
    amplitude_ms: float = 0.0
    period_s: float = 3600.0
    phase_shift: float = 0.0
    # Intermittent outages; probability 0 disables.  `probability` is the
    # stationary fraction of time spent in outage; durations are drawn
    # uniformly from [duration_min_s, duration_max_s]; during an outage the
    # latency is pinned at `severity_ms`.
    outage_probability: float = 0.0
    outage_duration_min_s: float = 30 * 60.0
    outage_duration_max_s: float = 100 * 60.0
    outage_severity_ms: float = 1000.0
    # Floor so noise never produces negative latency.
    floor_ms: float = 1.0

    def as_array(self) -> np.ndarray:
        """Pack into a flat float32 vector (one row of a fleet's profiles)."""
        return np.array(
            [
                self.base_latency_ms,
                self.std_dev_ms,
                self.amplitude_ms,
                self.period_s,
                self.phase_shift,
                self.outage_probability,
                self.outage_duration_min_s,
                self.outage_duration_max_s,
                self.outage_severity_ms,
                self.floor_ms,
            ],
            dtype=np.float32,
        )


N_PROFILE_FIELDS = 10


# ---------------------------------------------------------------------------
# Named profile constructors for the five canonical states (paper defaults).
# ---------------------------------------------------------------------------

def ideal_profile() -> LatencyProfile:
    return LatencyProfile(base_latency_ms=30.0, std_dev_ms=5.0)


def high_latency_profile() -> LatencyProfile:
    return LatencyProfile(base_latency_ms=350.0, std_dev_ms=20.0)


def high_jitter_profile() -> LatencyProfile:
    return LatencyProfile(base_latency_ms=100.0, std_dev_ms=70.0)


def fluctuating_profile(
    base_ms: float = 150.0,
    amplitude_ms: float = 200.0,
    period_s: float = 3600.0,
    phase: float = 0.0,
    std_ms: float = 20.0,
) -> LatencyProfile:
    return LatencyProfile(
        base_latency_ms=base_ms,
        std_dev_ms=std_ms,
        amplitude_ms=amplitude_ms,
        period_s=period_s,
        phase_shift=phase,
    )


def outage_profile(
    base_ms: float = 30.0,
    std_ms: float = 5.0,
    probability: float = 0.5,
    duration_min_s: float = 30 * 60.0,
    duration_max_s: float = 100 * 60.0,
    severity_ms: float = 1000.0,
) -> LatencyProfile:
    return LatencyProfile(
        base_latency_ms=base_ms,
        std_dev_ms=std_ms,
        outage_probability=probability,
        outage_duration_min_s=duration_min_s,
        outage_duration_max_s=duration_max_s,
        outage_severity_ms=severity_ms,
    )


STATE_FACTORIES = {
    "ideal": ideal_profile,
    "high_latency": high_latency_profile,
    "high_jitter": high_jitter_profile,
    "fluctuating": fluctuating_profile,
    "outage": outage_profile,
}


# ---------------------------------------------------------------------------
# Trace synthesis
# ---------------------------------------------------------------------------

def _outage_mask(
    gen: torch.Generator, prof: torch.Tensor, n_steps: int, dt_s: float
) -> torch.Tensor:
    """Two-state semi-Markov on/off process per server, bool [n, n_steps],
    with the stationary ON-fraction equal to `probability` and uniform
    outage durations.

    The per-step hazard of *entering* an outage is chosen so that
    E[outage time] / E[cycle time] == probability.  The uniforms of every
    step are drawn up front ([n_steps, n] for the entry test and for the
    duration), then the recurrence runs over time on [n] vectors:

        start     = remaining <= 0 and u_enter < hazard
        remaining = new_dur if start else max(remaining - 1, 0)
        mask      = remaining > 0
    """
    probability = prof[:, 5]
    dur_min = torch.clamp_min(prof[:, 6] / dt_s, 1.0)
    dur_max = torch.maximum(prof[:, 7] / dt_s, dur_min)
    mean_dur = 0.5 * (dur_min + dur_max)
    # stationary fraction p = mean_dur / (mean_dur + mean_up)
    #  => mean_up = mean_dur * (1 - p) / p ;  hazard = 1 / mean_up
    p = torch.clamp(probability, 1e-6, 1.0 - 1e-6)
    hazard = p / (mean_dur * (1.0 - p))
    hazard = torch.where(
        probability <= 0.0, torch.zeros_like(hazard), torch.clamp(hazard, 0.0, 1.0)
    )
    n, dev = prof.shape[0], prof.device
    u_enter = torch.rand((n_steps, n), generator=gen, device=dev)
    u_dur = torch.rand((n_steps, n), generator=gen, device=dev)
    mask = torch.zeros((n_steps, n), dtype=torch.bool, device=dev)
    # rows with a zero hazard never enter an outage: the recurrence runs on
    # the others only (the draws above are made for every row, so a row's
    # stream does not depend on which rows can fail)
    rows = torch.nonzero(hazard > 0.0).flatten()
    if rows.numel():
        enter = u_enter[:, rows] < hazard[rows]
        lo, hi = dur_min[rows], dur_max[rows]
        new_dur = lo + u_dur[:, rows] * (hi - lo)
        remaining = torch.zeros(rows.numel(), dtype=torch.float32, device=dev)
        sub = torch.empty((n_steps, rows.numel()), dtype=torch.bool, device=dev)
        for t in range(n_steps):
            start = (remaining <= 0.0) & enter[t]
            remaining = torch.where(start, new_dur[t], torch.clamp_min(remaining - 1.0, 0.0))
            sub[t] = remaining > 0.0
        mask[:, rows] = sub
    return mask.t()


def generate_traces(
    gen: torch.Generator,
    profiles: torch.Tensor,
    n_steps: int,
    dt_s: float = DEFAULT_DT_S,
) -> torch.Tensor:
    """Synthesize traces for a fleet on the generator's device: profiles
    f32 [n, N_PROFILE_FIELDS] -> latencies f32 [n, n_steps] in ms."""
    prof = profiles.to(device=gen.device, dtype=torch.float32)
    n = prof.shape[0]
    t = torch.arange(n_steps, dtype=torch.float32, device=gen.device) * dt_s
    base, std = prof[:, 0:1], prof[:, 1:2]
    amplitude, period, phase = prof[:, 2:3], prof[:, 3:4], prof[:, 4:5]
    severity, floor = prof[:, 8:9], prof[:, 9:10]
    seasonal = amplitude * torch.sin(
        2.0 * math.pi * t[None, :] / torch.clamp_min(period, 1.0) + phase
    )
    noise = std * torch.randn((n, n_steps), generator=gen, device=gen.device)
    lat = base + seasonal + noise
    mask = _outage_mask(gen, prof, n_steps, dt_s)
    lat = torch.where(mask, severity, lat)
    return torch.maximum(lat, floor)


def generate_trace(
    gen: torch.Generator,
    profile: torch.Tensor,
    n_steps: int,
    dt_s: float = DEFAULT_DT_S,
) -> torch.Tensor:
    """Synthesize one latency trace [n_steps] (ms) from a packed profile."""
    return generate_traces(gen, profile.reshape(1, -1), n_steps, dt_s)[0]


# Host-side memo of synthesized fleets.  Platform and gateway construction
# is dominated by the outage recurrence; tests (and repeated sweeps)
# rebuild the same (seed, profiles, horizon, device type) fleets many
# times.  The device type is part of the key: a CUDA and a CPU generator
# give different streams for one seed, so a trace made on one is never
# served to a run on the other.  Entries are read-only; consumers copy
# before mutating (observed histories).
_TRACE_CACHE: dict = {}


def generate_traces_cached(
    seed: int,
    profiles_packed: np.ndarray,
    n_steps: int,
    dt_s: float = DEFAULT_DT_S,
    device=None,
) -> np.ndarray:
    """Traces of a packed fleet, synthesized on ``device`` (None: the
    card) from a generator seeded with ``seed``; host f32 [n, n_steps],
    read-only."""
    dev = resolve_device(device)
    profiles_packed = np.asarray(profiles_packed, np.float32)
    key = (int(seed), profiles_packed.tobytes(), int(n_steps), float(dt_s), dev.type)
    hit = _TRACE_CACHE.get(key)
    if hit is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        hit = generate_traces(gen, torch.from_numpy(profiles_packed), n_steps, dt_s)
        hit = hit.cpu().numpy()
        hit.setflags(write=False)
        _TRACE_CACHE[key] = hit
    return hit


def pack_profiles(profiles: list) -> np.ndarray:
    return np.stack([p.as_array() for p in profiles], axis=0)


def trace_horizon_steps(
    horizon_s: float = DEFAULT_HORIZON_S, dt_s: float = DEFAULT_DT_S
) -> int:
    return int(round(horizon_s / dt_s))
