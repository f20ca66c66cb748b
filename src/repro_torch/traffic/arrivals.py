"""Open-loop arrival processes, twin of `repro.traffic.arrivals`.

Every generator maps a `torch.Generator` to a sorted float64 numpy array
of arrival times (seconds) on [0, horizon_s), fully deterministic given
the generator's seed and device.  The draws run on the generator's device
in float32 and are widened to float64, as the reference's are.  Four
canonical shapes:

  poisson      — homogeneous Poisson (exponential inter-arrivals)
  diurnal      — inhomogeneous Poisson, sinusoidally-modulated rate
  mmpp         — 2-state Markov-modulated Poisson (calm/burst phases with
                 exponential dwell times)
  flash_crowd  — base Poisson plus an exponentially-decaying spike at t0

Non-homogeneous processes thin a homogeneous process at the peak rate
(Lewis & Shedler), so any nonnegative `rate_fn(t)` bounded by `peak_rate`
defines a valid process via `thinned_arrivals`.  `merge_arrivals`
superimposes streams.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "poisson_arrivals",
    "diurnal_arrivals",
    "mmpp_arrivals",
    "flash_crowd_arrivals",
    "thinned_arrivals",
    "merge_arrivals",
    "ARRIVAL_PROCESSES",
]


def _exponential(gen: torch.Generator, n: int) -> np.ndarray:
    """n Exp(1) draws in float32 on the generator's device, as float64."""
    x = torch.empty((n,), dtype=torch.float32, device=gen.device).exponential_(generator=gen)
    return x.cpu().numpy().astype(np.float64)


def _homogeneous(gen: torch.Generator, rate: float, horizon_s: float) -> np.ndarray:
    """Homogeneous Poisson arrival times on [0, horizon) at `rate` req/s."""
    if rate <= 0.0 or horizon_s <= 0.0:
        return np.zeros((0,), np.float64)
    times: list = []
    t0 = 0.0
    # draw in chunks until the cumulative sum clears the horizon
    mean_n = rate * horizon_s
    chunk = int(mean_n + 6.0 * np.sqrt(mean_n) + 16.0)
    while t0 < horizon_s:
        t = t0 + np.cumsum(_exponential(gen, chunk) / rate)
        times.append(t)
        t0 = float(t[-1])
    out = np.concatenate(times)
    return out[out < horizon_s]


def thinned_arrivals(
    gen: torch.Generator,
    rate_fn: Callable[[np.ndarray], np.ndarray],
    peak_rate: float,
    horizon_s: float,
) -> np.ndarray:
    """Inhomogeneous Poisson with intensity rate_fn(t) <= peak_rate, by
    thinning a homogeneous process at the peak rate."""
    t = _homogeneous(gen, peak_rate, horizon_s)
    if t.size == 0:
        return t
    u = torch.rand((t.size,), generator=gen, device=gen.device).cpu().numpy().astype(np.float64)
    keep = u * peak_rate < np.maximum(rate_fn(t), 0.0)
    return t[keep]


def poisson_arrivals(gen: torch.Generator, rate: float, horizon_s: float) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` requests/second over
    ``horizon_s`` seconds: f64 sorted times in seconds, all < horizon_s
    (length ~ Poisson(rate * horizon_s))."""
    return _homogeneous(gen, rate, horizon_s)


def diurnal_arrivals(
    gen: torch.Generator,
    rate: float,
    horizon_s: float,
    depth: float = 0.6,
    period_s: float = 24 * 3600.0,
    phase: float = 0.0,
) -> np.ndarray:
    """rate(t) = rate * (1 + depth*sin(2*pi*t/period + phase)); mean = rate."""
    depth = float(np.clip(depth, 0.0, 1.0))

    def rate_fn(t):
        return rate * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s + phase))

    return thinned_arrivals(gen, rate_fn, rate * (1.0 + depth), horizon_s)


def mmpp_arrivals(
    gen: torch.Generator,
    rate: float,
    horizon_s: float,
    burst_factor: float = 5.0,
    calm_mean_s: float = 120.0,
    burst_mean_s: float = 20.0,
) -> np.ndarray:
    """2-state MMPP with mean rate `rate`: calm/burst phases with exponential
    dwell times; the burst rate is `burst_factor` x the calm rate, with the
    calm rate solved so the stationary mean equals `rate`."""
    frac_burst = burst_mean_s / (calm_mean_s + burst_mean_s)
    r_calm = rate / (1.0 - frac_burst + burst_factor * frac_burst)
    r_burst = burst_factor * r_calm

    # sample alternating dwell times until the horizon is covered
    switches, t0, burst = [0.0], 0.0, False
    while t0 < horizon_s:
        mean = burst_mean_s if burst else calm_mean_s
        dwell = float(_exponential(gen, 1)[0]) * mean
        t0 += max(dwell, 1e-6)
        switches.append(t0)
        burst = not burst
    switches_arr = np.asarray(switches)

    def rate_fn(t):
        # phase index = number of completed dwells; even -> calm, odd -> burst
        phase = np.searchsorted(switches_arr, t, side="right") - 1
        return np.where(phase % 2 == 1, r_burst, r_calm)

    return thinned_arrivals(gen, rate_fn, r_burst, horizon_s)


def flash_crowd_arrivals(
    gen: torch.Generator,
    rate: float,
    horizon_s: float,
    spike_factor: float = 8.0,
    spike_at_s: float | None = None,
    decay_s: float | None = None,
) -> np.ndarray:
    """Base Poisson at `rate` plus a flash crowd at `spike_at_s` (default:
    1/3 into the horizon): instantaneously `spike_factor` x the base rate,
    decaying exponentially with time constant `decay_s` (default horizon/8)."""
    t_spike = horizon_s / 3.0 if spike_at_s is None else spike_at_s
    tau = horizon_s / 8.0 if decay_s is None else decay_s

    def rate_fn(t):
        spike = np.where(t >= t_spike, spike_factor * rate * np.exp(-(t - t_spike) / tau), 0.0)
        return rate + spike

    return thinned_arrivals(gen, rate_fn, rate * (1.0 + spike_factor), horizon_s)


def merge_arrivals(*streams: np.ndarray) -> np.ndarray:
    """Superimpose arrival streams into one sorted stream."""
    if not streams:
        return np.zeros((0,), np.float64)
    return np.sort(np.concatenate(streams))


ARRIVAL_PROCESSES: dict = {
    "poisson": poisson_arrivals,
    "diurnal": diurnal_arrivals,
    "mmpp": mmpp_arrivals,
    "flash_crowd": flash_crowd_arrivals,
}
