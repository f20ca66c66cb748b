"""SONAR network-QoS scoring (paper Sec. IV-C, Eq. 6-7), port of `repro.core.qos`.

Maps a latency history L_m = [l_1 .. l_t] to a network score N in [-1, 1]:

    N = base * (1 - w1*P_high) * (1 - w2*P_trend)
             * (1 - w3*P_outage) * (1 - w4*P_instab)
    N = -1                       if l_t >= 1000 ms (server treated offline)

`network_score` is the plain PyTorch version of the CUDA kernel
`repro_torch.kernels.qos_score`.  All functions are vectorized over the
leading axes: L [..., T] -> N [...], and run on whatever device the
tensor lies on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.latency import OFFLINE_MS, OUTAGE_RISK_MS


@dataclasses.dataclass(frozen=True)
class QosParams:
    """Weights/thresholds of Eq. 7.  Defaults follow the paper's narrative:
    ideal band 20-50 ms, 800 ms outage-risk events, 1000 ms offline clamp."""

    ideal_low_ms: float = 20.0
    ideal_high_ms: float = 50.0
    # decay scale (ms) of the base score beyond the ideal band
    base_scale_ms: float = 200.0
    ewma_alpha: float = 0.3          # EWMA smoothing factor (recent-weighted)
    window: int = 32                 # "recent" window for trend/outage/CV
    trend_scale_ms: float = 50.0     # slope (ms per window) mapping to P=1
    cv_low: float = 0.10             # CV below this is "stable"
    cv_scale: float = 0.50           # CV excess mapping to P=1
    w_high: float = 0.6              # w1
    w_trend: float = 0.3             # w2
    w_outage: float = 0.8            # w3
    w_instab: float = 0.3            # w4
    offline_ms: float = OFFLINE_MS
    outage_risk_ms: float = OUTAGE_RISK_MS


DEFAULT_QOS = QosParams()


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def ewma(lat: torch.Tensor, alpha: float) -> torch.Tensor:
    """Exponentially weighted moving average along the last axis -> last value.

    Closed form: weights alpha*(1-alpha)^k over the sample ages k (f32
    ``pow``, no running product) plus the (1-alpha)^T carry of the initial
    state on the oldest sample.
    """
    lat = _f32(lat)
    T = lat.shape[-1]
    k = torch.arange(T - 1, -1, -1, dtype=torch.float32, device=lat.device)
    base = torch.tensor(1.0 - alpha, dtype=torch.float32, device=lat.device)
    w = alpha * torch.pow(base, k)
    w[0] += (1.0 - alpha) ** T      # initial-state mass -> oldest sample
    return torch.sum(lat * w, dim=-1)


def _window_mask(T: int, window: int, device) -> torch.Tensor:
    idx = torch.arange(T, dtype=torch.float32, device=device)
    return (idx >= T - window).to(torch.float32)


def base_score(ewma_ms: torch.Tensor, p: QosParams = DEFAULT_QOS) -> torch.Tensor:
    """1.0 inside [ideal_low, ideal_high]; smooth decay outside."""
    over = torch.clamp_min(ewma_ms - p.ideal_high_ms, 0.0)
    under = torch.clamp_min(p.ideal_low_ms - ewma_ms, 0.0)
    excess = over + under
    return 1.0 / (1.0 + excess / p.base_scale_ms)


def penalties(lat: torch.Tensor, p: QosParams = DEFAULT_QOS):
    """Compute (ewma, P_high, P_trend, P_outage, P_instab) for L [..., T].

    bf16 windows are widened to f32 exactly first, so every accumulation
    runs in f32 whatever the storage dtype.
    """
    lat = _f32(lat)
    T = lat.shape[-1]
    m = _window_mask(T, p.window, lat.device)
    n_w = torch.sum(m)

    ew = ewma(lat, p.ewma_alpha)

    # P_high — proportional excess of the EWMA prediction over the ideal top.
    p_high = torch.clamp((ew - p.ideal_high_ms) / (4.0 * p.ideal_high_ms), 0.0, 1.0)

    # P_trend — least-squares slope over the recent window, positive part.
    idx = torch.arange(T, dtype=torch.float32, device=lat.device)
    x = (idx - (T - 1) + (n_w - 1) / 2.0) * m             # centered positions
    sum_x2 = torch.sum(x * x)
    slope = torch.sum(lat * x, dim=-1) / torch.clamp_min(sum_x2, 1e-6)
    p_trend = torch.clamp(slope * n_w / p.trend_scale_ms, 0.0, 1.0)

    # P_outage — fraction of recent samples above the outage-risk threshold.
    risky = (lat > p.outage_risk_ms).to(torch.float32) * m
    p_outage = torch.clamp(
        2.0 * torch.sum(risky, dim=-1) / torch.clamp_min(n_w, 1.0), 0.0, 1.0
    )

    # P_instab — coefficient of variation of the recent window.
    mean_w = torch.sum(lat * m, dim=-1) / torch.clamp_min(n_w, 1.0)
    var_w = torch.sum((lat - mean_w[..., None]) ** 2 * m, dim=-1) / torch.clamp_min(
        n_w, 1.0
    )
    cv = torch.sqrt(torch.clamp_min(var_w, 0.0)) / torch.clamp_min(mean_w, 1e-6)
    p_instab = torch.clamp((cv - p.cv_low) / p.cv_scale, 0.0, 1.0)

    return ew, p_high, p_trend, p_outage, p_instab


def network_score(lat: torch.Tensor, p: QosParams = DEFAULT_QOS) -> torch.Tensor:
    """Eq. 7 + offline clamp.  lat [..., T] -> N [...] in [-1, 1].

    Plain version of the QoS kernel; any float storage dtype, f32 math.
    """
    lat = _f32(lat)
    ew, p_high, p_trend, p_outage, p_instab = penalties(lat, p)
    base = base_score(ew, p)
    score = (
        base
        * (1.0 - p.w_high * p_high)
        * (1.0 - p.w_trend * p_trend)
        * (1.0 - p.w_outage * p_outage)
        * (1.0 - p.w_instab * p_instab)
    )
    offline = lat[..., -1] >= p.offline_ms
    return torch.where(offline, torch.full_like(score, -1.0), score)


# ---------------------------------------------------------------------------
# Staleness discount (SONAR-FT extension of Eq. 7)
# ---------------------------------------------------------------------------

def staleness_discount(age_s, half_life_s: float = 180.0) -> torch.Tensor:
    """Confidence weight w = 0.5 ** (age / half_life) in (0, 1] for telemetry
    ``age_s`` seconds old; age 0 gives exactly 1.0."""
    a = torch.clamp_min(_f32(age_s), 0.0)
    half = torch.tensor(0.5, dtype=torch.float32, device=a.device)
    return torch.pow(half, a / torch.tensor(half_life_s, dtype=torch.float32))


# ---------------------------------------------------------------------------
# RTT penalty (SONAR-GEO extension of Eq. 8)
# ---------------------------------------------------------------------------

def rtt_penalty(rtt_ms, scale_ms: float = 150.0) -> torch.Tensor:
    """Saturating propagation-RTT penalty R(rtt) = rtt / (rtt + scale):
    exactly 0 at rtt = 0, 0.5 at ``scale_ms``, bounded below 1."""
    x = torch.clamp_min(_f32(rtt_ms), 0.0)
    return x / (x + torch.tensor(scale_ms, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Load penalty (SONAR-LB extension of Eq. 8)
# ---------------------------------------------------------------------------

def load_penalty(rho, knee: float = 0.75, sharp: float = 4.0) -> torch.Tensor:
    """Convex utilization penalty U(rho) = rho + sharp * max(rho - knee, 0)^2:
    linear below the knee, superlinear past it."""
    x = torch.clamp_min(_f32(rho), 0.0)
    return x + sharp * torch.clamp_min(x - knee, 0.0) ** 2
