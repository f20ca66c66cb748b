"""Latency thresholds of the paper (Sec. III-A FR metric, Sec. IV-C).

Only the two constants the QoS score reads.  The trace synthesis of
`repro.core.latency` comes with the paper-harness slice of the port.
"""
from __future__ import annotations

# Latency (ms) above which a server counts as offline (paper Sec. III-A FR
# metric and Sec. IV-C hard clamp).
OFFLINE_MS: float = 1000.0
# Latency above which a sample counts as an outage-risk event (Sec. IV-C).
OUTAGE_RISK_MS: float = 800.0
