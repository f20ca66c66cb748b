"""Live text dashboard over a `MetricsRegistry` snapshot, twin of
`repro.obs.dashboard`.

`render_dashboard` turns one snapshot into a fixed-width text panel
(throughput, latency quantiles, shed/expiry, health ejections, per-phase
timing, top replicas by picks); `LiveDashboard` redraws it in place with
ANSI cursor control at a bounded refresh rate: the ``--dashboard`` view
of ``python -m repro_torch.launch.serve --mode online``.  Pure Python.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

__all__ = ["LiveDashboard", "render_dashboard"]

_W = 66


def _bar(frac: float, width: int = 24) -> str:
    frac = max(0.0, min(1.0, frac))
    fill = int(round(frac * width))
    return "#" * fill + "." * (width - fill)


def _row(label: str, value: str) -> str:
    return f"| {label:<24} {value:<{_W - 28}}|"


def _fmt_ms(v: float) -> str:
    return f"{v:8.2f} ms"


def render_dashboard(
    snapshot: dict,
    route_stats: Optional[dict] = None,
    title: str = "netmcp serving",
) -> str:
    """Render one metrics snapshot as a boxed text panel.

    ``snapshot`` is `MetricsRegistry.snapshot()`; ``route_stats`` the
    optional `DeviceRouteStats.fold()` dict for the per-replica pick
    distribution.
    """
    def val(name, field="value", default=0.0):
        m = snapshot.get(name)
        return m.get(field, default) if isinstance(m, dict) else default

    offered = val("serving_offered_total")
    routed = val("serving_routed_total")
    shed = val("serving_shed_total")
    expired = val("serving_expired_total")
    flushes = val("serving_flushes_total")
    in_flight = val("gateway_in_flight")
    ejected = val("gateway_ejected")
    ejections = val("gateway_ejections_total")
    failures = val("gateway_failures_total")
    n_gw = val("gateway_requests_total")

    lines = []
    lines.append("+" + "-" * (_W - 2) + "+")
    lines.append(_row(title, time.strftime("%H:%M:%S")))
    lines.append("+" + "-" * (_W - 2) + "+")
    lines.append(_row("offered / routed",
                      f"{offered:.0f} / {routed:.0f}"))
    lines.append(_row("shed / expired",
                      f"{shed:.0f} / {expired:.0f}"))
    frac_ok = routed / offered if offered else 0.0
    lines.append(_row("goodput", f"[{_bar(frac_ok)}] {100.0 * frac_ok:5.1f}%"))
    lines.append(_row("flushes", f"{flushes:.0f}"))
    mb = routed / flushes if flushes else 0.0
    lines.append(_row("mean batch", f"{mb:.2f}"))
    lat = snapshot.get("serving_latency_ms")
    if isinstance(lat, dict) and lat.get("count"):
        lines.append(_row("serve p50 / p99 / p999",
                          f"{lat['p50']:7.2f} / {lat['p99']:7.2f} / "
                          f"{lat['p999']:7.2f} ms"))
        lines.append(_row("serve mean", _fmt_ms(lat["mean"])))
    net = snapshot.get("gateway_latency_ms")
    if isinstance(net, dict) and net.get("count"):
        lines.append(_row("replica net p50 / p99",
                          f"{net['p50']:7.2f} / {net['p99']:7.2f} ms"))
    for phase in ("encode", "dispatch", "merge"):
        h = snapshot.get(f"gateway_phase_{phase}_ms")
        if isinstance(h, dict) and h.get("count"):
            lines.append(_row(f"phase {phase}",
                              f"{h['mean']:8.3f} ms/flush"))
    lines.append("+" + "-" * (_W - 2) + "+")
    lines.append(_row("gateway routed", f"{n_gw:.0f}"))
    lines.append(_row("failures", f"{failures:.0f}"))
    lines.append(_row("in flight", f"{in_flight:.0f}"))
    lines.append(_row("ejected now / total",
                      f"{ejected:.0f} / {ejections:.0f}"))
    if route_stats and route_stats.get("n_routed"):
        picks = route_stats["picks"]
        total = float(picks.sum()) or 1.0
        order = sorted(range(len(picks)), key=lambda i: -picks[i])[:4]
        lines.append("+" + "-" * (_W - 2) + "+")
        for i in order:
            if picks[i] <= 0:
                continue
            lines.append(_row(
                f"replica {i:3d}",
                f"[{_bar(picks[i] / total)}] {picks[i]:6.0f}",
            ))
        lines.append(_row("mean C / N / S",
                          f"{route_stats['mean_expertise']:.3f} / "
                          f"{route_stats['mean_network']:.3f} / "
                          f"{route_stats['mean_fused']:.3f}"))
    lines.append("+" + "-" * (_W - 2) + "+")
    return "\n".join(lines)


class LiveDashboard:
    """In-place refresh: each `update` repaints the panel over the last
    one (ANSI cursor-up), throttled to ``min_interval_s``."""

    def __init__(self, registry, route_stats_fn=None,
                 min_interval_s: float = 0.25, stream=None,
                 title: str = "netmcp serving"):
        self.registry = registry
        self.route_stats_fn = route_stats_fn
        self.min_interval_s = float(min_interval_s)
        self.stream = stream if stream is not None else sys.stdout
        self.title = title
        self._last_paint = 0.0
        self._last_height = 0

    def update(self, force: bool = False) -> bool:
        now = time.monotonic()
        if not force and now - self._last_paint < self.min_interval_s:
            return False
        self._last_paint = now
        stats = self.route_stats_fn() if self.route_stats_fn else None
        panel = render_dashboard(
            self.registry.snapshot(), stats, title=self.title
        )
        if self._last_height:
            self.stream.write(f"\x1b[{self._last_height}F\x1b[J")
        self.stream.write(panel + "\n")
        self.stream.flush()
        self._last_height = panel.count("\n") + 1
        return True
