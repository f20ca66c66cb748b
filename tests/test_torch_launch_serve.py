"""The port's serving launcher against `repro.launch.serve`, on the CPU.

Sync mode: 4 replicas of the reduced internlm2, 8 requests of 4 new tokens
each, the hybrid scenario.  The port's gateway gets the reference
gateway's traces (the streams differ by design), so every request's
replica, latency and outcome, and the final `report()`, must equal the
reference launcher's on the same flags.  The replicas' tokens are not
compared: both launchers seed their prompts from Python's salted
``hash()``, and routing does not read the engines' output.

Online mode is wall-clock driven, so it is held to the launcher's own
invariants: every offered request is routed, shed or expired; the
registry, the folded device route stats and the results agree; the trace,
the metrics JSON and the dashboard carry what they should.
"""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.serving import gateway as jgateway
from repro_torch.launch import serve
from repro_torch.obs import Observability
from repro_torch.serving import gateway

RTOL, ATOL = 2e-6, 2e-7
ROOT = Path(__file__).resolve().parents[1]
SYNC_FLAGS = ["--n-replicas", "4", "--n-requests", "8", "--max-new-tokens", "4",
              "--scenario", "hybrid", "--quiet"]


def _adopt_traces(gw, ref):
    """Give the port's gateway the reference gateway's traces, and the
    telemetry window they start it with (`tests/test_torch_gateway.py`'s
    seam)."""
    gw.traces = ref.traces
    gw._telemetry = gateway._HostTelemetry(ref.traces[:, :gw.history], gw.telemetry_dtype)
    np.testing.assert_array_equal(gw.telemetry, ref.traces[:, :gw.history])
    return gw


def test_sync_launcher_matches_reference(monkeypatch):
    refs = []

    class Recorded(jgateway.SonarGateway):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            refs.append(self)

    monkeypatch.setattr(jserve, "SonarGateway", Recorded)
    monkeypatch.setattr(jserve, "_setup_logging", lambda quiet: None)
    monkeypatch.setattr(sys, "argv", ["serve"] + SYNC_FLAGS)
    jserve.main()
    (ref,) = refs

    def adopted(*a, **k):
        return _adopt_traces(gateway.SonarGateway(*a, **k), ref)

    monkeypatch.setattr(serve, "SonarGateway", adopted)
    obs = Observability(audit=True)
    gw = serve.serve_sync(serve.build_parser().parse_args(SYNC_FLAGS), obs=obs, device="cpu")
    assert len(gw.stats) == len(ref.stats) == 8
    assert [(r.replica_idx, r.latency_ms, r.ok) for r in gw.stats] == [
        (r.replica_idx, r.latency_ms, r.ok) for r in ref.stats]
    for f in ("expertise", "network"):
        np.testing.assert_allclose([getattr(r, f) for r in gw.stats],
                                   [getattr(r, f) for r in ref.stats], rtol=RTOL, atol=ATOL)
    assert gw.report() == ref.report()
    np.testing.assert_array_equal(gw.telemetry, ref.telemetry)
    # every routing decision was audited, and recomposes bit for bit
    assert len(obs.audit_tap.records) == 8
    for a, r in zip(obs.audit_tap.records, gw.stats):
        np.testing.assert_array_equal(a.recompose(), a.fused)
        assert a.server_idx == r.replica_idx
        assert (float(a.expertise[a.best]), float(a.network[a.best])) == (r.expertise, r.network)
    # the replicas ran: 8 requests admitted, 3 decode steps each
    assert obs.registry.value("engine_admitted_total") == 8
    assert obs.registry.value("engine_tokens_total") == 8 * 4


def test_online_launcher_invariants(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    args = serve.build_parser().parse_args([
        "--mode", "online", "--horizon-s", "0.25", "--n-requests", "0", "--quiet",
        "--trace", str(trace), "--metrics-json", str(metrics), "--dashboard"])
    buf = io.StringIO()
    summary, results, gw = serve.serve_online(args, device="cpu", dashboard_stream=buf)
    routed = [r for r in results if not (r.shed or r.expired)]
    assert summary["offered"] == len(results) > 10
    assert summary["offered"] == summary["routed"] + summary["shed"] + summary["expired"]
    assert summary["registry_routed"] == summary["routed"] == len(routed)
    stats = gw.obs.fold_route_stats()
    assert stats["n_routed"] == summary["routed"]          # the warm-up picks were dropped
    np.testing.assert_array_equal(
        stats["picks"], np.bincount([r.replica_idx for r in routed], minlength=4))
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 0
    saved = json.loads(metrics.read_text())
    assert saved["route_stats"]["n_routed"] == summary["routed"]
    assert saved["summary"]["routed"] == summary["routed"]
    panel = buf.getvalue()
    assert "mean C / N / S" in panel and "netmcp online (sonar_lb)" in panel


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "_setup_logging", lambda quiet: None)
    for mode in ("sync", "online"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--mode", mode, "--quiet"])


def test_launcher_module_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--quiet",
         "--mode", "online", "--horizon-s", "0.1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("online serving summary: {")
