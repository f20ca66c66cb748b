"""The port's device-side observability against the JAX reference, on the
CPU.

`repro_torch.obs.DeviceRouteStats` is fed the same seeded arrays as
`repro.obs.DeviceRouteStats` (padding through ``n_real``, ``reset``, the
`MAX_PENDING` backstop): pick counts and ``n_routed`` must be equal, the
means within rtol 1e-6.  Both engines fold only the real rows of a padded
call.  The audit tap must recompose the port's own fused scores bit for
bit for all nine algorithms and three failed-mask kinds, and its terms
must equal the reference's audit of the same decision within the parity
contract (rtol 2e-6 / atol 2e-7).  `render_dashboard` must give the
reference's panel line for line on the same snapshot, but for the clock.
`SpanTracer.span` opens its profiler label whether the tracer is on or
off, starts its event within 1 ms of the label on the CPU profiler's
clock, and leaves a caller's own clock alone; the sharded engine's spans
come in the order of its stages.
"""
import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jadaptive  # noqa: F401  (registers sonar_adapt)
from repro.core import dataset as jdataset
from repro.core import routing as jrouting
from repro.core.batch_routing import BatchRoutingEngine as JEngine
from repro.core.latency import OFFLINE_MS
from repro.obs import AuditTap as JAuditTap
from repro.obs import DeviceRouteStats as JDeviceRouteStats
from repro.obs import render_dashboard as jrender_dashboard
from repro.traffic import replica_fleet as j_replica_fleet
from repro_torch.core import adaptive  # noqa: F401  (registers sonar_adapt)
from repro_torch.core import dataset, routing
from repro_torch.core import latency as latlib
from repro_torch.core.batch_routing import BatchRoutingEngine
from repro_torch.core.mesh_routing import ShardedRoutingEngine
from repro_torch.core.routing import RoutingConfig
from repro_torch.obs import (
    AuditTap,
    DeviceRouteStats,
    LiveDashboard,
    Observability,
    render_dashboard,
)
from repro_torch.obs import trace
from repro_torch.serving import BatchingPolicy, MicroBatchPump, SonarGateway, replica_pool
from repro_torch.traffic import replica_fleet
from repro_torch.traffic.source import request_schedule

RTOL, ATOL = 2e-6, 2e-7
CPU = "cpu"
POOL = dataset.build_server_pool(seed=0)
JPOOL = jdataset.build_server_pool(seed=0)
ALGOS = sorted(routing.ALGORITHMS)
assert len(ALGOS) == 9 and ALGOS == sorted(jrouting.ALGORITHMS)
TEXTS = [
    "what is the latest news about the stock market today",
    "search the web for current weather information",
    "find recent articles about machine learning research",
    "look up live election results online",
]


# ---------------------------------------------------------------------------
# DeviceRouteStats against the reference's accumulator
# ---------------------------------------------------------------------------

# ("acc", rows, n_real) accumulates one seeded call, ("fold", reset) folds
STAT_SCRIPTS = {
    "padding": [("acc", 4, 3), ("fold", False), ("fold", True), ("fold", False)],
    "all_rows": [("acc", 6, None), ("acc", 5, None), ("fold", True), ("fold", False)],
    "reset_between": [("acc", 8, 5), ("fold", True), ("acc", 8, 8), ("acc", 3, None),
                      ("fold", False), ("acc", 2, 0), ("acc", 7, 1), ("fold", True)],
    "many_calls": [("acc", 16, 9)] * 12 + [("fold", False)],
}


def _same_fold(port: dict, ref: dict, ctx) -> None:
    np.testing.assert_array_equal(port["picks"], np.asarray(ref["picks"]), err_msg=ctx)
    assert port["n_routed"] == ref["n_routed"], ctx
    for k in ("mean_expertise", "mean_network", "mean_fused"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("script", sorted(STAT_SCRIPTS))
def test_device_route_stats_match_reference(script):
    n_servers = 7
    rng = np.random.default_rng(len(script))
    port, ref = DeviceRouteStats(n_servers), JDeviceRouteStats(n_servers)
    for step, op in enumerate(STAT_SCRIPTS[script]):
        if op[0] == "acc":
            _, rows, n_real = op
            idx = rng.integers(0, n_servers, rows).astype(np.int32)
            c, n, s = (rng.uniform(-1.0, 1.0, rows).astype(np.float32) for _ in range(3))
            port.accumulate(torch.from_numpy(idx), torch.from_numpy(c), torch.from_numpy(n),
                            torch.from_numpy(s), n_real=n_real)
            ref.accumulate(jnp.asarray(idx), jnp.asarray(c), jnp.asarray(n), jnp.asarray(s),
                           n_real=n_real)
        else:
            _same_fold(port.fold(reset=op[1]), ref.fold(reset=op[1]), f"{script} step {step}")


def test_device_route_stats_defer_and_max_pending_backstop():
    """`accumulate` only appends; `MAX_PENDING` drains inline, as the
    reference's does."""
    port, ref = DeviceRouteStats(2), JDeviceRouteStats(2)
    port.MAX_PENDING = ref.MAX_PENDING = 2
    one, f = np.array([1], np.int32), np.array([0.5], np.float32)
    for k in range(5):
        port.accumulate(*(torch.from_numpy(a) for a in (one, f, f, f)))
        ref.accumulate(*(jnp.asarray(a) for a in (one, f, f, f)))
        assert len(port._pending) == len(ref._pending) == (k + 1) % 2
    assert float(port._buf[1]) == 4.0                     # two drains of two
    _same_fold(port.fold(), ref.fold(), "backstop")
    assert port.fold()["n_routed"] == 0.0                 # fold(reset=True) zeroed it


def _fleet_and_window(n, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.uniform(5.0, 400.0, (n, 16)).astype(np.float32)
    hist[rng.random(n) < 0.2, -1] = OFFLINE_MS + 50.0
    return replica_fleet(n), hist


def test_two_engine_calls_before_one_fold_equal_the_host_decisions():
    """Deferred references: two calls with different queries and telemetry
    are accumulated before one fold; the fold is their decisions' sum."""
    servers, hist = _fleet_and_window(6)
    eng = BatchRoutingEngine(servers, RoutingConfig(top_s=4, top_k=4), algo="sonar_lb",
                             device=CPU)
    drs = DeviceRouteStats(6)
    load = np.linspace(0.0, 1.5, 6).astype(np.float32)
    d1 = eng.route(eng.encode(TEXTS), hist, load, route_stats=drs)
    d2 = eng.route(eng.encode(TEXTS[:3] * 3), hist[::-1].copy(), load[::-1].copy(),
                   route_stats=drs)
    assert len(drs._pending) == 2
    out = drs.fold()
    idx = np.concatenate([d1.server_idx, d2.server_idx])
    np.testing.assert_array_equal(out["picks"], np.bincount(idx, minlength=6))
    assert out["n_routed"] == len(idx) == 13
    for k, f in (("mean_expertise", "expertise"), ("mean_network", "network"),
                 ("mean_fused", "fused")):
        host = np.concatenate([getattr(d1, f), getattr(d2, f)]).astype(np.float64).mean()
        np.testing.assert_allclose(out[k], host, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_engines_fold_only_the_real_rows_of_a_padded_call(kind):
    servers, hist = _fleet_and_window(9, seed=3)
    cfg = RoutingConfig(top_s=4, top_k=6)
    if kind == "single":
        eng = BatchRoutingEngine(servers, cfg, algo="sonar", device=CPU)
    else:
        eng = ShardedRoutingEngine(servers, cfg, algo="sonar", n_shards=3, device=CPU)
    enc = eng.encode(TEXTS[:3]).pad_to(8)
    drs = DeviceRouteStats(9)
    d = eng.route(enc, hist, route_stats=drs, n_real=3)
    assert len(d) == 8
    out = drs.fold()
    np.testing.assert_array_equal(out["picks"], np.bincount(d.server_idx[:3], minlength=9))
    assert out["n_routed"] == 3.0
    np.testing.assert_allclose(out["mean_network"], d.network[:3].astype(np.float64).mean(),
                               rtol=1e-6)
    if kind == "single":
        # the reference engine and accumulator on the same padded call
        jeng = JEngine(j_replica_fleet(9), jrouting.RoutingConfig(top_s=4, top_k=6),
                       algo="sonar")
        jdrs = JDeviceRouteStats(9)
        jeng.route(jeng.encode(TEXTS[:3]).pad_to(8), hist, route_stats=jdrs, n_real=3)
        _same_fold(out, jdrs.fold(), "padded single engine")


# ---------------------------------------------------------------------------
# Audit tap: bit-exact recomposition of the port's own scores (all nine
# algorithms), and the reference's audit of the same decision
# ---------------------------------------------------------------------------

def _audit_fixture(seed, mask_kind, n_servers=5):
    """`tests/test_obs.py`'s fixture, with an affinity row added."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(POOL), size=n_servers, replace=False)
    hist = rng.uniform(5.0, 400.0, (n_servers, 24)).astype(np.float32)
    hist[rng.random(n_servers) < 0.3, -1] = OFFLINE_MS + 50.0
    load = (rng.random(n_servers) * 2.0).astype(np.float32)
    age = (rng.random(n_servers) * 600.0).astype(np.float32)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "all":
        mask = np.ones(n_servers, bool)
    else:
        mask = rng.random(n_servers) < 0.4
    rtt = (rng.random(n_servers) * 500.0).astype(np.float32)
    aff = rng.random(n_servers).astype(np.float32)
    return pick, hist, load, age, mask, rtt, aff


@pytest.mark.parametrize("mask_kind", ["none", "some", "all"])
@pytest.mark.parametrize("algo", ALGOS)
def test_audit_recomposes_bit_for_bit_and_matches_reference(algo, mask_kind):
    seed = 1000 * ALGOS.index(algo) + ["none", "some", "all"].index(mask_kind)
    pick, hist, load, age, mask, rtt, aff = _audit_fixture(seed, mask_kind)
    router = routing.make_router(algo, [POOL[i] for i in pick], RoutingConfig(top_s=4, top_k=5))
    jrouter = jrouting.make_router(algo, [JPOOL[i] for i in pick],
                                   jrouting.RoutingConfig(top_s=4, top_k=5))
    extra = {"affinity": aff} if router.uses_affinity else {}
    tap, jtap = AuditTap(), JAuditTap()
    for q in TEXTS[:2]:
        kw = dict(telemetry_age_s=age, failed_mask=mask, client_rtt_ms=rtt, **extra)
        d = router.select(q, hist, load, audit=tap, **kw)
        jd = jrouter.select(q, hist, load, audit=jtap, **kw)
        a, ja = tap.last, jtap.last
        assert a.algo == router.name == ja.algo
        assert (a.server_idx, a.tool_idx) == (d.server_idx, d.tool_idx)
        assert (d.server_idx, d.tool_idx) == (jd.server_idx, jd.tool_idx)
        # the port's own scores, with no tolerance
        assert a.winning_score() == d.fused
        np.testing.assert_array_equal(a.recompose(), a.fused)
        assert float(a.expertise[a.best]) == d.expertise
        # the reference's audit of the same decision
        assert a.best == ja.best
        np.testing.assert_array_equal(a.cand_tools, ja.cand_tools)
        np.testing.assert_array_equal(a.cand_hosts, ja.cand_hosts)
        for f in ("network", "load_pen", "rtt_pen", "aff_bonus", "dead"):
            assert (getattr(a, f) is None) == (getattr(ja, f) is None), f
        if a.dead is not None:
            np.testing.assert_array_equal(a.dead, ja.dead)
        np.testing.assert_allclose(a.fused, ja.fused, rtol=RTOL, atol=ATOL)
        terms, jterms = a.terms(), ja.terms()
        assert terms.keys() == jterms.keys()
        for k in terms:
            np.testing.assert_allclose(terms[k], jterms[k], rtol=RTOL, atol=ATOL, err_msg=k)
        if np.isfinite(d.fused):
            assert np.isclose(sum(terms.values()), d.fused, rtol=1e-5, atol=1e-6)
        assert router.name in a.explain()
    assert len(tap.records) == 2


def test_audit_holds_sonar_adapt_live_weights():
    """After feedback moves SONAR-ADAPT's weights, the tap records the
    weights the fusion used and still recomposes bit for bit."""
    pick, hist, load, age, mask, rtt, _ = _audit_fixture(5, "some")
    router = routing.make_router("sonar_adapt", [POOL[i] for i in pick],
                                 RoutingConfig(top_s=4, top_k=5))
    tap = AuditTap()
    for i in range(6):
        d = router.select(TEXTS[i % 4], hist, load, telemetry_age_s=age, failed_mask=mask,
                          client_rtt_ms=rtt, audit=tap)
        router.observe_outcome(50.0 + 300.0 * (i % 2), ok=i % 3 != 0)
        a = tap.last
        assert a.winning_score() == d.fused
        np.testing.assert_array_equal(a.recompose(), a.fused)
    assert (a.alpha, a.beta, a.gamma, a.delta) == (
        router.cfg.alpha, router.cfg.beta, router.cfg.gamma, router.cfg.delta)
    assert a.alpha != RoutingConfig().alpha          # the weights did move


def test_audit_records_every_failover_hop():
    servers = replica_fleet(4)
    router = routing.make_router("sonar_ft", servers, RoutingConfig(top_s=4, top_k=4))
    rng = np.random.default_rng(0)
    hist = rng.uniform(5.0, 200.0, (4, 16)).astype(np.float32)
    tap = AuditTap()
    d, hops = router.select_failover(
        TEXTS[0], hist, np.zeros(4, np.float32), alive=np.zeros(4, bool), budget=2, audit=tap,
    )
    assert hops == 2 and len(tap.records) == 3
    assert len({r.server_idx for r in tap.records}) == 3     # each hop masks the last pick
    for r in tap.records:
        assert r.winning_score() == r.fused[r.best]
    assert tap.records[-1].server_idx == d.server_idx


def test_audit_tap_is_bounded():
    tap = AuditTap(max_records=2)
    router = routing.make_router("sonar", replica_fleet(3), RoutingConfig(top_s=3, top_k=3))
    hist = np.full((3, 8), 50.0, np.float32)
    for _ in range(4):
        router.select(TEXTS[0], hist, audit=tap)
    assert len(tap.records) == 2 and tap.n_dropped == 2
    tap.clear()
    assert tap.records == [] and tap.n_dropped == 0 and tap.last is None


def test_gateway_threads_audit_tap():
    obs = Observability(audit=True)
    gw = SonarGateway(replica_pool([("yi-6b", "dense")] * 3), algo="sonar_lb", obs=obs,
                      device=CPU)
    res = gw.route(TEXTS[0])
    gw.begin(TEXTS[1])
    assert len(obs.audit_tap.records) == 2
    a = obs.audit_tap.records[0]
    np.testing.assert_array_equal(a.recompose(), a.fused)
    assert a.server_idx == res.replica_idx and float(a.expertise[a.best]) == res.expertise


# ---------------------------------------------------------------------------
# The bundle and the dashboard
# ---------------------------------------------------------------------------

def test_observability_bundle_toggles():
    off = Observability()
    assert not off.tracer.enabled and off.route_stats is None
    assert off.ensure_route_stats(8) is None
    off.drain_route_stats()                     # no-op without stats
    assert off.fold_route_stats() is None
    on = Observability(jit_stats=True, audit=True)
    drs = on.ensure_route_stats(8)
    assert drs is not None and drs.n_servers == 8
    assert on.ensure_route_stats(8) is drs      # cached per fleet size
    assert on.ensure_route_stats(16) is not drs
    assert on.audit_tap is not None
    assert on.fold_route_stats()["n_routed"] == 0.0


@pytest.fixture(scope="module")
def pump_run():
    """One instrumented pump replay over the port's gateway."""
    obs = Observability(trace=True, jit_stats=True)
    gw = SonarGateway(replica_pool([("yi-6b", "dense")] * 3),
                      profiles=[latlib.ideal_profile() for _ in range(3)], algo="sonar_lb",
                      use_kernels=True, device_telemetry=True, obs=obs, device=CPU)
    schedule = request_schedule("flash_crowd", torch.Generator().manual_seed(0), 400.0, 0.25,
                                TEXTS, deadline_ms=30.0, spike_factor=3.0)
    pump = MicroBatchPump(gw, BatchingPolicy(max_batch=4, max_wait_ms=2.0, slack_ms=0.0,
                                             queue_limit=8, pad_batches=True))
    rep = pump.replay(schedule)
    assert rep.n_routed > 0 and rep.n_flushes > 0
    return obs, gw, pump, rep


def test_pump_route_stats_count_real_rows_only(pump_run):
    obs, _, pump, rep = pump_run
    stats = obs.route_stats.fold(reset=False)
    assert stats["n_routed"] == rep.n_routed == stats["picks"].sum()
    tally = np.bincount([r.replica_idx for r in pump.results.values()
                         if not (r.shed or r.expired)], minlength=3)
    np.testing.assert_array_equal(stats["picks"], tally)


def test_render_dashboard_matches_reference(pump_run):
    obs, _, _, rep = pump_run
    snap, stats = obs.registry.snapshot(), obs.route_stats.fold(reset=False)
    panel = render_dashboard(snap, stats, title="obs test")
    ref = jrender_dashboard(snap, stats, title="obs test").splitlines()
    lines = panel.splitlines()
    assert len(lines) == len(ref)
    assert [ln for i, ln in enumerate(lines) if i != 1] == [ln for i, ln in enumerate(ref)
                                                           if i != 1]
    assert "obs test" in lines[1]
    assert f"{rep.n_offered:.0f} / {rep.n_routed:.0f}" in panel
    assert "mean C / N / S" in panel and "replica" in panel
    assert len({len(ln) for ln in lines}) == 1        # every line fits the box


def test_live_dashboard_repaints_in_place(pump_run):
    obs, _, _, _ = pump_run
    out = io.StringIO()
    dash = LiveDashboard(obs.registry, route_stats_fn=obs.fold_route_stats, min_interval_s=60.0,
                         stream=out, title="live")
    assert dash.update(force=True)
    assert not dash.update()                     # throttled
    assert dash.update(force=True)
    text = out.getvalue()
    assert "live" in text and "mean C / N / S" in text
    assert "\x1b[" in text                       # ANSI in-place repaint


# ---------------------------------------------------------------------------
# The span call: one profiler label, one clock
# ---------------------------------------------------------------------------

def _labels(prof) -> dict:
    """Profiler label name -> [start_ns] of its host ranges."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append(e.start_ns())
    return out


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _labels(prof)


def test_disabled_span_records_nothing_and_still_opens_the_label():
    off = trace.SpanTracer(enabled=False)

    def run():
        with off.span("netmcp.off", args={"k": 1}):
            torch.ones(4).sum()

    labels = _profiled(run)
    assert off.events == [] and len(labels["netmcp.off"]) == 1


def test_enabled_span_starts_with_its_label_on_the_profilers_axis():
    on = trace.SpanTracer(enabled=True)
    assert on.clock_ms is trace.now_ms

    def run():
        for i in range(5):
            with on.span(f"netmcp.on{i}", cat="t", args={"i": i}) as sp:
                assert sp.args == {"i": i}
                torch.ones(4).sum()

    labels = _profiled(run)
    assert [e["name"] for e in on.events] == [f"netmcp.on{i}" for i in range(5)]
    for e in on.events:
        (start_ns,) = labels[e["name"]]
        assert abs(e["ts"] - start_ns / 1e3) < 1000.0, (e["name"], e["ts"], start_ns)
        assert e["dur"] >= 0.0 and e["cat"] == "t"
    # the axis is the Unix epoch's, in ms
    assert abs(trace.now_ms() - time.time() * 1e3) < 50.0


def test_span_leaves_a_callers_virtual_clock_alone():
    clock = iter([10.0, 10.0, 12.5, 12.5])
    virt = trace.SpanTracer(clock_ms=lambda: next(clock))
    fn = virt.clock_ms
    with virt.span("x", cat="sim"):
        pass
    assert virt.clock_ms is fn
    (ev,) = virt.events
    assert (ev["name"], ev["ts"], ev["dur"]) == ("x", 10000.0, 2500.0)
    assert Observability(clock_ms=lambda: 0.0).tracer.clock_ms() == 0.0


# ---------------------------------------------------------------------------
# The sharded engine's spans
# ---------------------------------------------------------------------------

def test_sharded_engine_spans_in_order():
    obs = Observability(trace=True)
    eng = ShardedRoutingEngine(POOL, RoutingConfig(top_s=4, top_k=5), algo="sonar_ft",
                               n_shards=3, device=CPU, obs=obs)
    n = len(POOL)
    rng = np.random.default_rng(3)
    lat = rng.uniform(20.0, 200.0, (n, 16)).astype(np.float32)
    eng.route_texts(TEXTS, lat, server_load=rng.uniform(0, 1, n),
                    telemetry_age_s=rng.uniform(0, 30, n), failed_mask=rng.random(n) < 0.2)
    ev = obs.tracer.events
    names = [e["name"] for e in ev]
    assert names == ["netmcp.encode.intent", "netmcp.encode.terms", "netmcp.encode",
                     "netmcp.route_prep", "netmcp.route.score", "netmcp.route.stage1",
                     "netmcp.route.stage2", "netmcp.route.select", "netmcp.route_sharded",
                     "netmcp.route_fetch"]
    by = {e["name"]: e for e in ev}

    def end(e):
        return e["ts"] + e["dur"]

    def inside(inner, outer):
        return by[outer]["ts"] <= by[inner]["ts"] and end(by[inner]) <= end(by[outer])

    assert inside("netmcp.encode.intent", "netmcp.encode")
    assert inside("netmcp.encode.terms", "netmcp.encode")
    stages = ["netmcp.route.score", "netmcp.route.stage1", "netmcp.route.stage2",
              "netmcp.route.select"]
    assert all(inside(s, "netmcp.route_sharded") for s in stages)
    order = ["netmcp.encode", "netmcp.route_prep", *stages, "netmcp.route_fetch"]
    assert all(end(by[a]) <= by[b]["ts"] for a, b in zip(order, order[1:]))
    assert by["netmcp.route_prep"]["args"] == {"n": len(TEXTS)}
    # the default is a disabled tracer: the same labels, no events
    quiet = ShardedRoutingEngine(POOL, RoutingConfig(top_s=4, top_k=5), algo="sonar_ft",
                                 n_shards=3, device=CPU)
    assert not quiet.obs.tracer.enabled
    labels = _profiled(lambda: quiet.route_texts(TEXTS, lat))
    assert set(names) <= set(labels) and quiet.obs.tracer.events == []
