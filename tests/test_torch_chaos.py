"""The port's chaos fault injection against the JAX reference, on the CPU.

`repro_torch.chaos.{faults, schedule}` and the tracer's chaos emitter are
held to their `repro` twins.  The clock-driven masks and the canonical
fault mix must be equal.  The crash/restart process draws from a
`torch.Generator` in the port and from `jax.random` keys split per server
and per step in the reference, so the port's recurrence is fed the
reference's own per-step draws (recomputed here outside the scan) and must
give the reference's mask bit for bit; on its own stream it is held to the
process's availability.  Schedule queries and agent episodes under chaos
run on schedules built from the reference's masks.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.chaos import faults as jfaults
from repro.chaos import schedule as jschedule
from repro.core import agent as jagent
from repro.core import latency as jlatency
from repro.core import platform as jplatform
from repro.core import routing as jrouting
from repro.core.batch_routing import make_engine as jmake_engine
from repro.core.dataset import Query as JQuery
from repro.obs import trace as jtrace
from repro.traffic import fleet as jfleet
from repro_torch.chaos import faults, schedule
from repro_torch.core import agent, latency, platform, routing
from repro_torch.core.batch_routing import make_engine
from repro_torch.core.dataset import Query
from repro_torch.obs import trace
from repro_torch.traffic import fleet

CPU = "cpu"
RTOL, ATOL = 2e-6, 2e-7


def _port_fault(jf):
    """The port's spec of a reference fault spec (same class name, fields)."""
    return getattr(faults, type(jf).__name__)(**dataclasses.asdict(jf))


def _port_schedule(js):
    return schedule.ChaosSchedule(down=js.down, degrade=js.degrade, stale=js.stale,
                                  dt_s=js.dt_s, severity_ms=js.severity_ms)


# ---------------------------------------------------------------------------
# deterministic masks and the canonical mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_steps,dt", [(100, 1.0), (640, 10.0), (7, 0.5)])
def test_clock_masks_equal_reference(n_steps, dt):
    for start, end in ((0.0, None), (13.0, 57.5), (5.0, 5.0), (-3.0, 1e9)):
        np.testing.assert_array_equal(faults.window_mask(n_steps, dt, start, end),
                                      jfaults.window_mask(n_steps, dt, start, end))
    for period, duty, start, end in ((20.0, 0.3, 0.0, None), (7.0, 1.4, 11.0, 300.0),
                                     (4.0, -0.2, 2.0, None), (33.0, 0.5, 50.0, 60.0)):
        kw = dict(servers=(0,), period_s=period, duty=duty, start_s=start, end_s=end)
        np.testing.assert_array_equal(
            faults.flapping_mask(faults.FlappingFault(**kw), n_steps, dt),
            jfaults.flapping_mask(jfaults.FlappingFault(**kw), n_steps, dt))
    for start, ramp, top, end in ((10.0, 40.0, 4.0, None), (0.0, 0.0, 8.0, 30.0),
                                  (25.0, 1000.0, 2.5, 200.0)):
        kw = dict(servers=(1,), start_s=start, ramp_s=ramp, max_factor=top, end_s=end)
        a = faults.degradation_factor(faults.DegradationFault(**kw), n_steps, dt)
        b = jfaults.degradation_factor(jfaults.DegradationFault(**kw), n_steps, dt)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 10005])
def test_standard_fault_mix_equals_reference(n):
    for x in (0.0, 0.3, 0.8, 1.0, 1.7):
        for horizon in (600.0, 86400.0):
            mine = schedule.standard_fault_mix(x, n, horizon)
            ref = jschedule.standard_fault_mix(x, n, horizon)
            assert [type(f).__name__ for f in mine] == [type(f).__name__ for f in ref]
            assert [dataclasses.asdict(f) for f in mine] == [dataclasses.asdict(f) for f in ref]
    assert [type(k).__name__ for k in faults.FAULT_KINDS] == [
        type(k).__name__ for k in jfaults.FAULT_KINDS]


# ---------------------------------------------------------------------------
# the crash/restart recurrence
# ---------------------------------------------------------------------------

def _ref_crash_draws(key, rows, n_steps):
    """The reference's per-step draws of `crash_restart_masks`, outside its
    scan: per server key, per step key, split into (entry, repair)."""
    def per_server(k):
        pair = jax.vmap(jax.random.split)(jax.random.split(k, n_steps))
        return (jax.vmap(jax.random.uniform)(pair[:, 0]),
                jax.vmap(jax.random.exponential)(pair[:, 1]))

    u, e = jax.vmap(per_server)(jax.random.split(key, rows))
    return np.asarray(u), np.asarray(e)


@pytest.mark.parametrize("mttf,mttr,start,dt,n_steps", [
    (300.0, 60.0, 0.0, 1.0, 600),
    (40.0, 0.3, 25.0, 1.0, 300),          # repair below a tick: clamped to 1
    (2000.0, 500.0, 3000.0, 10.0, 900),   # a start that is not a whole tick
    (4.0, 9.0, 0.0, 1.0, 200),
])
def test_crash_recurrence_fed_reference_draws_equals_reference(mttf, mttr, start, dt, n_steps):
    rows = 5
    jf = jfaults.CrashRestartFault(servers=tuple(range(rows)), mttf_s=mttf, mttr_s=mttr,
                                   start_s=start)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 2)
    ref = jfaults.crash_restart_masks(key, jf, n_steps, dt)
    u, e = _ref_crash_draws(key, rows, n_steps)
    mine = faults.crash_restart_recurrence(
        torch.from_numpy(np.ascontiguousarray(u.T)), torch.from_numpy(np.ascontiguousarray(e.T)),
        *faults.crash_restart_params(_port_fault(jf), dt)).numpy()
    assert mine.dtype == bool and mine.shape == ref.shape == (rows, n_steps)
    np.testing.assert_array_equal(mine, ref)
    assert ref.any() and not ref[:, : int(np.ceil(start / dt))].any()


def test_crash_process_on_its_own_stream():
    """The port's own draws: downtime fraction ~ MTTR / (MTTF + MTTR), mean
    down run ~ MTTR in ticks, no run shorter than one tick (also with a
    repair time below a tick), deterministic per seed and device type."""
    g = lambda s: torch.Generator(device=CPU).manual_seed(s)
    f = faults.CrashRestartFault(servers=tuple(range(8)), mttf_s=300.0, mttr_s=100.0)
    m = faults.crash_restart_masks(g(0), f, 20_000, 1.0)
    assert m.shape == (8, 20_000) and m.dtype == bool
    assert m.mean() == pytest.approx(100.0 / 400.0, rel=0.1)
    runs = [e - s for row in m for s, e in trace._mask_intervals(row)]
    assert min(runs) >= 1 and np.mean(runs) == pytest.approx(100.0, rel=0.15)
    np.testing.assert_array_equal(m, faults.crash_restart_masks(g(0), f, 20_000, 1.0))
    assert not np.array_equal(m, faults.crash_restart_masks(g(1), f, 20_000, 1.0))
    short = faults.crash_restart_masks(
        g(2), faults.CrashRestartFault(servers=(0, 1), mttf_s=20.0, mttr_s=0.25), 5_000, 1.0)
    runs = [e - s for row in short for s, e in trace._mask_intervals(row)]
    assert runs and min(runs) >= 1


def test_build_schedule_per_fault_streams_and_validation(monkeypatch):
    """Each fault draws from its own (seed, index) stream: a crash fault's
    rows do not move when the fault before it draws more; schedules are
    deterministic per seed; out-of-range servers raise; without a card the
    schedule needs ``device="cpu"``."""
    second = faults.CrashRestartFault(servers=(5, 6, 7), mttf_s=80.0, mttr_s=20.0)
    a = schedule.build_schedule(
        [faults.CrashRestartFault(servers=(0,), mttf_s=80.0, mttr_s=20.0), second],
        8, 500, 1.0, seed=3, device=CPU)
    b = schedule.build_schedule(
        [faults.CrashRestartFault(servers=(0, 1, 2, 3), mttf_s=50.0, mttr_s=9.0), second],
        8, 500, 1.0, seed=3, device=CPU)
    c = schedule.build_schedule(
        [faults.CrashRestartFault(servers=(0,), mttf_s=80.0, mttr_s=20.0), second],
        8, 500, 1.0, seed=4, device=CPU)
    np.testing.assert_array_equal(a.down[5:], b.down[5:])
    assert a.down[5:].any() and (a.down != c.down).any()
    mix = schedule.standard_fault_mix(1.0, 8, 500.0)
    d1 = schedule.build_schedule(mix, 8, 500, 1.0, seed=0, device=CPU)
    d2 = schedule.build_schedule(mix, 8, 500, 1.0, seed=0, device=CPU)
    for f in ("down", "degrade", "stale"):
        np.testing.assert_array_equal(getattr(d1, f), getattr(d2, f))
    with pytest.raises(ValueError):
        schedule.build_schedule([faults.PartitionFault(servers=(9,), start_s=0.0,
                                                       duration_s=10.0)], 4, 100, 1.0,
                                device=CPU)
    with pytest.raises(TypeError):
        schedule.build_schedule([types.SimpleNamespace(servers=(0,))], 4, 100, 1.0, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule.build_schedule(mix, 8, 500, 1.0)


def test_build_schedule_deterministic_faults_equal_reference():
    """With no crash fault, the port's schedule equals the reference's."""
    horizon = 900.0
    jmix = [f for f in jschedule.standard_fault_mix(0.7, 12, horizon)
            if not isinstance(f, jfaults.CrashRestartFault)]
    js = jschedule.build_schedule(jmix, 12, 900, 1.0, seed=0)
    s = schedule.build_schedule([_port_fault(f) for f in jmix], 12, 900, 1.0, device=CPU)
    for f in ("down", "degrade", "stale"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    assert s.down.any() and s.stale.any() and (s.degrade > 1.0).any()


# ---------------------------------------------------------------------------
# schedule queries, the tracer, episodes under chaos
# ---------------------------------------------------------------------------

def _ref_schedule(n=6, n_steps=900, dt=1.0, x=1.0, seed=0):
    return jschedule.build_schedule(jschedule.standard_fault_mix(x, n, n_steps * dt),
                                    n, n_steps, dt, seed=seed)


def test_schedule_queries_equal_reference():
    js = _ref_schedule()
    s = _port_schedule(js)
    traces = np.random.default_rng(0).uniform(10.0, 400.0, (6, 900)).astype(np.float32)
    np.testing.assert_array_equal(s.apply_to_traces(traces), js.apply_to_traces(traces))
    np.testing.assert_array_equal(s.apply_staleness(traces), js.apply_staleness(traces))
    np.testing.assert_array_equal(s._fresh_idx, js._fresh_idx)
    ts = [-5, 0, 1, 300, 399, 450, 600, 899, 2000]
    for t in ts:
        np.testing.assert_array_equal(s.alive_at(t), js.alive_at(t))
        np.testing.assert_array_equal(s.age_s(t), js.age_s(t))
        assert [s.stale_at(i, t) for i in range(6)] == [js.stale_at(i, t) for i in range(6)]
    np.testing.assert_array_equal(s.ages_s(np.asarray(ts)), js.ages_s(np.asarray(ts)))
    assert (s.n_servers, s.n_steps) == (js.n_servers, js.n_steps)
    assert s.age_s(600).max() > 0.0 and not s.alive_at(450).all()
    with pytest.raises(ValueError, match="shapes"):
        schedule.ChaosSchedule(down=js.down, degrade=js.degrade[:, :5], stale=js.stale,
                               dt_s=1.0)


def test_emit_chaos_events_equals_reference():
    js = _ref_schedule(n=5, n_steps=300, x=0.9, seed=2)
    s = _port_schedule(js)
    a, b = trace.SpanTracer(enabled=True), jtrace.SpanTracer(enabled=True)
    trace.emit_chaos_events(a, s, 1.0)
    jtrace.emit_chaos_events(b, js, 1.0)
    assert a.events == b.events and len(a.events) > 10
    assert {e["name"] for e in a.events} == {"down", "inject:down", "degraded",
                                              "telemetry-stale"}
    row = np.asarray([0, 1, 1, 0, 1], bool)
    assert trace._mask_intervals(row) == jtrace._mask_intervals(row) == [(1, 3), (4, 5)]
    off = trace.SpanTracer(enabled=False)
    trace.emit_chaos_events(off, s, 1.0)
    trace.emit_chaos_events(a, None, 1.0)
    assert off.events == [] and len(a.events) == len(b.events)


WEB = ["search the web for current news", "look up live information online",
       "find real-time facts on the internet", "web search for fresh articles"]


@pytest.mark.parametrize("algo", ["prag", "sonar_lb", "sonar_ft"])
def test_agents_under_chaos_equal_reference(algo):
    """`Agent` and `BatchAgent` episodes on a chaos platform built from the
    reference's schedule: equal records and feed-forward histories, and the
    two port drivers agree (the scalar and batched paths of SONAR-FT's
    staleness discount and failed masks)."""
    n, horizon = 6, 600.0
    js = _ref_schedule(n=n, n_steps=600)
    jqueries = [JQuery(text=t, intent="websearch", answer="ok") for t in WEB] * 6
    queries = [Query(text=t, intent="websearch", answer="ok") for t in WEB] * 6
    kw = dict(scenario="ideal", seed=0, horizon_s=horizon, dt_s=1.0)

    def pair():
        jp = jplatform.NetMCPPlatform(jfleet.replica_fleet(n), chaos=js,
                                      profiles=[jlatency.ideal_profile()] * n, **kw)
        p = platform.NetMCPPlatform(fleet.replica_fleet(n), chaos=_port_schedule(js),
                                    profiles=[latency.ideal_profile()] * n, device=CPU, **kw)
        p.traces, p.observed = jp.traces, jp.observed.copy()
        return jp, p

    cfg, jcfg = routing.RoutingConfig(top_s=n, top_k=n), jrouting.RoutingConfig(top_s=n, top_k=n)
    jp, p = pair()
    ref = jagent.Agent(jp, jrouting.make_router(algo, jp.servers, jcfg), max_turns=4
                       ).run_benchmark(jqueries, ticks_per_query=16)
    recs = agent.Agent(p, routing.make_router(algo, p.servers, cfg), max_turns=4
                       ).run_benchmark(queries, ticks_per_query=16)
    jp2, p2 = pair()
    bref = jagent.BatchAgent(jp2, jmake_engine(algo, jp2.servers, jcfg), max_turns=4
                             ).run_benchmark(jqueries, ticks_per_query=16)
    brecs = agent.BatchAgent(p2, make_engine(algo, p2.servers, cfg, device=CPU), max_turns=4
                             ).run_benchmark(queries, ticks_per_query=16)
    for port, refr, pl, jpl in ((recs, ref, p, jp), (brecs, bref, p2, jp2)):
        for a, b in zip(port, refr):
            assert (a.final_server_idx, a.n_calls, a.n_failures, a.success) == (
                b.final_server_idx, b.n_calls, b.n_failures, b.success)
            assert [(d.server_idx, d.tool_idx) for d in a.decisions] == [
                (d.server_idx, d.tool_idx) for d in b.decisions]
            assert a.call_latencies_ms == b.call_latencies_ms
            np.testing.assert_allclose([d.network for d in a.decisions],
                                       [d.network for d in b.decisions], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(pl.observed, jpl.observed)
    for a, b in zip(recs, brecs):
        assert (a.final_server_idx, a.n_calls, a.success) == (b.final_server_idx, b.n_calls,
                                                             b.success)
    if algo == "prag":          # the semantic-only router meets the dead group
        assert sum(r.n_failures for r in recs) > 0
