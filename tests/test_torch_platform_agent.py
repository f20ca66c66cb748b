"""The port's paper harness against the JAX reference, on the CPU.

`repro_torch.core.{latency, platform, agent, metrics}` and the platform
builders of `repro_torch.traffic.fleet` are held to their `repro` twins.
The port draws its traces from a `torch.Generator` and the reference from
`jax.random`, whose streams cannot be reproduced, so the port's own traces
are checked by the five states' signatures and by the paper's headlines,
and every parity test copies the reference's traces into the port's
platform (``plat.traces`` / ``plat.observed``).  Records must match
exactly (servers, tools, calls, failures, success), completion times
within rel 1e-4, C, N and S within rtol 2e-6 / atol 2e-7.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import agent as jagent
from repro.core import dataset as jdataset
from repro.core import latency as jlatency
from repro.core import metrics as jmetrics
from repro.core import platform as jplatform
from repro.core import routing as jrouting
from repro.core.batch_routing import make_engine as jmake_engine
from repro.traffic import fleet as jfleet
from repro_torch.core import agent, dataset, latency, metrics, platform, routing
from repro_torch.core.batch_routing import make_engine
from repro_torch.traffic import fleet

RTOL, ATOL = 2e-6, 2e-7
SERVERS = dataset.build_server_pool(seed=0)
J_SERVERS = jdataset.build_server_pool(seed=0)
QUERIES = dataset.build_query_dataset(n=60, seed=0)
J_QUERIES = jdataset.build_query_dataset(n=60, seed=0)
CPU = "cpu"


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _pair(scenario, seed=1, **kw):
    """The reference's platform and the port's, the port holding the
    reference's traces and observed histories."""
    jp = jplatform.NetMCPPlatform(J_SERVERS, scenario=scenario, seed=seed, **kw)
    p = platform.NetMCPPlatform(SERVERS, scenario=scenario, seed=seed, device=CPU, **kw)
    p.traces = jp.traces
    p.observed = jp.observed.copy()
    return jp, p


def _same_records(port, ref, ctx):
    assert len(port) == len(ref), ctx
    for i, (a, b) in enumerate(zip(port, ref)):
        where = f"{ctx} task {i}"
        assert (a.final_server_idx, a.n_calls, a.n_failures, a.success) == (
            b.final_server_idx, b.n_calls, b.n_failures, b.success), where
        assert [(d.server_idx, d.tool_idx) for d in a.decisions] == [
            (d.server_idx, d.tool_idx) for d in b.decisions], where
        np.testing.assert_allclose([d.expertise for d in a.decisions],
                                   [d.expertise for d in b.decisions], rtol=RTOL, atol=ATOL,
                                   err_msg=where)
        np.testing.assert_allclose([d.network for d in a.decisions],
                                   [d.network for d in b.decisions], rtol=RTOL, atol=ATOL,
                                   err_msg=where)
        np.testing.assert_allclose([d.fused for d in a.decisions],
                                   [d.fused for d in b.decisions], rtol=RTOL, atol=ATOL,
                                   err_msg=where)
        assert a.call_latencies_ms == b.call_latencies_ms, where
        assert a.select_latency_ms == b.select_latency_ms, where
        assert a.completion_ms == pytest.approx(b.completion_ms, rel=1e-4), where
        assert a.final_expertise == pytest.approx(b.final_expertise, rel=RTOL, abs=ATOL), where
        assert a.query.text == b.query.text, where


def _same_report(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k] == pytest.approx(fb[k], rel=1e-6, abs=1e-9), k


# ---------------------------------------------------------------------------
# latency: the port's own traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1234, 7])
def test_traces_show_state_signatures(seed):
    """Each canonical state shows its defining statistic in the port's own
    traces (as `test_golden_traces.py` checks the reference's fixtures),
    over the fixtures' 1024 ticks of 10 s."""
    names = sorted(latency.STATE_FACTORIES)
    packed = latency.pack_profiles([latency.STATE_FACTORIES[n]() for n in names])
    tr = latency.generate_traces(_gen(seed), torch.from_numpy(packed), 1024, 10.0)
    assert tr.dtype == torch.float32 and tr.shape == (5, 1024)
    g = {n: tr[i].numpy() for i, n in enumerate(names)}
    assert g["ideal"].mean() < 60.0
    assert g["high_latency"].mean() > 250.0
    assert g["high_jitter"].std() > 50.0
    assert (g["outage"] >= 999.0).mean() > 0.2
    assert g["fluctuating"].max() - g["fluctuating"].min() > 200.0
    assert all(v.min() >= 1.0 for v in g.values())          # floor_ms
    one = latency.generate_trace(_gen(seed), torch.from_numpy(packed[2]), 1024, 10.0)
    assert one.shape == (1024,)


def test_outage_recurrence_and_hazard_rule():
    """The outage mask is the reference's semi-Markov recurrence on the
    port's uniforms, replayed here in plain Python from a generator seeded
    alike; probability 0 never enters an outage, probability 1 is clipped
    (the reference's hazard rule); the stationary fraction is near p."""
    profs = [
        latency.outage_profile(probability=0.5),
        latency.outage_profile(probability=0.0),
        latency.outage_profile(probability=1.0, duration_min_s=60.0, duration_max_s=90.0),
        latency.outage_profile(probability=0.2, duration_min_s=5.0, duration_max_s=5.0),
        latency.ideal_profile(),
    ]
    prof = torch.from_numpy(latency.pack_profiles(profs))
    n_steps, dt = 3000, 10.0
    mask = latency._outage_mask(_gen(3), prof, n_steps, dt).numpy()
    g = _gen(3)
    u_enter = torch.rand((n_steps, len(profs)), generator=g).numpy()
    u_dur = torch.rand((n_steps, len(profs)), generator=g).numpy()
    P = prof.numpy()
    for s in range(len(profs)):
        p = np.float32(P[s, 5])
        dmin = np.maximum(np.float32(P[s, 6] / dt), np.float32(1.0))
        dmax = np.maximum(np.float32(P[s, 7] / dt), dmin)
        mean_dur = np.float32(0.5) * (dmin + dmax)
        pc = np.clip(p, np.float32(1e-6), np.float32(1.0 - 1e-6))
        hz = pc / (mean_dur * (np.float32(1.0) - pc))
        hz = np.float32(0.0) if p <= 0.0 else np.clip(hz, np.float32(0.0), np.float32(1.0))
        rem, want = np.float32(0.0), []
        for t in range(n_steps):
            start = rem <= 0.0 and u_enter[t, s] < hz
            new = dmin + np.float32(u_dur[t, s]) * (dmax - dmin)
            rem = new if start else max(rem - np.float32(1.0), np.float32(0.0))
            want.append(rem > 0.0)
        np.testing.assert_array_equal(mask[s], want, err_msg=f"server {s}")
    assert not mask[1].any() and not mask[4].any()
    # hazard clipped to 1: a new outage starts on the tick after the last
    # one ends, so of each cycle of 7-10 ticks only one is up
    assert mask[2].mean() > 0.8
    assert abs(mask[0].mean() - 0.5) < 0.2
    # a trace draws its noise first, then its outage mask: in outage it is
    # pinned at the severity
    g = _gen(3)
    torch.randn((len(profs), n_steps), generator=g)
    m2 = latency._outage_mask(g, prof, n_steps, dt).numpy()
    tr = latency.generate_traces(_gen(3), prof, n_steps, dt).numpy()
    sev = np.broadcast_to(P[:, 8:9], tr.shape)
    assert m2.any()
    np.testing.assert_array_equal(tr[m2], sev[m2])


def test_traces_cached_per_seed_and_device_type():
    packed = latency.pack_profiles([latency.ideal_profile(), latency.high_jitter_profile()])
    a = latency.generate_traces_cached(5, packed, 64, device=CPU)
    b = latency.generate_traces_cached(5, packed, 64, device=CPU)
    c = latency.generate_traces_cached(6, packed, 64, device=CPU)
    assert a is b and not a.flags.writeable and a.dtype == np.float32 and a.shape == (2, 64)
    assert not np.array_equal(a, c)
    g = _gen(5)
    np.testing.assert_array_equal(a, latency.generate_traces(g, torch.from_numpy(packed), 64)
                                  .numpy())
    keys = [k for k in latency._TRACE_CACHE if k[0] == 5 and k[2] == 64]
    assert keys and all(k[-1] == "cpu" for k in keys)     # the device type is in the key
    assert latency.trace_horizon_steps() == jlatency.trace_horizon_steps() == 8640
    for name, fn in latency.STATE_FACTORIES.items():
        assert fn().as_array().tobytes() == jlatency.STATE_FACTORIES[name]().as_array().tobytes()


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = latency.pack_profiles([latency.ideal_profile()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        latency.generate_traces_cached(99, packed, 16)
    with pytest.raises(RuntimeError):
        platform.NetMCPPlatform(SERVERS, scenario="ideal", seed=99)
    with pytest.raises(RuntimeError):
        fleet.ideal_platform(fleet.replica_fleet(2), seed=99)


# ---------------------------------------------------------------------------
# platform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", sorted(platform.SCENARIOS))
def test_scenario_profiles_equal_reference(scenario):
    mine = platform.SCENARIOS[scenario](SERVERS)
    ref = jplatform.SCENARIOS[scenario](J_SERVERS)
    assert latency.pack_profiles(mine).tobytes() == jlatency.pack_profiles(ref).tobytes()
    assert platform._semantic_rank_websearch(SERVERS) == jplatform._semantic_rank_websearch(
        J_SERVERS)


def test_platform_windows_ages_and_feed_forward_equal_reference():
    jp, p = _pair("hybrid")
    ts = [0, 10, 62, 63, 64, 5000, 8639, 9000, -3]
    for t in ts:
        np.testing.assert_array_equal(p.latency_window(t), jp.latency_window(t))
        np.testing.assert_array_equal(p.latency_window(t, 8), jp.latency_window(t, 8))
    tv = np.asarray(ts)
    np.testing.assert_array_equal(p.latency_windows(tv), jp.latency_windows(tv))
    np.testing.assert_array_equal(p.latency_windows(tv, 5), jp.latency_windows(tv, 5))
    np.testing.assert_array_equal(p.telemetry_age_s(7), jp.telemetry_age_s(7))
    np.testing.assert_array_equal(p.telemetry_ages_s(tv), jp.telemetry_ages_s(tv))
    np.testing.assert_array_equal(p.alive_mask(7), jp.alive_mask(7))
    assert p.is_alive(3, 7) and p.client_rtt_ms(0) is None
    assert p.latency_at(2, 100) == jp.latency_at(2, 100) == p.total_latency_at(2, 100)
    # feed-forward writes, scalar and vectorized
    for plat in (p, jp):
        plat.record_observation(4, 70, 1234.5)
        plat.record_observations(np.array([0, 1, 1]), np.array([3, 9000, 50]),
                                 np.array([5.0, 6.0, 7.0]))
    np.testing.assert_array_equal(p.observed, jp.observed)
    assert p.obs_version == jp.obs_version == 2
    np.testing.assert_array_equal(p.latency_window(70), jp.latency_window(70))


def test_tiled_platform_windows_overlay_and_compact_equal_reference():
    """Template-tiled mode (`mega_platform`): windows densified from the
    template rows, compact windows, and copy-on-write feed-forward rows."""
    jp = jfleet.mega_platform(1000, horizon_s=300.0)
    p = fleet.mega_platform(1000, horizon_s=300.0, device=CPU)
    assert latency.pack_profiles(p.profiles).tobytes() == jlatency.pack_profiles(
        jp.profiles).tobytes()
    np.testing.assert_array_equal(p.template_map, jp.template_map)
    assert p.traces.shape == (16, 300) and p.n_servers == 1000
    p.traces, p.observed = jp.traces, jp.observed.copy()
    for t in (5, 200):
        c, m = p.compact_window(t, 32)
        jc, jm = jp.compact_window(t, 32)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(m, jm)
    for plat in (p, jp):
        plat.record_observation(17, 20, 999.0)
        plat.record_observations(np.array([3, 17]), np.array([21, 22]), np.array([1.5, 2.5]))
    tv = np.array([0, 21, 40, 299])
    for t in tv:
        np.testing.assert_array_equal(p.latency_window(int(t), 16), jp.latency_window(int(t), 16))
    np.testing.assert_array_equal(p.latency_windows(tv, 16), jp.latency_windows(tv, 16))
    assert p.latency_at(17, 20) == jp.latency_at(17, 20)
    with pytest.raises(ValueError, match="feed-forward"):
        p.compact_window(5)


def test_fleet_builders_equal_reference():
    for n, seed in ((16, 0), (7, 3)):
        a, b = fleet.telemetry_palette(n, seed), jfleet.telemetry_palette(n, seed)
        assert latency.pack_profiles(a).tobytes() == jlatency.pack_profiles(b).tobytes()
    reps = fleet.replica_fleet(3)
    ip = fleet.ideal_platform(reps, seed=2, device=CPU)
    jip = jfleet.ideal_platform(jfleet.replica_fleet(3), seed=2)
    assert ip.traces.shape == jip.traces.shape == (3, 900) and ip.dt_s == 1.0
    assert latency.pack_profiles(ip.profiles).tobytes() == jlatency.pack_profiles(
        jip.profiles).tobytes()


def test_readme_example_on_the_port():
    """The README's first example, line for line on `repro_torch` (with
    ``device="cpu"``): the per-query window slab equals the windows, and the
    engine routes them as the reference's engine does."""
    plat = platform.NetMCPPlatform(SERVERS, scenario="hybrid", seed=1, device=CPU)
    dec = make_engine("sonar", SERVERS, device=CPU).route_texts(
        ["search the web for the latest news"], plat.latency_window(3000))
    assert dec.server_idx.shape == (1,) and 0 <= dec.server_idx[0] < len(SERVERS)
    jp, p = _pair("hybrid")
    tv = np.asarray([100, 2000, 4000, 6000])
    q = [QUERIES[0].text] * len(tv)
    d = make_engine("sonar", SERVERS, device=CPU).route_texts(q, p.latency_windows(tv))
    jd = jmake_engine("sonar", J_SERVERS).route_texts(q, jp.latency_windows(tv))
    np.testing.assert_array_equal(d.server_idx, jd.server_idx)
    np.testing.assert_allclose(d.network, jd.network, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# agents and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["hybrid", "fluctuating"])
@pytest.mark.parametrize("algo", ["prag", "sonar", "sonar_ft"])
def test_agents_equal_reference_and_each_other(scenario, algo):
    """`Agent` and `BatchAgent` give the JAX drivers' records on the
    reference's traces, and the two port drivers give the same records
    (`tests/test_batch_routing.py::test_batch_agent_matches_scalar_agent`)."""
    jp, p = _pair(scenario)
    ref = jagent.Agent(jp, jrouting.make_router(algo, J_SERVERS)).run_benchmark(
        J_QUERIES, ticks_per_query=60)
    recs = agent.Agent(p, routing.make_router(algo, SERVERS)).run_benchmark(
        QUERIES, ticks_per_query=60)
    _same_records(recs, ref, f"{algo} {scenario} Agent")
    np.testing.assert_array_equal(p.observed, jp.observed)

    jp2, p2 = _pair(scenario)
    jref = jagent.BatchAgent(jp2, jmake_engine(algo, J_SERVERS)).run_benchmark(
        J_QUERIES, ticks_per_query=60)
    brecs = agent.BatchAgent(p2, make_engine(algo, SERVERS, device=CPU)).run_benchmark(
        QUERIES, ticks_per_query=60)
    _same_records(brecs, jref, f"{algo} {scenario} BatchAgent")
    np.testing.assert_array_equal(p2.observed, jp2.observed)
    for a, b in zip(recs, brecs):
        assert (a.final_server_idx, a.n_calls, a.n_failures, a.success) == (
            b.final_server_idx, b.n_calls, b.n_failures, b.success)
        assert a.completion_ms == pytest.approx(b.completion_ms, rel=1e-4)
    m, jm, bm = (metrics.evaluate(recs, SERVERS), jmetrics.evaluate(ref, J_SERVERS),
                 metrics.evaluate(brecs, SERVERS))
    _same_report(m, jm)
    assert (m.ssr, m.fr, m.n_calls) == (bm.ssr, bm.fr, bm.n_calls)
    assert m.row(algo) == jm.row(algo) and metrics.Report.HEADER == jmetrics.Report.HEADER


def test_agent_hedging_and_retry_budget_equal_reference():
    jp, p = _pair("hybrid")
    kw = dict(max_turns=5, hedge_ms=200.0, retry_budget=2)
    for algo in ("prag", "sonar_ft"):
        ref = jagent.Agent(jp, jrouting.make_router(algo, J_SERVERS), **kw).run_benchmark(
            J_QUERIES[:30], ticks_per_query=60, seed=4)
        recs = agent.Agent(p, routing.make_router(algo, SERVERS), **kw).run_benchmark(
            QUERIES[:30], ticks_per_query=60, seed=4)
        _same_records(recs, ref, f"{algo} hedged")
        if algo == "prag":      # PRAG meets the outage server: hedges and retries
            assert any(r.n_calls > len(r.decisions) or len(r.decisions) > 1 for r in recs)
    np.testing.assert_array_equal(
        agent.spread_start_ticks(50, 8640, 8, 1, 3, 200, 9),
        jagent.spread_start_ticks(50, 8640, 8, 1, 3, 200, 9))


def test_metrics_evaluate_equal_reference_on_seeded_records():
    rng = np.random.default_rng(11)

    def records(mod, queries):
        out = []
        for q in queries:
            n = int(rng.integers(1, 4))
            out.append(mod.TaskRecord(
                query=q, success=bool(rng.random() < 0.7), n_calls=n,
                n_failures=int(rng.integers(0, n + 1)), decisions=[],
                call_latencies_ms=list(rng.uniform(5.0, 1200.0, n)),
                select_latency_ms=float(rng.uniform(300.0, 20_000.0)),
                completion_ms=float(rng.uniform(100.0, 9000.0)),
                final_server_idx=int(rng.integers(0, len(SERVERS))),
                final_expertise=float(rng.random())))
        return out

    state = rng.bit_generator.state
    mine = records(agent, QUERIES[:25])
    rng.bit_generator.state = state
    ref = records(jagent, J_QUERIES[:25])
    _same_report(metrics.evaluate(mine, SERVERS), jmetrics.evaluate(ref, J_SERVERS))
    assert dataclasses.asdict(metrics.evaluate(mine, SERVERS)) == dataclasses.asdict(
        jmetrics.evaluate(ref, J_SERVERS))


# ---------------------------------------------------------------------------
# the paper's headlines on the port's own traces
# ---------------------------------------------------------------------------

def _bench(scenario, algo, batch, seed=1):
    plat = platform.NetMCPPlatform(SERVERS, scenario=scenario, seed=seed, device=CPU)
    if batch:
        drv = agent.BatchAgent(plat, make_engine(algo, SERVERS, device=CPU))
    else:
        drv = agent.Agent(plat, routing.make_router(algo, SERVERS))
    return metrics.evaluate(drv.run_benchmark(QUERIES, ticks_per_query=60), SERVERS)


@pytest.mark.parametrize("batch", [False, True], ids=["agent", "batch_agent"])
def test_table2_hybrid_sonar_zero_failures(batch):
    """Table II headline: SONAR 0 % FR against PRAG's > 50 % at matched SSR."""
    prag, sonar = _bench("hybrid", "prag", batch), _bench("hybrid", "sonar", batch)
    assert sonar.fr == 0.0
    assert prag.fr > 50.0
    assert abs(sonar.ssr - prag.ssr) < 10.0
    assert sonar.al_ms < 50.0
    assert prag.al_ms > 500.0


@pytest.mark.parametrize("batch", [False, True], ids=["agent", "batch_agent"])
def test_table3_fluctuating_sonar_cuts_latency(batch):
    prag, sonar = _bench("fluctuating", "prag", batch), _bench("fluctuating", "sonar", batch)
    assert sonar.al_ms < 0.6 * prag.al_ms
    assert abs(sonar.ssr - prag.ssr) < 10.0


@pytest.mark.parametrize("batch", [False, True], ids=["agent", "batch_agent"])
def test_ideal_sonar_equals_prag(batch):
    prag, sonar = _bench("ideal", "prag", batch), _bench("ideal", "sonar", batch)
    assert abs(sonar.ssr - prag.ssr) < 5.0
    assert abs(sonar.al_ms - prag.al_ms) < 10.0


def test_agent_retries_feeds_forward_and_runs_live_mode():
    plat = platform.NetMCPPlatform(SERVERS, scenario="hybrid", seed=1, device=CPU)
    recs = agent.Agent(plat, routing.make_router("prag", SERVERS), max_turns=5).run_benchmark(
        QUERIES[:30], ticks_per_query=60)
    assert any(r.n_calls > 1 for r in recs) and all(r.n_calls <= 5 for r in recs)
    r = routing.make_router("sonar", SERVERS)
    d = r.select(QUERIES[0].text, plat.latency_window(50))
    res = plat.call_tool(d, QUERIES[0], 50)
    assert plat.observed[d.server_idx, 50] == res.latency_ms

    calls = []

    def transport(server, decision, query):
        calls.append(server.name)
        return query.answer, 42.0

    live = platform.NetMCPPlatform(SERVERS, scenario="ideal", seed=0, mode="live",
                                   live_transport=transport, device=CPU)
    d = routing.make_router("prag", SERVERS).select(QUERIES[0].text, live.latency_window(10))
    res = live.call_tool(d, QUERIES[0], 10)
    assert calls and res.latency_ms == 42.0 and res.success
    with pytest.raises(ValueError):
        agent.BatchAgent(live, make_engine("sonar", SERVERS, device=CPU))
    with pytest.raises(ValueError):
        platform.NetMCPPlatform(SERVERS, mode="batch", device=CPU)
