"""The port's serving gateway, micro-batcher and front end against the JAX
reference, on the CPU.

`repro_torch.serving.{gateway, microbatch, frontend}`, the arrival
processes and live sources of `repro_torch.traffic`, the warmth tracker
and the span emitters are held to their `repro` twins.  The port draws its
traces and arrivals from a `torch.Generator`; parity tests copy the
reference's traces into the port's gateway (`_adopt_traces`) and replay
the reference's request schedules, so both sides see the same inputs.
Picks, outcomes, health state, telemetry and `report()` must be equal;
C and N within rtol 2e-6 / atol 2e-7.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import latency as jlatency
from repro.obs import Observability as JObservability
from repro.obs import trace as jtrace
from repro.serving import gateway as jgateway
from repro.serving import microbatch as jmicro
from repro.sessions.warmth import WarmthTracker as JWarmth
from repro.traffic import arrivals as jarrivals
from repro.traffic import source as jsource
from repro_torch.core import latency
from repro_torch.core.batch_routing import make_engine
from repro_torch.obs import DeviceRouteStats, Observability, trace
from repro_torch.serving import gateway
from repro_torch.serving.frontend import AsyncServingGateway
from repro_torch.serving.microbatch import BatchingPolicy, MicroBatcher, MicroBatchPump
from repro_torch.sessions import WarmthTracker
from repro_torch.traffic import arrivals
from repro_torch.traffic.source import LiveRequest, request_schedule

RTOL, ATOL = 2e-6, 2e-7
CPU = "cpu"
TEXTS = [
    "search the web for the latest news",
    "what is the weather forecast tomorrow",
    "find recent articles about machine learning research",
]
ARCHS = [("yi-6b", "dense"), ("deepseek-moe-16b", "moe"), ("whisper-tiny", "audio"),
         ("yi-6b", "dense"), ("internvl2-1b", "vlm")]
STATES = ["ideal_profile", "high_latency_profile", "fluctuating_profile", "outage_profile",
          "ideal_profile"]


def _profiles(mod, states=STATES, **outage_kw):
    return [getattr(mod, s)(**(outage_kw if s == "outage_profile" else {})) for s in states]


def _adopt_traces(gw, ref):
    """Give the port's gateway the reference gateway's traces, and the
    telemetry window they start it with."""
    gw.traces = ref.traces
    init = ref.traces[:, :gw.history]
    if isinstance(gw._telemetry, gateway.DeviceTelemetry):
        gw._telemetry = gateway.DeviceTelemetry(init, gw.telemetry_dtype, device=CPU)
    else:
        gw._telemetry = gateway._HostTelemetry(init, gw.telemetry_dtype)
    np.testing.assert_array_equal(gw.telemetry, ref.telemetry)
    return gw


def _pair(archs=ARCHS, states=STATES, outage_kw=None, **kw):
    kw.setdefault("use_kernels", True)
    ref = jgateway.SonarGateway(jgateway.replica_pool(archs),
                                profiles=_profiles(jlatency, states, **(outage_kw or {})),
                                mesh=None, **kw)
    gw = gateway.SonarGateway(gateway.replica_pool(archs),
                              profiles=_profiles(latency, states, **(outage_kw or {})),
                              device=CPU, **kw)
    return _adopt_traces(gw, ref), ref


def _same_results(port, ref, ctx):
    assert [r.replica_idx for r in port] == [r.replica_idx for r in ref], ctx
    assert [(r.latency_ms, r.ok) for r in port] == [(r.latency_ms, r.ok) for r in ref], ctx
    np.testing.assert_allclose([r.expertise for r in port], [r.expertise for r in ref],
                               rtol=RTOL, atol=ATOL, err_msg=ctx)
    np.testing.assert_allclose([r.network for r in port], [r.network for r in ref],
                               rtol=RTOL, atol=ATOL, err_msg=ctx)


def _same_state(gw, ref, ctx):
    assert gw.t == ref.t, ctx
    np.testing.assert_array_equal(gw.in_flight, ref.in_flight, err_msg=ctx)
    np.testing.assert_array_equal(gw.fail_streak, ref.fail_streak, err_msg=ctx)
    np.testing.assert_array_equal(gw.ejected, ref.ejected, err_msg=ctx)
    np.testing.assert_array_equal(gw.telemetry, ref.telemetry, err_msg=ctx)
    assert gw.report() == ref.report(), ctx


def _port_requests(reqs):
    return [LiveRequest(**dataclasses.asdict(r)) for r in reqs]


# ---------------------------------------------------------------------------
# arrivals, sources, warmth
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


@pytest.mark.parametrize("name", sorted(arrivals.ARRIVAL_PROCESSES))
def test_arrival_streams_by_distribution(name):
    """The port's streams: sorted float64 on [0, horizon), deterministic per
    seed, with the process's mean count (within 5 standard deviations of a
    Poisson count; the bursty MMPP, over many of its 140 s cycles, within
    20 %); the reference's streams from JAX keys meet the same bound."""
    rate, horizon = (10.0, 1200.0) if name == "mmpp" else (40.0, 60.0)
    fn, jfn = arrivals.ARRIVAL_PROCESSES[name], jarrivals.ARRIVAL_PROCESSES[name]
    counts = []
    for seed in range(6):
        t = fn(_gen(seed), rate, horizon)
        assert t.dtype == np.float64 and np.all(np.diff(t) >= 0.0)
        assert t.size == 0 or (t[0] >= 0.0 and t[-1] < horizon)
        counts.append(t.size)
    np.testing.assert_array_equal(fn(_gen(3), rate, horizon), fn(_gen(3), rate, horizon))
    assert not np.array_equal(fn(_gen(3), rate, horizon), fn(_gen(4), rate, horizon))
    tau = horizon / 8.0
    if name == "flash_crowd":
        # base rate plus the spike's mass: rate * (h + spike * tau * (1 - e^(-2h/3 / tau)))
        mean = rate * (horizon + 8.0 * tau * (1.0 - np.exp(-(2.0 * horizon / 3.0) / tau)))
    else:
        mean = rate * horizon
    spread = 0.2 * mean if name == "mmpp" else 5.0 * np.sqrt(mean)
    assert abs(np.mean(counts) - mean) < spread, (name, counts, mean)
    j = [jfn(jax.random.PRNGKey(s), rate, horizon).size for s in range(3)]
    assert abs(np.mean(j) - mean) < spread, (name, j, mean)
    if name == "flash_crowd":           # denser after the spike than before it
        t = fn(_gen(0), rate, horizon)
        before = np.sum(t < horizon / 3.0) / (horizon / 3.0)
        after = np.sum((t >= horizon / 3.0) & (t < horizon / 3.0 + tau)) / tau
        assert after > 2.0 * before


def test_homogeneous_gaps_and_merge():
    t = arrivals.poisson_arrivals(_gen(1), 200.0, 50.0)
    gaps = np.diff(t)
    assert abs(gaps.mean() - 1.0 / 200.0) < 0.05 / 200.0 * 10
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05          # exponential: CV 1
    assert arrivals.poisson_arrivals(_gen(1), 0.0, 5.0).size == 0
    m = arrivals.merge_arrivals(t[:5], np.array([0.0001, 49.0]))
    np.testing.assert_array_equal(m, jarrivals.merge_arrivals(t[:5], np.array([0.0001, 49.0])))
    assert arrivals.merge_arrivals().size == 0


def test_request_schedule_equals_reference_on_a_time_array():
    times = np.array([0.5, 0.001, 0.2, 0.2, 1.7])
    kw = dict(deadline_ms=25.0, regions=np.array([1, -1, 0]))
    mine = request_schedule(times, None, 0.0, 0.0, TEXTS, **kw)
    ref = jsource.request_schedule(times, None, 0.0, 0.0, TEXTS, **kw)
    assert [dataclasses.asdict(r) for r in mine] == [dataclasses.asdict(r) for r in ref]
    named = request_schedule("poisson", _gen(2), 300.0, 0.2, TEXTS)
    assert [r.rid for r in named] == list(range(len(named))) and len(named) > 20
    assert all(r.deadline_ms is None and r.region == -1 for r in named)
    with pytest.raises(ValueError):
        request_schedule(times, None, 0.0, 0.0, [])


def test_warmth_tracker_equals_reference():
    rng = np.random.default_rng(0)
    a, b = WarmthTracker(7, half_life_ms=20.0), JWarmth(7, half_life_ms=20.0)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0.0, 15.0))
        sid, srv = int(rng.integers(0, 4)), int(rng.integers(0, 7))
        op = rng.random()
        if op < 0.5:
            a.touch(sid, srv, now)
            b.touch(sid, srv, now)
        elif op < 0.95:
            wa, wb = a.warmth(sid, now), b.warmth(sid, now)
            assert (wa is None) == (wb is None)
            if wa is not None:
                assert wa.tobytes() == wb.tobytes()
        else:
            a.forget(sid)
            b.forget(sid)
        assert len(a) == len(b)


# ---------------------------------------------------------------------------
# MicroBatcher: the policy state machine
# ---------------------------------------------------------------------------

def test_batcher_triggers_and_validation():
    pol = BatchingPolicy(max_batch=3, max_wait_ms=10.0, slack_ms=2.0, queue_limit=8)
    b = MicroBatcher(pol)
    assert b.next_trigger_ms(0.0) is None
    b.offer(LiveRequest(rid=0, text="a", t_ms=1.0), 1.0)
    assert b.next_trigger_ms(1.0) == 11.0                 # age: 1 + 10
    b.offer(LiveRequest(rid=1, text="b", t_ms=2.0, deadline_ms=8.0), 2.0)
    assert b.next_trigger_ms(2.0) == 6.0                  # deadline: 8 - 2
    b.offer(LiveRequest(rid=2, text="c", t_ms=3.0), 3.0)
    assert b.next_trigger_ms(3.0) == 3.0                  # size: full now
    assert [r.rid for r in b.take(4.0)] == [0, 1, 2]
    b.check_accounting()
    for bad in (dict(max_batch=0), dict(max_batch=8, queue_limit=4), dict(max_wait_ms=-1.0)):
        with pytest.raises(ValueError):
            BatchingPolicy(**bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batcher_equals_reference_under_random_traffic(seed):
    """Offers, takes and drops in a seeded order: the port's and the
    reference's state machines shed, expire and take the same requests,
    and their registries count the same."""
    rng = np.random.default_rng(seed)
    pol_kw = dict(max_batch=4, max_wait_ms=3.0, slack_ms=1.0, queue_limit=6)
    obs, jobs = Observability(), JObservability()
    a = MicroBatcher(BatchingPolicy(**pol_kw), registry=obs.registry)
    b = jmicro.MicroBatcher(jmicro.BatchingPolicy(**pol_kw), registry=jobs.registry)
    now, rid = 0.0, 0
    for _ in range(200):
        now += float(rng.exponential(0.7))
        op = rng.random()
        if op < 0.7:
            dl = None if rng.random() < 0.5 else now + float(rng.uniform(0.0, 6.0))
            req = dict(rid=rid, text=TEXTS[rid % 3], t_ms=now, deadline_ms=dl)
            rid += 1
            assert a.offer(LiveRequest(**req), now) == b.offer(jsource.LiveRequest(**req), now)
        elif op < 0.97:
            assert a.next_trigger_ms(now) == b.next_trigger_ms(now)
            assert [r.rid for r in a.take(now)] == [r.rid for r in b.take(now)]
            assert [r.rid for r in a.take_expired()] == [r.rid for r in b.take_expired()]
        else:
            assert [r.rid for r in a.drop_pending()] == [r.rid for r in b.drop_pending()]
        a.check_accounting()
    assert (a.n_offered, a.n_shed, a.n_expired, a.n_taken, a.n_pending) == (
        b.n_offered, b.n_shed, b.n_expired, b.n_taken, b.n_pending)
    assert a.n_shed > 0 and a.n_expired > 0
    assert obs.registry.snapshot() == jobs.registry.snapshot()


# ---------------------------------------------------------------------------
# MicroBatchPump on a port gateway
# ---------------------------------------------------------------------------

def _gateway(seed=0, n=4, algo="sonar_lb", **kw):
    return gateway.SonarGateway(
        gateway.replica_pool([("yi-6b", "dense")] * n),
        profiles=[latency.ideal_profile() for _ in range(n)],
        algo=algo, seed=seed, use_kernels=True, device=CPU, **kw)


def _burst(n, t_ms=0.0, deadline_ms=None, spacing_ms=0.01):
    return [LiveRequest(rid=i, text=TEXTS[i % len(TEXTS)], t_ms=t_ms + i * spacing_ms,
                        deadline_ms=deadline_ms) for i in range(n)]


def test_pump_policy_edges():
    """Empty drain, whole batch expired, a lone request flushed on age,
    shedding past the queue bound, and a burst degrading to back-to-back
    full flushes one service time apart."""
    pump = MicroBatchPump(_gateway(), BatchingPolicy(max_batch=4), service_ms=lambda t: 1.0)
    rep = pump.replay([])
    assert rep.n_offered == rep.n_routed == rep.n_shed == 0 and rep.n_flushes == 0
    assert rep.sustained_qps == 0.0 and MicroBatcher(BatchingPolicy()).take(0.0) == []

    sched = [LiveRequest(rid=i, text=TEXTS[i % 3], t_ms=0.1 * i, deadline_ms=5.0)
             for i in range(6)]
    rep = MicroBatchPump(_gateway(), BatchingPolicy(max_batch=32, max_wait_ms=1000.0),
                         service_ms=lambda t: 1.0).replay(sched)
    assert rep.n_routed == 0 and rep.n_expired == 6 and all(r.expired for r in rep.results)

    rep = MicroBatchPump(_gateway(), BatchingPolicy(max_batch=8, max_wait_ms=5.0),
                         service_ms=lambda t: 1.0).replay(
        [LiveRequest(rid=0, text=TEXTS[0], t_ms=2.0)])
    (res,) = rep.results
    assert res.replica_idx >= 0 and res.batch_size == 1
    assert res.t_routed_ms == pytest.approx(7.0) and res.wait_ms == pytest.approx(5.0)

    rep = MicroBatchPump(_gateway(), BatchingPolicy(max_batch=4, max_wait_ms=2.0, queue_limit=4),
                         service_ms=lambda t: 50.0).replay(_burst(40))
    assert rep.n_shed > 0 and rep.n_offered == rep.n_routed + rep.n_shed + rep.n_expired == 40
    assert all(r.replica_idx == -1 for r in rep.results if r.shed)

    pump = MicroBatchPump(_gateway(), BatchingPolicy(max_batch=8, max_wait_ms=2.0,
                                                     queue_limit=64),
                          service_ms=lambda t: 10.0)
    rep = pump.replay(_burst(24))
    assert rep.n_routed == 24 and [len(b) for b in pump.flush_log] == [8, 8, 8]
    assert np.allclose(np.diff(sorted({r.t_routed_ms for r in rep.results})), 10.0)

    gw = _gateway()
    gw.use_kernels = False
    for cls in (MicroBatchPump, AsyncServingGateway):
        with pytest.raises(ValueError):
            cls(gw)


@pytest.mark.parametrize("algo,max_batch,pad", [
    ("sonar", 3, False), ("sonar_lb", 5, True), ("sonar_ft", 2, True), ("sonar_geo", 4, False),
    ("sonar_adapt", 6, True)])
def test_pump_equals_direct_route_batch_on_its_flushes(algo, max_batch, pad):
    """Coalescing changes when requests route, never where: the pump's
    picks and end state equal direct `route_batch` calls over its flush
    partitions (`tests/test_parity_prop.py::
    test_microbatch_parity_with_direct_route_batch`), with and without
    padding every flush to ``max_batch`` rows."""
    rng = np.random.default_rng(max_batch)
    rr = rng.uniform(1.0, 200.0, (2, 5)).astype(np.float32)

    def fresh():
        return gateway.SonarGateway(
            gateway.replica_pool(ARCHS), profiles=_profiles(latency, probability=0.8),
            algo=algo, seed=3, use_kernels=True, region_rtt_ms=rr, eject_after=2, device=CPU)

    sched = request_schedule("poisson", _gen(max_batch), 300.0, 0.15, TEXTS,
                             deadline_ms=8.0, regions=rng.integers(0, 2, 16))
    pol = BatchingPolicy(max_batch=max_batch, max_wait_ms=2.0, slack_ms=0.5,
                         queue_limit=max(max_batch, 16), pad_batches=pad)
    pump = MicroBatchPump(fresh(), pol, service_ms=lambda t: float(rng.uniform(0.5, 4.0)))
    rep = pump.replay(sched)
    ref = fresh()
    want = {}
    for batch in pump.flush_log:
        out = ref.route_batch([r.text for r in batch], client_regions=[r.region for r in batch])
        want.update({req.rid: res.replica_idx for req, res in zip(batch, out)})
    routed = [r for r in rep.results if not r.shed and not r.expired]
    assert {r.rid: r.replica_idx for r in routed} == want and routed
    gw = pump.gw
    assert gw.t == ref.t
    for f in ("in_flight", "fail_streak", "ejected", "telemetry"):
        np.testing.assert_array_equal(getattr(gw, f), getattr(ref, f), err_msg=f)
    assert len(pump.flush_phases) == rep.n_flushes
    if algo == "sonar_adapt":
        assert [w for _, w in pump.weight_log] and pump.weight_log[0][0] == 0


def test_pump_replay_equals_reference_pump():
    """The same schedule (the reference's, from a JAX key) through the port's
    pump and the reference's, on the same traces and a fixed service time:
    the same flushes, results, gateway state and report."""
    sched = jsource.request_schedule("flash_crowd", jax.random.PRNGKey(3), 400.0, 0.3, TEXTS,
                                     deadline_ms=50.0)
    pol_kw = dict(max_batch=8, max_wait_ms=3.0, slack_ms=1.0, pad_batches=True)
    gw, ref = _pair(algo="sonar_ft", seed=11, eject_after=2, outage_kw=dict(probability=0.8))
    jpump = jmicro.MicroBatchPump(ref, jmicro.BatchingPolicy(**pol_kw), service_ms=lambda t: 2.0)
    pump = MicroBatchPump(gw, BatchingPolicy(**pol_kw), service_ms=lambda t: 2.0)
    jrep, rep = jpump.replay(sched), pump.replay(_port_requests(sched))
    assert [[r.rid for r in b] for b in pump.flush_log] == [
        [r.rid for r in b] for b in jpump.flush_log]
    assert pump.flush_times == jpump.flush_times
    assert [dataclasses.asdict(r) for r in rep.results] == [
        dataclasses.asdict(r) for r in jrep.results]
    for f in ("n_offered", "n_routed", "n_shed", "n_expired", "n_flushes", "mean_batch",
              "sustained_qps", "p50_ms", "p99_ms", "mean_wait_ms"):
        assert getattr(rep, f) == getattr(jrep, f), f
    _same_state(gw, ref, "pump")


def test_pump_spans_replay_the_live_trace():
    """With tracing on, the pump's live spans equal `replay_spans`, and the
    port's span emitters write the reference's events."""
    obs = Observability(trace=True)
    gw = _gateway(obs=obs)
    pump = MicroBatchPump(gw, BatchingPolicy(max_batch=4, max_wait_ms=2.0),
                          service_ms=lambda t: 3.0)
    pump.replay(_burst(10, spacing_ms=0.7))
    live = [e for e in obs.tracer.events if e["name"] in ("flush", "encode", "dispatch",
                                                            "merge", "serve", "queue_wait")]
    assert live == pump.replay_spans().events and live
    a = trace.SpanTracer(clock_ms=lambda: 0.0)
    b = jtrace.SpanTracer(clock_ms=lambda: 0.0)
    phases = [("encode", 0.25), ("dispatch", 1.5), ("merge", 0.5)]
    for tr, mod in ((a, trace), (b, jtrace)):
        mod.emit_flush_spans(tr, 10.0, 13.0, phases, [4, 5], flush_idx=2)
        mod.emit_flush_spans(tr, 20.0, 20.0, phases, [6])
        mod.emit_request_spans(tr, 4, 9.0, 10.0, 13.0, replica_idx=1, flush_idx=2)
    assert a.to_chrome_trace() == b.to_chrome_trace()
    with trace.annotate("netmcp.test"):
        pass


# ---------------------------------------------------------------------------
# SonarGateway against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["sonar", "sonar_lb", "sonar_ft", "sonar_geo", "sonar_adapt"])
@pytest.mark.parametrize("shards", [None, 2])
def test_route_batch_equals_reference(algo, shards):
    """Flushes of growing size, every other one padded (``pad_to``), with
    region tags; a fleet of short, frequent outages that the telemetry
    cannot foresee, so SONAR-FT ejects, probes and readmits: the port's
    picks and end state equal the JAX gateway's."""
    rng = np.random.default_rng(7)
    rr = rng.uniform(1.0, 200.0, (2, len(ARCHS))).astype(np.float32)
    states = ["outage_profile", "high_latency_profile"] + ["outage_profile"] * 3
    gw, ref = _pair(states=states, algo=algo, seed=5, region_rtt_ms=rr, shards=shards,
                    eject_after=2, outage_kw=dict(probability=0.3, duration_min_s=10.0,
                                                  duration_max_s=30.0))
    assert isinstance(gw._telemetry, gateway.DeviceTelemetry) == bool(shards)
    for i in range(8):
        texts = [TEXTS[(i + j) % 3] for j in range(2 + i)]
        regs = [int(x) for x in rng.integers(-1, 2, len(texts))]
        pad = 16 if i % 2 else None
        _same_results(gw.route_batch(texts, client_regions=regs, pad_to=pad),
                      ref.route_batch(texts, client_regions=regs, pad_to=pad), f"flush {i}")
        _same_state(gw, ref, f"{algo} shards={shards} flush {i}")
    assert len(gw.last_flush_phases) == 3 and gw.route_batch([]) == []
    if algo in ("sonar_ft", "sonar_adapt"):
        assert gw.report()["ejections"] > 0 and gw.report()["readmissions"] > 0
    if algo == "sonar_adapt":
        assert gw.adapt_state() is not None and int(gw.adapt_state().step) > 0
        np.testing.assert_allclose(gw.engine().adapt_weights, ref.engine().adapt_weights,
                                   rtol=RTOL, atol=ATOL)
        reg = gw.obs.registry
        for k in ("adapt_weight_alpha", "adapt_steps", "adapt_baseline"):
            assert reg.value(k) == pytest.approx(ref.obs.registry.value(k), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scalar_paths_and_bf16_telemetry_equal_reference(dtype):
    """`route`, `begin` / `finish` / `abandon` (with sessions on SONAR-SESSION)
    and the batched path (``use_kernels=False`` routes one by one), with the
    telemetry stored in ``dtype``."""
    for algo in ("sonar_lb", "sonar_session"):
        gw, ref = _pair(algo=algo, seed=2, telemetry_dtype=dtype, use_kernels=False)
        for i in range(6):
            a = gw.route(TEXTS[i % 3], session_id=i % 2)
            b = ref.route(TEXTS[i % 3], session_id=i % 2)
            _same_results([a], [b], f"route {i}")
        begun = [(gw.begin(TEXTS[i % 3], session_id=1), ref.begin(TEXTS[i % 3], session_id=1))
                 for i in range(4)]
        _same_results([x for x, _ in begun], [y for _, y in begun], "begin")
        assert gw.abandon(begun[0][0].replica_idx) == ref.abandon(begun[0][1].replica_idx)
        for (x, y), ms in zip(begun[1:], (40.0, 1500.0, 80.0)):
            _same_results([gw.finish(x.replica_idx, ms, session_id=1)],
                          [ref.finish(y.replica_idx, ms, session_id=1)], "finish")
        assert gw.finish(0, 1.0) is None and ref.finish(0, 1.0) is None
        _same_results(gw.route_batch(TEXTS), ref.route_batch(TEXTS), "per-request batch")
        _same_state(gw, ref, f"{algo} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_telemetry_ring_is_oldest_first(dtype):
    """The ring after more than W pushes hands out the window oldest-first,
    equal to the host roll window's, in both storage dtypes (bf16 rounds
    each sample once, on entry)."""
    rng = np.random.default_rng(1)
    init = rng.uniform(1.0, 900.0, (6, 5)).astype(np.float32)
    ring = gateway.DeviceTelemetry(init, dtype=dtype, device=CPU)
    host = gateway._HostTelemetry(init, dtype=dtype)
    ref = jgateway._HostTelemetry(init, dtype=dtype)
    for k in range(13):
        assert ring.raw().dtype == gateway._telemetry_dtype(dtype)
        np.testing.assert_array_equal(ring.host(), host.host())
        np.testing.assert_array_equal(host.host(), ref.host())
        col = rng.uniform(1.0, 900.0, 6).astype(np.float32)
        for t in (ring, host, ref):
            t.push(col)
    np.testing.assert_array_equal(ring.raw().float().numpy(), ref.host())
    assert ring.raw().is_contiguous()


def test_padded_rows_keep_real_decisions_and_engine_arguments():
    """Zero-row padding leaves every real row's decision as the unpadded
    call's; the engines take ``n_real`` and fold only the real rows into
    device route stats."""
    for algo in ("sonar", "sonar_lb", "sonar_ft"):
        for size in (1, 3, 5):
            a, b = _gateway(seed=7, algo=algo), _gateway(seed=7, algo=algo)
            texts = [TEXTS[i % 3] for i in range(size)]
            assert [r.replica_idx for r in a.route_batch(texts)] == [
                r.replica_idx for r in b.route_batch(texts, pad_to=8)]
    gw = _gateway(shards=2)
    for eng in (make_engine("sonar", gw.replicas, device=CPU), gw.engine()):
        enc = eng.encode(TEXTS).pad_to(5)
        tel = gw.telemetry
        d = eng.route(enc, tel, n_real=3)
        assert len(d) == 5
        with pytest.raises(ValueError):
            eng.route(enc, tel, n_real=6)
        drs = DeviceRouteStats(len(gw.replicas))
        d = eng.route(enc, tel, route_stats=drs, n_real=3)
        out = drs.fold()
        np.testing.assert_array_equal(
            out["picks"], np.bincount(d.server_idx[:3], minlength=len(gw.replicas)))
        assert out["n_routed"] == 3.0
        np.testing.assert_allclose(out["mean_fused"], d.fused[:3].mean(), rtol=1e-6)
    obs = Observability()
    assert obs.audit_tap is None and obs.ensure_route_stats(4) is None
    on = Observability(jit_stats=True, audit=True)
    assert on.audit_tap is not None and on.ensure_route_stats(4).n_servers == 4


def test_gateway_needs_a_network_algorithm_and_a_card(monkeypatch):
    with pytest.raises(ValueError):
        _gateway(algo="prag")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gateway.SonarGateway(gateway.replica_pool([("yi-6b", "dense")] * 2))


# ---------------------------------------------------------------------------
# AsyncServingGateway
# ---------------------------------------------------------------------------

def test_async_gateway_routes_and_drains():
    gw = _gateway()

    async def routes_all():
        srv = AsyncServingGateway(gw, BatchingPolicy(max_batch=4, max_wait_ms=3.0,
                                                     pad_batches=True))
        await srv.start()
        res = await asyncio.gather(*[srv.submit(TEXTS[i % 3], deadline_ms=30_000.0)
                                     for i in range(10)])
        await srv.close()
        return res, srv

    res, srv = asyncio.run(routes_all())
    assert len(res) == 10 and all(not r.shed and not r.expired for r in res)
    assert all(r.replica_idx >= 0 for r in res) and 1 <= srv.n_flushes <= 10
    srv.batcher.check_accounting()

    async def drains():
        srv = AsyncServingGateway(gw, BatchingPolicy(max_batch=8, max_wait_ms=60_000.0,
                                                     pad_batches=True))
        await srv.start()
        tasks = [asyncio.ensure_future(srv.submit(TEXTS[i % 3])) for i in range(6)]
        await asyncio.sleep(0.05)
        assert srv.batcher.n_pending == 6
        await srv.close(drain=True)
        return await asyncio.gather(*tasks)

    res = asyncio.run(drains())
    assert all(not r.shed and not r.expired and r.replica_idx >= 0 for r in res)

    async def sheds():
        srv = AsyncServingGateway(gw, BatchingPolicy(max_batch=8, max_wait_ms=60_000.0))
        await srv.start()
        tasks = [asyncio.ensure_future(srv.submit(TEXTS[i % 3])) for i in range(4)]
        await asyncio.sleep(0.05)
        await srv.close(drain=False)
        res = await asyncio.gather(*tasks)
        with pytest.raises(RuntimeError):
            await srv.submit("after close")
        return res

    assert all(r.shed for r in asyncio.run(sheds()))
    rep = gw.report()
    assert rep["n"] == 16 and rep["shed"] == 4 and rep["in_flight"] == 0
