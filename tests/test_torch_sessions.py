"""The port's session DAGs and session simulator against the JAX reference,
on the CPU.

`repro_torch.sessions.{dag, sim}` are held to their `repro` twins.  The
four templates and `critical_path` must be equal.  `generate_sessions`
draws from a `torch.Generator` (the reference splits a `jax.random` key),
so it is checked by its signature, and the simulator parity runs hand both
simulators the reference's sessions, traces and service draws; every node
`Request`, the whole `SessionReport` and the registry counters must be
equal.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.chaos import build_schedule as jbuild_schedule
from repro.chaos import standard_fault_mix as jstandard_fault_mix
from repro.core import latency as jlatency
from repro.core import platform as jplatform
from repro.core import routing as jrouting
from repro.sessions import dag as jdag
from repro.sessions import sim as jsim_mod
from repro.traffic import fleet as jfleet
from repro.traffic import queueing as jqueueing
from repro_torch.chaos import ChaosSchedule
from repro_torch.core import latency, platform, routing
from repro_torch.sessions import dag, sim
from repro_torch.traffic import ARRIVAL_PROCESSES, fleet, queueing

CPU = "cpu"
RTOL, ATOL = 2e-6, 2e-7
TEXTS = [
    "what is the latest news about the stock market today",
    "search the web for current weather information",
    "find recent articles about machine learning research",
    "look up live election results online",
]


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _nodes(d):
    return [(n.node_id, n.text, n.parents) for n in d.nodes]


def _port_session(jd):
    """The port's copy of a reference `SessionDAG`."""
    out = dag.SessionDAG(jd.session_id, jd.template,
                         [dag.SessionNode(n.node_id, n.text, n.parents) for n in jd.nodes])
    out.t_arrival_s, out.region = jd.t_arrival_s, jd.region
    return out


# ---------------------------------------------------------------------------
# templates and the generator
# ---------------------------------------------------------------------------

def test_templates_and_critical_paths_equal_reference():
    assert sorted(dag.DAG_TEMPLATES) == sorted(jdag.DAG_TEMPLATES)
    for name in dag.DAG_TEMPLATES:
        for size in (0, 1, 2, 3, 5):
            for offset in (0, 3):
                kw = ({"n_steps": size} if name in ("chain", "retry_loop")
                      else {"width": size})
                if name == "map_reduce":
                    kw["n_reduce"] = max(size // 2, 1)
                a = dag.DAG_TEMPLATES[name](7, TEXTS, offset=offset, **kw)
                b = jdag.DAG_TEMPLATES[name](7, TEXTS, offset=offset, **kw)
                assert (a.session_id, a.template, a.t_arrival_s, a.region) == (
                    b.session_id, b.template, b.t_arrival_s, b.region)
                assert _nodes(a) == _nodes(b)
                assert a.roots() == b.roots() and a.children() == b.children()
                assert dag.critical_path(a) == jdag.critical_path(b)
    with pytest.raises(ValueError, match="topological"):
        dag.SessionDAG(0, "x", [dag.SessionNode(0, "a", (1,)), dag.SessionNode(1, "b", ())])
    with pytest.raises(ValueError, match="id-ordered"):
        dag.SessionDAG(0, "x", [dag.SessionNode(1, "a", ())])


@pytest.mark.parametrize("process", sorted(ARRIVAL_PROCESSES))
def test_generate_sessions_signature(process):
    """Arrival times from the named process (sorted, in the horizon),
    templates from the list, sizes in range, offsets that cycle the texts,
    regions drawn from the given set; the same generator seed gives the
    same workload, another seed another."""
    kw = dict(arrival_process=process, templates=["chain", "map_reduce", "fanout_fanin"],
              regions=np.asarray([2, 5]), min_size=2, max_size=4)
    rate, horizon = (0.5, 600.0) if process == "mmpp" else (3.0, 60.0)
    a = dag.generate_sessions(_gen(1), rate, horizon, TEXTS, **kw)
    b = dag.generate_sessions(_gen(1), rate, horizon, TEXTS, **kw)
    c = dag.generate_sessions(_gen(2), rate, horizon, TEXTS, **kw)
    assert len(a) > 10
    assert [(d.template, d.t_arrival_s, d.region, _nodes(d)) for d in a] == [
        (d.template, d.t_arrival_s, d.region, _nodes(d)) for d in b]
    assert [d.t_arrival_s for d in a] != [d.t_arrival_s for d in c][: len(a)]
    t = np.asarray([d.t_arrival_s for d in a])
    assert (np.diff(t) >= 0.0).all() and t.min() >= 0.0 and t.max() < horizon
    assert [d.session_id for d in a] == list(range(len(a)))
    assert {d.template for d in a} <= set(kw["templates"]) and {d.region for d in a} <= {2, 5}
    for d in a:
        size = {"chain": d.n_nodes, "fanout_fanin": d.n_nodes - 2}.get(d.template)
        if size is not None:
            assert 2 <= size <= 4
        assert d.nodes[0].text in TEXTS
    plain = dag.generate_sessions(_gen(1), 3.0, 60.0, TEXTS)
    assert {d.region for d in plain} == {-1}
    assert {d.template for d in plain} <= set(dag.DAG_TEMPLATES)
    assert dag.generate_sessions(_gen(1), 0.0, 60.0, TEXTS) == []
    with pytest.raises(ValueError):
        dag.generate_sessions(_gen(1), 1.0, 60.0, [])


# ---------------------------------------------------------------------------
# the session simulator against the reference
# ---------------------------------------------------------------------------

def _sim_pair(algo, n=6, horizon_s=240.0, chaos=None, **kw):
    jservers, servers = jfleet.replica_fleet(n), fleet.replica_fleet(n)
    pkw = dict(scenario="ideal", seed=0, horizon_s=horizon_s, dt_s=1.0)
    jp = jplatform.NetMCPPlatform(jservers, profiles=[jlatency.ideal_profile()] * n,
                                  chaos=chaos, **pkw)
    port_chaos = None if chaos is None else ChaosSchedule(
        down=chaos.down, degrade=chaos.degrade, stale=chaos.stale, dt_s=chaos.dt_s)
    p = platform.NetMCPPlatform(servers, profiles=[latency.ideal_profile()] * n,
                                chaos=port_chaos, device=CPU, **pkw)
    p.traces, p.observed = jp.traces, jp.observed.copy()
    ckw = dict(gamma=0.35, top_s=n, top_k=n)
    qkw = dict(capacity=2, queue_limit=4, base_service_ms=200.0, inflation=1.0)
    js = jsim_mod.SessionTrafficSim(jp, jrouting.make_router(algo, jservers,
                                                             jrouting.RoutingConfig(**ckw)),
                                    jqueueing.QueueConfig(**qkw), seed=0, **kw)
    s = sim.SessionTrafficSim(p, routing.make_router(algo, servers, routing.RoutingConfig(**ckw)),
                              queueing.QueueConfig(**qkw), seed=0, device=CPU, **kw)
    s._service_draws = lambda m: np.asarray(jax.random.exponential(
        jax.random.PRNGKey(0), (m,), dtype=np.float32), np.float64)
    return js, s, jp, p


def _same_session_reports(rep, jrep, ctx):
    fa, fb = dataclasses.asdict(rep), dataclasses.asdict(jrep)
    ra, rb = fa.pop("requests"), fb.pop("requests")
    for k in fa:
        x, y = fa[k], fb[k]
        assert (x == y) or (isinstance(x, float) and math.isnan(x) and math.isnan(y)), \
            f"{ctx} {k}: {x} != {y}"
    assert len(ra) == len(rb), ctx
    for a, b in zip(ra, rb):
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            if k == "feats":
                assert x is None and y is None, ctx
            elif isinstance(x, float) and math.isnan(x):
                assert math.isnan(y), f"{ctx} rid {a['rid']} {k}"
            else:
                assert x == y, f"{ctx} rid {a['rid']} {k}: {x} != {y}"
    rep.check_accounting()


CASES = {
    # name: (algo, session rate, sim kwargs, with chaos)
    "sonar": ("sonar", 6.0, dict(hedge_ms=150.0, retry_budget=2), False),
    "sonar_session": ("sonar_session", 6.0, dict(hedge_ms=150.0, retry_budget=2), False),
    "sonar_session_no_hedge_cold": ("sonar_session", 4.0, dict(warm_speedup=1.0), False),
    "sonar_ft_chaos": ("sonar_ft", 2.0, dict(retry_budget=1), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_sim_equals_reference(case):
    """The reference's workload through both session simulators: DAG
    release, abandonment, DAG-aware hedging, the warm-context discount and
    SONAR-SESSION's affinity term; equal node requests, reports and
    registry counters."""
    algo, rate, kw, with_chaos = CASES[case]
    horizon = 15.0
    chaos = None
    if with_chaos:
        chaos = jbuild_schedule(jstandard_fault_mix(1.0, 6, 4 * horizon), 6, int(4 * horizon),
                                1.0, seed=0)
    js, s, jp, p = _sim_pair(algo, horizon_s=4 * horizon, chaos=chaos, **kw)
    jsessions = jdag.generate_sessions(jax.random.PRNGKey(3), rate, horizon, TEXTS)
    jrep = js.run_sessions(jsessions)
    rep = s.run_sessions([_port_session(d) for d in jsessions])
    _same_session_reports(rep, jrep, case)
    np.testing.assert_array_equal(p.observed, jp.observed)
    assert s.obs.registry.snapshot() == js.obs.registry.snapshot()
    assert rep.n_sessions == len(jsessions) > 25
    if case == "sonar":
        assert rep.n_tasks_failed > 0 and rep.n_nodes_abandoned > 0 and rep.n_hedges > 0
    assert rep.row(case) == jrep.row(case)


def test_session_report_accounting_raises_on_a_leak():
    rep = sim.SessionReport(
        n_sessions=2, n_tasks_succeeded=1, n_tasks_failed=1, task_success_rate=0.5,
        task_p50_ms=1.0, task_p99_ms=1.0, task_mean_ms=1.0, n_nodes_offered=5,
        n_nodes_completed=4, n_nodes_failed=1, n_nodes_abandoned=2, n_hedges=0,
        per_template={}, requests=[])
    rep.check_accounting()
    with pytest.raises(AssertionError, match="node accounting"):
        dataclasses.replace(rep, n_nodes_offered=6).check_accounting()
    with pytest.raises(AssertionError, match="task accounting"):
        dataclasses.replace(rep, n_tasks_failed=0).check_accounting()
    plat = fleet.ideal_platform(fleet.replica_fleet(2), seed=0, horizon_s=60.0, device=CPU)
    with pytest.raises(ValueError):
        sim.SessionTrafficSim(plat, lambda t, h, l: 0, warm_speedup=0.0, device=CPU)
