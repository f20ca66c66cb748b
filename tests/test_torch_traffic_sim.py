"""The port's queueing stations and fleet traffic simulator against the JAX
reference, on the CPU.

`repro_torch.traffic.{queueing, simulator}` are held to their `repro`
twins.  The simulator is host Python; its one random draw, the
service-time stream, comes from a `torch.Generator` in the port and from
`jax.random` in the reference, so parity runs hand both simulators the
same arrivals, traces (copied in), chaos masks, WAN overlays and service
draws (`_service_draws` replaced by the reference's array).  Every
`Request` field and the whole `TrafficReport` must be equal; SONAR-ADAPT's
winner features within rtol 2e-6 / atol 2e-7.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.chaos import build_schedule as jbuild_schedule
from repro.chaos import standard_fault_mix as jstandard_fault_mix
from repro.core import routing as jrouting
from repro.core.adaptive import AdaptConfig as JAdaptConfig
from repro.geo import GeoPlacement as JGeoPlacement
from repro.geo import build_topology as jbuild_topology
from repro.geo import client_populations as jclient_populations
from repro.geo import place_servers as jplace_servers
from repro.geo.placement import regional_arrivals as jregional_arrivals
from repro.obs import Observability as JObservability
from repro.traffic import arrivals as jarrivals
from repro.traffic import fleet as jfleet
from repro.traffic import queueing as jqueueing
from repro.traffic import simulator as jsimulator
from repro_torch.chaos import ChaosSchedule
from repro_torch.core import routing
from repro_torch.core.adaptive import AdaptConfig
from repro_torch.geo import GeoPlacement, build_topology
from repro_torch.obs import Observability
from repro_torch.traffic import fleet, queueing, simulator

RTOL, ATOL = 2e-6, 2e-7
CPU = "cpu"
TEXTS = [
    "what is the latest news about the stock market today",
    "search the web for current weather information",
    "find recent articles about machine learning research",
    "look up live election results online",
]


def ref_draws(seed, n):
    """The reference simulator's service draws (before the base scale)."""
    return np.asarray(jax.random.exponential(jax.random.PRNGKey(seed), (n,),
                                             dtype=np.float32), np.float64)


def same_requests(port, ref, ctx):
    """Every field of every request equal (NaN where both are NaN); the
    winner features within the parity tolerance."""
    assert len(port) == len(ref), ctx
    for a, b in zip(port, ref):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.keys() == fb.keys(), ctx
        ka, kb = fa.pop("feats"), fb.pop("feats")
        assert (ka is None) == (kb is None), f"{ctx} rid {a.rid} feats"
        if ka is not None:
            np.testing.assert_allclose(ka, kb, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} rid {a.rid} feats")
        for k in fa:
            x, y = fa[k], fb[k]
            if isinstance(x, float) and math.isnan(x):
                assert isinstance(y, float) and math.isnan(y), f"{ctx} rid {a.rid} {k}"
            else:
                assert x == y, f"{ctx} rid {a.rid} {k}: {x} != {y}"


def same_report(port, ref, ctx):
    fa, fb = dataclasses.asdict(port), dataclasses.asdict(ref)
    fa.pop("requests"), fb.pop("requests")
    assert fa == fb, ctx
    same_requests(port.requests, ref.requests, ctx)
    assert port.n_completed + port.n_failed == port.n_offered, ctx
    assert port.row("x") == ref.row("x"), ctx


def sim_pair(n, *, algo="sonar", router_fn=None, horizon_s=240.0, chaos=None, geo=None,
             queue=None, obs=False, adapt_lr=None, **kw):
    """A reference simulator and the port's on the same fleet, traces,
    chaos masks, WAN overlays and service draws.  ``chaos`` is a
    reference `ChaosSchedule` (the port gets one built from its masks);
    ``geo`` is ``(n_regions, rtt_scale, client_skew)``."""
    jservers, servers = jfleet.replica_fleet(n), fleet.replica_fleet(n)
    jplace = place = None
    if geo is not None:
        n_regions, scale, skew = geo
        jtopo = jbuild_topology(n_regions, seed=0, horizon_s=horizon_s, dt_s=1.0,
                                rtt_scale=scale)
        topo = build_topology(n_regions, seed=0, horizon_s=horizon_s, dt_s=1.0,
                              rtt_scale=scale, device=CPU)
        topo._overlays = jtopo._overlays           # the reference's overlays
        topo._rtt_cache.clear()
        jplace = JGeoPlacement(jtopo, jplace_servers(n, n_regions),
                               jclient_populations(n_regions, skew=skew))
        place = GeoPlacement(topo, jplace.server_region, jplace.client_weights)
    jp = jfleet.ideal_platform(jservers, seed=0, horizon_s=horizon_s, geo=jplace)
    p = fleet.ideal_platform(servers, seed=0, horizon_s=horizon_s, geo=place, device=CPU)
    if chaos is not None:
        from repro.core.platform import NetMCPPlatform as JPlatform
        from repro_torch.core.platform import NetMCPPlatform
        from repro.core import latency as jL
        from repro_torch.core import latency as L
        jp = JPlatform(jservers, profiles=[jL.ideal_profile() for _ in jservers],
                       scenario="ideal", seed=0, horizon_s=horizon_s, dt_s=1.0, chaos=chaos,
                       geo=jplace)
        port_chaos = ChaosSchedule(down=chaos.down, degrade=chaos.degrade, stale=chaos.stale,
                                   dt_s=chaos.dt_s, severity_ms=chaos.severity_ms)
        p = NetMCPPlatform(servers, profiles=[L.ideal_profile() for _ in servers],
                           scenario="ideal", seed=0, horizon_s=horizon_s, dt_s=1.0,
                           chaos=port_chaos, geo=place, device=CPU)
    p.traces, p.observed = jp.traces, jp.observed.copy()
    ckw = dict(gamma=0.35, top_s=n, top_k=n)
    cfg, jcfg = routing.RoutingConfig(**ckw), jrouting.RoutingConfig(**ckw)
    if router_fn is not None:
        jrouter = router = router_fn
    elif adapt_lr is not None:
        jrouter = jrouting.make_router(algo, jservers, jcfg)
        router = routing.make_router(algo, servers, cfg)
        jrouter.__init__(jservers, jcfg, JAdaptConfig(lr=adapt_lr))
        router.__init__(servers, cfg, AdaptConfig(lr=adapt_lr))
    else:
        jrouter = jrouting.make_router(algo, jservers, jcfg)
        router = routing.make_router(algo, servers, cfg)
    qkw = dict(capacity=2, queue_limit=4, base_service_ms=400.0, inflation=1.0)
    qkw.update(queue or {})
    jobs, pobs = (JObservability(trace=True), Observability(trace=True)) if obs else (None, None)
    jsim = jsimulator.FleetTrafficSim(jp, jrouter, jqueueing.QueueConfig(**qkw), seed=3,
                                      obs=jobs, **kw)
    sim = simulator.FleetTrafficSim(p, router, queueing.QueueConfig(**qkw), seed=3, obs=pobs,
                                    device=CPU, **kw)
    sim._service_draws = lambda m: ref_draws(3, m)
    return jsim, sim, jp, p


def run_pair(jsim, sim, arrivals, regions=None):
    jrep = jsim.run(arrivals, TEXTS, regions=regions)
    rep = sim.run(arrivals, TEXTS, regions=regions)
    return jrep, rep


# ---------------------------------------------------------------------------
# queueing stations
# ---------------------------------------------------------------------------

def test_server_queue_equals_reference_under_random_operations():
    rng = np.random.default_rng(0)
    cfg = dict(capacity=3, queue_limit=4, base_service_ms=100.0, inflation=0.7)
    a, b = queueing.ServerQueue(queueing.QueueConfig(**cfg)), jqueueing.ServerQueue(
        jqueueing.QueueConfig(**cfg))
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    now, items = 0.0, []
    for i in range(400):
        now += float(rng.exponential(20.0))
        op = rng.integers(3)
        if op == 0 or not items:
            assert a.offer(i, now) == b.offer(i, now)
            items.append(i)
        elif op == 1 and a.in_service:
            assert a.finish(now) == b.finish(now)
        else:
            it = items[int(rng.integers(len(items)))]
            assert a.cancel_waiting(it) == b.cancel_waiting(it)
        d = float(rng.exponential(50.0))
        assert a.service_time(d) == b.service_time(d)
        a.record_service(d), b.record_service(d)
        assert (a.demand, a.utilization, list(a.waiting)) == (
            b.demand, b.utilization, list(b.waiting))
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert a.stats.dropped > 0 and a.stats.served > 0


# ---------------------------------------------------------------------------
# the simulator against the reference
# ---------------------------------------------------------------------------

def _least_loaded(text, hist, loads):
    return int(np.argmin(loads))


CASES = {
    # name: (sim_pair kwargs, rate, horizon of the arrivals)
    "sonar": (dict(algo="sonar"), 12.0, 15.0),
    "sonar_lb": (dict(algo="sonar_lb"), 12.0, 15.0),
    "plain_callable": (dict(router_fn=_least_loaded), 12.0, 15.0),
    "sonar_hedged": (dict(algo="sonar", hedge_ms=100.0,
                          queue=dict(queue_limit=8)), 10.0, 15.0),
    "sonar_lb_deadline": (dict(algo="sonar_lb", deadline_ms=900.0), 12.0, 15.0),
    "sonar_adapt": (dict(algo="sonar_adapt", adapt_lr=0.05), 10.0, 15.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_sim_equals_reference(case):
    """Equal requests and reports for the scalar routers, a plain callable,
    hedging, a deadline and SONAR-ADAPT's online credit path."""
    kw, rate, horizon = CASES[case]
    jsim, sim, jp, p = sim_pair(4, **kw)
    arr = jarrivals.poisson_arrivals(jax.random.PRNGKey(1), rate, horizon)
    jrep, rep = run_pair(jsim, sim, arr)
    same_report(rep, jrep, case)
    np.testing.assert_array_equal(p.observed, jp.observed)
    assert rep.n_offered == arr.size > 100
    assert sum(r.n_routes for r in rep.requests) >= rep.n_offered
    if case == "sonar":
        assert rep.n_drop_events > 0                  # the load-blind herd overflows
    if case == "sonar_hedged":
        assert rep.n_hedges > 0
    if case == "sonar_adapt":
        np.testing.assert_allclose(sim.router.weights, np.asarray(jsim.router.weights),
                                   rtol=RTOL, atol=ATOL)
        assert len(sim.router.weight_history) == len(jsim.router.weight_history) > 0
    assert sim.obs.registry.snapshot() == jsim.obs.registry.snapshot()


def test_fleet_sim_sonar_ft_under_chaos_equals_reference():
    """SONAR-FT and the stale-blind SONAR under the standard fault mix:
    dead stations refuse dispatches and kill in-service copies, failed sets
    feed the failover mask; every request and report equal."""
    horizon = 240.0
    faults = jstandard_fault_mix(0.8, 6, horizon)
    chaos = jbuild_schedule(faults, 6, int(horizon), 1.0, seed=0)
    arr = jarrivals.poisson_arrivals(jax.random.PRNGKey(0), 3.0, 200.0)
    reps = {}
    for algo in ("sonar", "sonar_ft"):
        jsim, sim, jp, p = sim_pair(6, algo=algo, horizon_s=horizon, chaos=chaos,
                                    queue=dict(capacity=4, queue_limit=16,
                                               base_service_ms=200.0), retry_budget=2)
        jrep, rep = run_pair(jsim, sim, arr)
        same_report(rep, jrep, f"{algo} under chaos")
        np.testing.assert_array_equal(p.observed, jp.observed)
        reps[algo] = rep
    assert reps["sonar"].n_failed > reps["sonar_ft"].n_failed
    assert any(r.failed_servers for r in reps["sonar_ft"].requests)


@pytest.mark.parametrize("algo", ["sonar_lb", "sonar_geo"])
def test_fleet_sim_with_regions_equals_reference(algo):
    """Region-tagged arrivals on a WAN placement: the completion pays the
    propagation RTT, SONAR-GEO receives its region's RTT row."""
    horizon = 40.0
    jsim, sim, jp, p = sim_pair(6, algo=algo, horizon_s=4 * horizon, geo=(3, 3.0, 1.5),
                                queue=dict(base_service_ms=150.0, queue_limit=8))
    arr, regs = jregional_arrivals(jax.random.PRNGKey(0), jp.geo, 6.0, horizon)
    jrep, rep = run_pair(jsim, sim, arr, regions=regs)
    same_report(rep, jrep, algo)
    assert all(r.region >= 0 for r in rep.requests)
    assert all(r.net_ms > 0.0 for r in rep.requests if r.done)


def test_fleet_sim_spans_equal_reference_tracer():
    """With tracing on, the chaos track and every request's spans and fault
    instants equal the reference tracer's events."""
    horizon = 60.0
    chaos = jbuild_schedule(jstandard_fault_mix(1.0, 4, horizon), 4, int(horizon), 1.0, seed=1)
    jsim, sim, _, _ = sim_pair(4, algo="sonar_ft", horizon_s=horizon, chaos=chaos, obs=True)
    arr = jarrivals.poisson_arrivals(jax.random.PRNGKey(2), 4.0, 50.0)
    jrep, rep = run_pair(jsim, sim, arr)
    same_report(rep, jrep, "traced")
    ev, jev = sim.obs.tracer.events, jsim.obs.tracer.events
    assert ev == jev
    assert {e["cat"] for e in ev} >= {"chaos", "request", "fault"}


def test_service_draws_by_distribution_and_device(monkeypatch):
    """The port's own service stream: Exp(1) (mean and tail), the same
    draws for the same seed, another stream for another seed; the
    simulator needs a card unless the CPU is asked for."""
    plat = fleet.ideal_platform(fleet.replica_fleet(2), seed=0, horizon_s=60.0, device=CPU)
    mk = lambda seed: simulator.FleetTrafficSim(plat, _least_loaded, seed=seed, device=CPU)
    a, b, c = mk(5)._service_draws(20_000), mk(5)._service_draws(20_000), mk(6)._service_draws(8)
    assert a.dtype == np.float64 and a.shape == (20_000,)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[:8], c)
    assert abs(a.mean() - 1.0) < 0.03 and abs(np.mean(a > 3.0) - math.exp(-3.0)) < 0.01
    rep = mk(5).run(np.arange(20) * 0.5, TEXTS)
    assert rep.n_completed == 20 and sum(rep.per_server_served) == 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.FleetTrafficSim(plat, _least_loaded)


def _public(mod):
    import types

    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and k != "annotations"}


# typing names a module happens to import
_TYPING = {"Any", "Callable", "NamedTuple", "Optional"}
# reference names the port leaves out by design, module by module (besides
# the `*_jit` and `*_pallas` entry points: the port's functions are plain
# PyTorch and its kernels CUDA C++ behind `kernels.ops`)
_BY_DESIGN = {
    # the shard_map mesh path: one card has no mesh (ROADMAP.md queue 1, item 9)
    "core.mesh_routing": {"FLEET_RULES", "Mesh", "shard_map"},
    # the Pallas kernels' tile constants and sentinels
    "kernels.bm25_score": {"BD", "BQ", "BV"},
    "kernels.decode_attention": {"DEFAULT_BK", "NEG_INF"},
    "kernels.flash_attention": {"DEFAULT_BK", "DEFAULT_BQ", "NEG_INF"},
    "kernels.qos_score": {"SERVER_TILE"},
    "kernels.score_fuse": {"NEG", "QUERY_TILE", "STRIPE"},
    "kernels.select_fuse": {"NEG", "QUERY_TILE"},
    # mesh sharding helpers (no-ops outside a mesh) and the Annotated-tree
    # helpers (the port's initialisers return bare tensors); lm_loss,
    # softmax_cross_entropy and layer_norm wait for training and whisper
    # (ROADMAP.md queue 1, item 11 (c) and (d))
    "models.attention": {"fsdp_gather", "maybe_constrain"},
    "models.mamba": {"fsdp_gather"},
    "models.mlp": {"fsdp_gather"},
    "models.xlstm": {"fsdp_gather"},
    "models.lm": {"amap", "stack_init", "fsdp_gather", "maybe_constrain", "lm_loss"},
    "nn.core": {"Annotated", "is_annotated", "unzip", "zip_trees", "layer_norm",
                "softmax_cross_entropy"},
    # the JAX profiler switch: the port's `record_function` annotations are
    # always on
    "obs": {"enable_jax_annotations"},
    "obs.trace": {"enable_jax_annotations", "jax_annotations_enabled"},
}


def _twin_modules():
    """Every module of the reference whose twin file the port has, as a
    dotted name below the package (``core.agent``, ``obs``, ...)."""
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = []
    for f in sorted((src / "repro").rglob("*.py")):
        rel = f.relative_to(src / "repro")
        if (src / "repro_torch" / rel).is_file():
            parts = rel.with_suffix("").parts
            out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


@pytest.mark.parametrize("pkg", ["traffic", "chaos", "geo", "sessions", "obs"])
def test_package_exports_equal_reference(pkg):
    """Each scenario package exports the reference package's public names
    (in `obs`, the JAX profiler switch, which the port's always-on
    `record_function` annotations replace, and typing names aside)."""
    import importlib

    mine = _public(importlib.import_module(f"repro_torch.{pkg}"))
    ref = _public(importlib.import_module(f"repro.{pkg}"))
    if pkg == "obs":
        ref -= {"enable_jax_annotations"} | _TYPING
        mine -= _TYPING
    assert ref <= mine, sorted(ref - mine)


@pytest.mark.parametrize("name", _twin_modules())
def test_module_exports_equal_reference(name):
    """Module by module, the port exports every public name of its twin in
    the reference, but for typing names, `*_jit` / `*_pallas` entry points
    and the absences by design listed in `_BY_DESIGN`; each listed absence
    must still be one (a name once ported leaves the list)."""
    import importlib

    mine = _public(importlib.import_module(f"repro_torch.{name}"))
    ref = _public(importlib.import_module(f"repro.{name}"))
    listed = _BY_DESIGN.get(name, set())
    assert listed <= ref - mine, sorted(listed & mine)
    missing = {k for k in ref - mine - listed - _TYPING
               if not k.endswith(("_jit", "_pallas"))}
    assert not missing, sorted(missing)
