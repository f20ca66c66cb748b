"""The port's SONAR-ADAPT and scalar beta controller against the JAX
reference, on the CPU.

Outcome streams are made with numpy from a seed and fed to both packages.
The EG step is held to `repro.core.adaptive._adapt_step` on the same
buckets; the scalar routers and the batched and sharded engines follow the
reference's weight trajectories within rtol 2e-6 (``torch.exp`` and XLA's
``exp`` may differ by an ulp), with decisions exact.  With ``lr = 0`` the
step is the bitwise identity and SONAR-ADAPT is byte-identical to each
hand-tuned variant on the scalar, batched (both branches) and sharded
paths, as `tests/test_parity_prop.py` pins for the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import adaptive as jadaptive
from repro.core import dataset as jdataset
from repro.core import routing as jrouting
from repro.core.batch_routing import BatchRoutingEngine as JEngine
from repro.core.mesh_routing import ShardedRoutingEngine as JSharded
from repro.traffic import replica_fleet as j_replica_fleet
from repro_torch import convert
from repro_torch.core import adaptive, dataset, routing
from repro_torch.core.batch_routing import make_engine
from repro_torch.core.mesh_routing import make_sharded_engine

RTOL, ATOL = 2e-6, 2e-7
QUERY_TEXTS = [
    "search the web for the latest news",
    "refactor this function in the repository",
    "what is the weather forecast tomorrow",
]
ADAPT_REDUCTIONS = {
    "sonar": dict(load=False, age=False, mask=False, rtt=False),
    "sonar_lb": dict(load=True, age=False, mask=False, rtt=False),
    "sonar_ft": dict(load=True, age=True, mask=True, rtt=False),
    # sonar_geo subclasses SONAR-LB, not -FT: no staleness/failover terms
    "sonar_geo": dict(load=True, age=False, mask=False, rtt=True),
}


def _port_servers(j_servers):
    return [
        dataset.Server(name=s.name, domain=s.domain, description=s.description,
                       tools=[dataset.Tool(t.name, t.description) for t in s.tools])
        for s in j_servers
    ]


def _cfgs(**kw):
    j_cfg = jrouting.RoutingConfig(**kw)
    return j_cfg, convert.routing_config_from_dict(dataclasses.asdict(j_cfg))


def _operands(seed, n):
    rng = np.random.default_rng(seed)
    hist = rng.uniform(5.0, 400.0, (n, 24)).astype(np.float32)
    hist[rng.random(n) < 0.3, -1] = 1050.0
    return dict(latency_hist=hist,
                server_load=(rng.random(n) * 2.0).astype(np.float32),
                telemetry_age_s=(rng.random(n) * 600.0).astype(np.float32),
                failed_mask=rng.random(n) < 0.3,
                client_rtt_ms=(rng.random(n) * 500.0).astype(np.float32))


def _outcomes(seed, n):
    """(latency_ms, ok, feats) stream from numpy."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(50.0, 1500.0, n)
    ok = rng.random(n) < 0.8
    feats = np.stack([rng.random(n), rng.uniform(-1, 1, n), -rng.random(n),
                      -rng.random(n)], axis=1).astype(np.float32)
    return lat, ok, feats


def _state_close(port, ref, ctx=""):
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights), rtol=RTOL,
                               atol=ATOL, err_msg=f"{ctx} weights")
    np.testing.assert_allclose(float(port.baseline), float(ref.baseline), rtol=RTOL, atol=ATOL,
                               err_msg=f"{ctx} baseline")
    assert int(port.step) == int(ref.step), ctx


@pytest.mark.parametrize("n_valid", [0, 1, 5, 64])
def test_adapt_step_matches_reference(n_valid):
    """Three chained EG steps on the same buckets agree with the
    reference's; an all-pad bucket and lr = 0 are the bitwise identity."""
    j_cfg, cfg = _cfgs()
    acfg, j_acfg = adaptive.AdaptConfig(lr=0.3), jadaptive.AdaptConfig(lr=0.3)
    port, ref = adaptive.init_state(cfg, acfg), jadaptive.init_state(j_cfg, j_acfg)
    assert port.weights.numpy().tobytes() == np.asarray(ref.weights).tobytes()
    for rnd in range(3):
        lat, ok, feats = _outcomes(100 * n_valid + rnd, n_valid)
        rewards = [adaptive.shape_reward(a, b, acfg.slo_ms) for a, b in zip(lat, ok)]
        assert rewards == [jadaptive.shape_reward(a, b, j_acfg.slo_ms) for a, b in zip(lat, ok)]
        r, f, v = adaptive.pad_feedback(rewards, list(feats))
        for a, b in zip((r, f, v), jadaptive.pad_feedback(rewards, list(feats))):
            assert a.tobytes() == b.tobytes()
        before = port
        port = adaptive._adapt_step(port, r, f, v, acfg)
        ref = jadaptive._adapt_step(ref, r, f, v, j_acfg)
        _state_close(port, ref, f"round {rnd}")
        if n_valid == 0:
            assert port.weights.numpy().tobytes() == before.weights.numpy().tobytes()
        frozen = adaptive._adapt_step(port, r, f, v, acfg._replace(lr=0.0))
        assert frozen.weights.numpy().tobytes() == port.weights.numpy().tobytes()


def test_helpers_match_reference():
    j_cfg, cfg = _cfgs(alpha=0.6, beta=0.4)
    for x in (dict(expertise=0.3, network=-0.2), dict(expertise=1.0, network=0.5,
                                                       load_pen=0.7, rtt_pen=0.1)):
        assert adaptive.decision_feats(**x).tobytes() == jadaptive.decision_feats(**x).tobytes()
    w = np.array([0.7, 0.3, 0.25, 0.5], np.float32)
    state = convert.adapt_state_from_arrays(w, np.float32(0.4), 7, "cpu")
    j_state = jadaptive.AdaptState(weights=w, baseline=np.float32(0.4), step=np.int32(7))
    assert adaptive.weights_cfg(cfg, state) == convert.routing_config_from_dict(
        dataclasses.asdict(jadaptive.weights_cfg(j_cfg, j_state)))
    assert state.weights.dtype == torch.float32 and state.step.dtype == torch.int32
    with pytest.raises(ValueError):
        convert.adapt_state_from_arrays(w[:3], 0.0, 0, "cpu")
    with pytest.raises(ValueError, match="w_min"):
        adaptive.init_state(dataclasses.replace(cfg, gamma=5.0))


def test_scalar_sonar_adapt_trajectory_matches_reference():
    """The same outcome stream through both scalar routers: identical
    decisions and weight trajectories within tolerance."""
    j_servers = jdataset.build_server_pool(0)
    ops = _operands(3, len(j_servers))
    j_cfg, cfg = _cfgs(top_s=4, top_k=5)
    acfg = adaptive.AdaptConfig(lr=0.5, slo_ms=300.0)
    ref = jadaptive.SonarAdaptRouter(j_servers, j_cfg, adapt=jadaptive.AdaptConfig(*acfg))
    port = routing.make_router("sonar_adapt", _port_servers(j_servers), cfg)
    port.adapt_cfg = acfg
    lat, ok, _ = _outcomes(4, 12)
    for i in range(12):
        q = QUERY_TEXTS[i % 3]
        a, b = port.select(q, **ops), ref.select(q, **ops)
        assert (a.server_idx, a.tool_idx) == (b.server_idx, b.tool_idx), i
        np.testing.assert_allclose(a.fused, b.fused, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port.last_feats, ref.last_feats, rtol=RTOL, atol=ATOL)
        port.observe(lat[i], bool(ok[i]))
        ref.observe(lat[i], bool(ok[i]))
        np.testing.assert_allclose(port.weights, ref.weights, rtol=RTOL, atol=ATOL)
    assert len(port.weight_history) == len(ref.weight_history) == 12
    assert not np.array_equal(port.weights, adaptive.init_state(cfg).weights.numpy())


def test_adaptive_sonar_router_beta_trajectory_matches_reference():
    j_servers = jdataset.build_server_pool(0)
    ops = _operands(5, len(j_servers))
    ref = jadaptive.AdaptiveSonarRouter(j_servers, jrouting.RoutingConfig(top_s=4, top_k=5))
    port = adaptive.AdaptiveSonarRouter(_port_servers(j_servers),
                                        routing.RoutingConfig(top_s=4, top_k=5))
    rng = np.random.default_rng(6)
    for i in range(20):
        lat, online = float(rng.uniform(20, 600)), bool(rng.random() < 0.7)
        port.observe(lat, online)
        ref.observe(lat, online)
        if i % 5 == 0:
            a = port.select(QUERY_TEXTS[i % 3], ops["latency_hist"])
            b = ref.select(QUERY_TEXTS[i % 3], ops["latency_hist"])
            assert (a.server_idx, a.tool_idx) == (b.server_idx, b.tool_idx)
            np.testing.assert_allclose(a.fused, b.fused, rtol=RTOL, atol=ATOL)
    assert port.history == ref.history
    assert port.cfg == convert.routing_config_from_dict(dataclasses.asdict(ref.cfg))
    assert port.adapt.effective_soft_gain == ref.adapt.effective_soft_gain


@pytest.mark.parametrize("sharded", [False, True])
def test_engine_trajectory_matches_reference(sharded):
    """SONAR-ADAPT with lr > 0 over feedback rounds (one overflowing the
    64-slot bucket): decisions exact, weights within tolerance, on the
    batched or the sharded engine, both branches of the port."""
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=1)
    n = len(j_servers)
    ops = _operands(7, n)
    j_cfg, cfg = _cfgs(top_s=4, top_k=5)
    acfg = adaptive.AdaptConfig(lr=0.8, slo_ms=250.0)
    j_acfg = jadaptive.AdaptConfig(*acfg)
    servers = _port_servers(j_servers)
    if sharded:
        ref = JSharded(j_servers, j_cfg, algo="sonar_adapt", n_shards=3, use_kernels=False,
                       adapt=j_acfg)
        ports = [make_sharded_engine("sonar_adapt", servers, cfg, n_shards=3, adapt=acfg,
                                     device="cpu", use_kernels=uk) for uk in (False, True)]
    else:
        ref = JEngine(j_servers, j_cfg, algo="sonar_adapt", use_kernels=False, adapt=j_acfg)
        ports = [make_engine("sonar_adapt", servers, cfg, adapt=acfg, device="cpu",
                             use_kernels=uk) for uk in (False, True)]
    lat, ok, feats = _outcomes(8, 90)
    fed = 0
    for n_fb in (0, 3, 70, 17):
        for e in [ref, *ports]:
            for j in range(fed, fed + n_fb):
                e.observe_feedback(lat[j], bool(ok[j]), feats=feats[j])
        fed += n_fb
        want = ref.route_texts(QUERY_TEXTS, **ops)
        for p in ports:
            got = p.route_texts(QUERY_TEXTS, **ops)
            np.testing.assert_array_equal(got.tool_idx, want.tool_idx)
            np.testing.assert_array_equal(got.server_idx, want.server_idx)
            for a, b in ((got.expertise, want.expertise), (got.network, want.network),
                         (got.fused, want.fused)):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            _state_close(p.learner.state, ref.adapt_state, f"after {fed} outcomes")
    assert not np.array_equal(ports[0].adapt_weights, np.asarray(
        adaptive.init_state(cfg, acfg).weights))


@pytest.mark.parametrize("base", sorted(ADAPT_REDUCTIONS))
def test_zero_lr_byte_identical_to_hand_tuned_paths(base):
    """With lr = 0, SONAR-ADAPT fed a hand-tuned variant's operands is
    byte-identical to it on every decision field (scalar router, batched
    engine on both branches, sharded engine), while feedback keeps
    arriving; and its decisions equal the reference's SONAR-ADAPT."""
    j_servers = j_replica_fleet(5)
    servers = _port_servers(j_servers)
    use = ADAPT_REDUCTIONS[base]
    full = _operands(9, 5)
    kw = dict(latency_hist=full["latency_hist"],
              server_load=full["server_load"] if use["load"] else None,
              telemetry_age_s=full["telemetry_age_s"] if use["age"] else None,
              failed_mask=full["failed_mask"] if use["mask"] else None,
              client_rtt_ms=full["client_rtt_ms"] if use["rtt"] else None)
    j_cfg, cfg = _cfgs(top_s=4, top_k=5)
    acfg = adaptive.AdaptConfig(lr=0.0)

    r_base = routing.make_router(base, servers, cfg)
    r_ad = adaptive.SonarAdaptRouter(servers, cfg, adapt=acfg)
    init_w = r_ad.weights.tobytes()
    fields = ("server_idx", "tool_idx", "expertise", "network", "fused")
    for q in QUERY_TEXTS:
        a, b = r_base.select(q, **kw), r_ad.select(q, **kw)
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
        r_ad.observe_outcome(120.0, ok=True)
    assert r_ad.weights.tobytes() == init_w

    engines = [(f"batch(kernels={uk})",
                make_engine(base, servers, cfg, device="cpu", use_kernels=uk),
                make_engine("sonar_adapt", servers, cfg, adapt=acfg, device="cpu",
                            use_kernels=uk))
               for uk in (False, True)]
    engines.append(("sharded",
                    make_sharded_engine(base, servers, cfg, n_shards=3, device="cpu"),
                    make_sharded_engine("sonar_adapt", servers, cfg, n_shards=3, adapt=acfg,
                                        device="cpu")))
    want = JEngine(j_servers, j_cfg, algo="sonar_adapt", use_kernels=False,
                   adapt=jadaptive.AdaptConfig(lr=0.0)).route_texts(QUERY_TEXTS, **kw)
    for label, e_base, e_ad in engines:
        e_ad.observe_feedback(120.0, ok=True, feats=np.zeros(4, np.float32))
        da, db = e_base.route_texts(QUERY_TEXTS, **kw), e_ad.route_texts(QUERY_TEXTS, **kw)
        for f in fields:
            assert getattr(da, f).tobytes() == getattr(db, f).tobytes(), f"{base} {label} {f}"
        assert e_ad.adapt_weights.tobytes() == init_w, f"{base} {label}: weights moved"
        np.testing.assert_array_equal(db.tool_idx, want.tool_idx)
        np.testing.assert_allclose(db.fused, want.fused, rtol=RTOL, atol=ATOL)
