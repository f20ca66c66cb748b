"""The port's shard-stacked mega-fleet engine against the JAX reference, on
the CPU.

`repro_torch`'s `ShardedRoutingEngine(device="cpu")` is held to `repro`'s
`ShardedRoutingEngine(use_kernels=False)` (and, for one case, to its
Pallas path in interpret mode), and to the port's own single-device
`BatchRoutingEngine`: ragged shard splits, a whole dead shard, k larger
than a shard's slice, per-query telemetry, region RTT gathers, tiled
fleets with template-compact telemetry, and all nine algorithms.
Decisions must match exactly; C, N and S within rtol 2e-6 / atol 2e-7.
Both branches run: ``use_kernels=True`` goes through `kernels/ops`, which
runs the plain versions for CPU tensors.  Sizes stay small: at most 60
tiled servers, 8 dense servers and 3 queries.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import adaptive as jadaptive  # noqa: F401  (registers sonar_adapt)
from repro.core import dataset as jdataset
from repro.core import routing as jrouting
from repro.core.batch_routing import BatchRoutingEngine as JEngine
from repro.core.latency import OFFLINE_MS
from repro.core.mesh_routing import ShardedRoutingEngine as JSharded
from repro.core.mesh_routing import make_shard_plan as j_make_shard_plan
from repro.traffic import mega_fleet_index as j_mega_fleet_index
from repro.traffic import replica_fleet as j_replica_fleet
from repro_torch import convert
from repro_torch.core import dataset
from repro_torch.core.batch_routing import make_engine
from repro_torch.core.mesh_routing import (
    ShardedRoutingEngine,
    TiledFleetIndex,
    make_shard_plan,
    make_sharded_engine,
)
from repro_torch.core.routing import ToolIndex
from repro_torch.kernels import ops
from repro_torch.obs import DeviceRouteStats
from repro_torch.traffic import mega_fleet_index, replica_fleet

RTOL, ATOL = 2e-6, 2e-7
ALGOS = sorted(jrouting.ALGORITHMS)
POOL = jdataset.build_server_pool(seed=0)
QUERY_TEXTS = [
    "search the web for the latest news",
    "refactor this function in the repository",
    "what is the weather forecast tomorrow",
]


def _port_servers(j_servers):
    return [
        dataset.Server(name=s.name, domain=s.domain, description=s.description,
                       tools=[dataset.Tool(t.name, t.description) for t in s.tools])
        for s in j_servers
    ]


def _cfg(**kw):
    j_cfg = jrouting.RoutingConfig(**kw)
    return j_cfg, convert.routing_config_from_dict(dataclasses.asdict(j_cfg))


def _materialize(seed, n_servers, identical, all_offline, mask_kind):
    """Fleet + telemetry + load + age + failed mask + RTT + affinity from one
    seed (the construction of tests/test_mesh_routing.py)."""
    rng = np.random.default_rng(seed)
    if identical:
        servers = j_replica_fleet(n_servers)
    else:
        pick = rng.choice(len(POOL), size=n_servers, replace=False)
        servers = [POOL[i] for i in pick]
    hist = rng.uniform(5.0, 400.0, size=(n_servers, 24)).astype(np.float32)
    if all_offline:
        hist[:, -1] = OFFLINE_MS + 100.0
    else:
        hist[rng.random(n_servers) < 0.3, -1] = OFFLINE_MS + 50.0
    load = (rng.random(n_servers) * 2.0).astype(np.float32)
    age = (rng.random(n_servers) * 600.0).astype(np.float32)
    mask = {"none": None, "all": np.ones(n_servers, bool)}.get(
        mask_kind, rng.random(n_servers) < 0.4)
    extra = dict(client_rtt_ms=(rng.random(n_servers) * 500.0).astype(np.float32),
                 affinity=rng.random(n_servers).astype(np.float32))
    return servers, hist, load, age, mask, extra


def _same(port, ref, ctx):
    np.testing.assert_array_equal(port.server_idx, ref.server_idx, err_msg=f"{ctx}: server")
    np.testing.assert_array_equal(port.tool_idx, ref.tool_idx, err_msg=f"{ctx}: tool")
    for a, b, nm in ((port.expertise, ref.expertise, "C"), (port.network, ref.network, "N"),
                     (port.fused, ref.fused, "S")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{ctx}: {nm}")


def _check(j_servers, j_cfg, cfg, algo, n_shards, args, kw=None, ctx=""):
    """Port sharded (both branches) and port single engine vs the
    reference's sharded engine."""
    kw = kw or {}
    want = JSharded(j_servers, j_cfg, algo=algo, n_shards=n_shards,
                    use_kernels=False).route_texts(QUERY_TEXTS, *args, **kw)
    servers = _port_servers(j_servers)
    index = ToolIndex(servers)
    for use_kernels in (False, True):
        eng = ShardedRoutingEngine(servers, cfg, algo=algo, n_shards=n_shards, index=index,
                                   device="cpu", use_kernels=use_kernels)
        _same(eng.route_texts(QUERY_TEXTS, *args, **kw), want,
              f"{ctx} {algo} J={n_shards} use_kernels={use_kernels}")
    single = make_engine(algo, servers, cfg, index=index, device="cpu")
    _same(single.route_texts(QUERY_TEXTS, *args, **kw), want, f"{ctx} {algo} single engine")
    return want


@settings(max_examples=8, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    algo=st.sampled_from(ALGOS),
    n_servers=st.integers(2, 8),
    n_shards=st.integers(1, 5),
    identical=st.booleans(),
    all_offline=st.booleans(),
    mask_kind=st.sampled_from(["none", "some", "all"]),
)
def test_sharded_matches_reference(seed, algo, n_servers, n_shards, identical, all_offline,
                                   mask_kind):
    """Property: the port's sharded engine == the reference's sharded
    engine == the port's single engine, any (fleet, shard count) split,
    with load, ages, fault masks, RTT rows and affinity in play."""
    servers, hist, load, age, mask, extra = _materialize(
        seed, n_servers, identical, all_offline, mask_kind)
    j_cfg, cfg = _cfg(top_s=min(4, n_servers), top_k=5)
    _check(servers, j_cfg, cfg, algo, n_shards, (hist, load, age, mask), extra,
           ctx=f"seed={seed} n={n_servers} identical={identical} offline={all_offline} "
               f"mask={mask_kind}")


def test_indivisible_fleet_all_shard_counts():
    """7 servers across J=1..7 shards: every split, most with a ragged tail
    shard, reproduces the reference's single-device decision."""
    j_servers, hist, load, age, mask, _ = _materialize(11, 7, True, False, "some")
    j_cfg, cfg = _cfg(top_s=3, top_k=4)
    servers = _port_servers(j_servers)
    index = ToolIndex(servers)
    for algo in ("sonar", "sonar_lb", "sonar_ft"):
        want = JEngine(j_servers, j_cfg, algo=algo, use_kernels=False).route_texts(
            QUERY_TEXTS, hist, load, age, mask)
        for n_shards in range(1, 8):
            for use_kernels in (False, True):
                eng = make_sharded_engine(algo, servers, cfg, n_shards=n_shards, index=index,
                                          device="cpu", use_kernels=use_kernels)
                _same(eng.route_texts(QUERY_TEXTS, hist, load, age, mask), want,
                      f"{algo} J={n_shards} use_kernels={use_kernels}")


def test_whole_shard_dead():
    """Every server of shard 0 (and, separately, of the last shard) is
    masked: the winner comes from a live shard, as the reference's."""
    n, n_shards = 8, 4
    servers = j_replica_fleet(n)
    hist = np.random.default_rng(3).uniform(5.0, 400.0, size=(n, 24)).astype(np.float32)
    j_cfg, cfg = _cfg(top_s=4, top_k=5)
    s_pad = -(-n // n_shards)
    for dead_shard in (0, n_shards - 1):
        mask = np.zeros(n, bool)
        mask[dead_shard * s_pad:(dead_shard + 1) * s_pad] = True
        want = _check(servers, j_cfg, cfg, "sonar_ft", n_shards, (hist,),
                      dict(failed_mask=mask), ctx=f"dead shard {dead_shard}")
        assert not np.isin(want.server_idx, np.flatnonzero(mask)).any()


def test_k_larger_than_shard_slice():
    """top_s and top_k exceed every shard's slice: shards contribute their
    whole slices and the merge still recovers the global top-k."""
    n = 6
    rng = np.random.default_rng(7)
    hist = rng.uniform(5.0, 400.0, size=(n, 24)).astype(np.float32)
    load = (rng.random(n) * 1.5).astype(np.float32)
    j_cfg, cfg = _cfg(top_s=6, top_k=12)
    for algo in ("sonar", "sonar_lb"):
        _check(j_replica_fleet(n), j_cfg, cfg, algo, 6, (hist, load))


@pytest.mark.parametrize("n_servers,n_shards", [(15, 4), (15, 99), (7, 3), (1, 2)])
def test_shard_plan_matches_reference(n_servers, n_shards):
    """Plan arrays byte-equal to the reference's, and the plan invariants:
    every real server and tool once, tools on their host's shard."""
    idx = ToolIndex(_port_servers(POOL[:n_servers]))
    plan = make_shard_plan(idx.tool_server, n_servers, n_shards)
    ref = j_make_shard_plan(idx.tool_server, n_servers, n_shards)
    assert (plan.n_shards, plan.s_pad, plan.t_pad) == (ref.n_shards, ref.s_pad, ref.t_pad)
    for f in ("server_gid", "server_valid", "tool_gid", "tool_valid", "tool_host_global",
              "tool_host_local"):
        a, b = getattr(plan, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert sorted(plan.server_gid[plan.server_valid].tolist()) == list(range(n_servers))
    assert sorted(plan.tool_gid[plan.tool_valid].tolist()) == list(range(idx.n_tools))
    shard_of_tool = np.repeat(np.arange(plan.n_shards), plan.t_pad).reshape(
        plan.n_shards, plan.t_pad)[plan.tool_valid]
    assert np.array_equal(plan.tool_host_global[plan.tool_valid] // plan.s_pad, shard_of_tool)


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16", "int8"])
def test_tiled_index_byte_equal_to_reference(weights_dtype):
    idx = mega_fleet_index(37, weights_dtype=weights_dtype)
    ref = j_mega_fleet_index(37, weights_dtype=weights_dtype)
    assert (idx.n_servers, idx.n_tools) == (ref.n_servers, ref.n_tools)
    for f in ("server_doc_map", "tool_server", "tool_doc_map"):
        assert getattr(idx, f).tobytes() == getattr(ref, f).tobytes(), f
    for c in ("server_corpus", "tool_corpus"):
        a, b = getattr(idx, c), getattr(ref, c)
        assert a.vocab == b.vocab and a.n_docs == b.n_docs
        assert a.weights.dtype == b.weights.dtype and a.weights.tobytes() == b.weights.tobytes()
    d, r = idx.densify(), ref.densify()
    assert d.server_corpus.weights.tobytes() == r.server_corpus.weights.tobytes()
    assert d.tool_corpus.weights.tobytes() == r.tool_corpus.weights.tobytes()
    assert isinstance(idx, TiledFleetIndex) and d.n_tools == r.n_tools


def _tiled_operands(n, seed=5, m_t=6):
    rng = np.random.default_rng(seed)
    tel_map = (np.arange(n) * 5) % m_t
    return dict(
        compact=rng.uniform(5.0, 400.0, size=(m_t, 24)).astype(np.float32),
        tel_map=tel_map,
        server_load=(rng.random(n) * 2.0).astype(np.float32),
        telemetry_age_s=(rng.random(n) * 600.0).astype(np.float32),
        failed_mask=rng.random(n) < 0.2,
        client_region=np.array([0, -1, 2], np.int32),
        region_rtt_ms=(rng.random((3, n)) * 400.0).astype(np.float32),
        affinity=(rng.random(n) * (rng.random(n) < 0.5)).astype(np.float32),
    )


@pytest.mark.parametrize("algo", ALGOS)
def test_tiled_fleet_matches_reference_and_densified(algo):
    """`make_sharded_engine(algo, index=mega_fleet_index(60))` against the
    reference's sharded engine (template-compact telemetry, region RTT
    gathers), and against the port's single engine on the densified index."""
    n = 60
    op = _tiled_operands(n)
    compact, tel_map = op.pop("compact"), op.pop("tel_map")
    j_cfg, cfg = _cfg(top_s=5, top_k=8)
    want = JSharded(cfg=j_cfg, algo=algo, n_shards=5, use_kernels=False,
                    index=j_mega_fleet_index(n)).route_texts(
        QUERY_TEXTS, telemetry_templates=(compact, tel_map), **op)
    idx = mega_fleet_index(n)
    for use_kernels in (False, True):
        eng = make_sharded_engine(algo, cfg=cfg, n_shards=5, index=idx, device="cpu",
                                  use_kernels=use_kernels)
        assert eng.compact_stage2
        got = eng.route_texts(QUERY_TEXTS, telemetry_templates=(compact, tel_map), **op)
        _same(got, want, f"tiled {algo} use_kernels={use_kernels}")
    dense = make_engine(algo, [], cfg, index=idx.densify(), device="cpu")
    _same(dense.route_texts(QUERY_TEXTS, compact[tel_map], **op), want, f"densified {algo}")


def _dense_telemetry_operands(n, seed):
    rng = np.random.default_rng(seed)
    n_q = len(QUERY_TEXTS)
    hist = rng.uniform(5.0, 400.0, (n, 24)).astype(np.float32)
    hist_q = rng.uniform(5.0, 400.0, (n_q, n, 24)).astype(np.float32)
    load_q = (rng.random((n_q, n)) * 2.0).astype(np.float32)
    mask_q = rng.random((n_q, n)) < 0.3
    return (hist,), (hist_q, load_q, None, mask_q)


@pytest.mark.parametrize("compact_stage2", [False, True])
def test_tiled_dense_telemetry_and_per_query_rows(compact_stage2):
    """Tiled index with dense shared and per-query telemetry windows: the
    port's candidate-compacted stage 2 against the reference's stage 2 on
    its full tool axis (False) and compacted (True)."""
    n = 30
    j_cfg, cfg = _cfg(top_s=4, top_k=6)
    idx, j_idx = mega_fleet_index(n), j_mega_fleet_index(n)
    for algo in ("rerank_rag", "sonar_ft", "sonar_adapt"):
        for args in _dense_telemetry_operands(n, 8):
            want = JSharded(cfg=j_cfg, algo=algo, n_shards=3, use_kernels=False, index=j_idx,
                            compact_stage2=compact_stage2).route_texts(QUERY_TEXTS, *args)
            eng = make_sharded_engine(algo, cfg=cfg, n_shards=3, index=idx, device="cpu")
            assert eng.compact_stage2
            _same(eng.route_texts(QUERY_TEXTS, *args), want,
                  f"{algo} reference compact={compact_stage2} ndim={args[0].ndim}")


@pytest.mark.parametrize("algo", ["rag", "sonar_ft", "sonar_adapt"])
def test_tiled_fleet_smaller_than_top_s_takes_full_tool_axis(algo):
    """A tiled fleet with fewer servers than top_s does not qualify for
    the compacted stage 2: the port's full-tool-axis tiled path against the
    reference's, with dense shared and per-query telemetry, both branches."""
    n = 3
    j_cfg, cfg = _cfg(top_s=4, top_k=6)
    idx, j_idx = mega_fleet_index(n), j_mega_fleet_index(n)
    for args in _dense_telemetry_operands(n, 12):
        ref = JSharded(cfg=j_cfg, algo=algo, n_shards=2, use_kernels=False, index=j_idx)
        assert not ref.compact_stage2
        want = ref.route_texts(QUERY_TEXTS, *args)
        for use_kernels in (False, True):
            eng = make_sharded_engine(algo, cfg=cfg, n_shards=2, index=idx, device="cpu",
                                      use_kernels=use_kernels)
            assert not eng.compact_stage2
            _same(eng.route_texts(QUERY_TEXTS, *args), want,
                  f"{algo} use_kernels={use_kernels} ndim={args[0].ndim}")


@pytest.mark.parametrize("tiled,n_shards,top_s,kernel", [
    (True, 4, 8, True), (False, 3, 4, True), (True, 2, 200, False),
])
def test_stage1_selection_kernel_choice_and_decisions(monkeypatch, tiled, n_shards, top_s,
                                                      kernel):
    """With ``use_kernels`` the engine takes `ops.stage1_topk` for stage 1
    (once per route; a tiled fleet's template scores go in with the doc
    map) when the per-shard s_keep fits the kernel, else its plain version;
    without, the plain version.  Decisions equal across the two (on the CPU
    both run the plain selection)."""
    calls = []
    real = ops.stage1_topk

    def counted(scores, *a, doc_map=None, **kw):
        calls.append((tuple(scores.shape), doc_map is not None))
        return real(scores, *a, doc_map=doc_map, **kw)

    monkeypatch.setattr(ops, "stage1_topk", counted)
    rng = np.random.default_rng(31)
    if tiled:
        n = 600
        op = _tiled_operands(n)
        kw = dict(telemetry_templates=(op.pop("compact"), op.pop("tel_map")),
                  server_load=op["server_load"], telemetry_age_s=op["telemetry_age_s"],
                  failed_mask=op["failed_mask"])
        make = dict(index=mega_fleet_index(n))
    else:
        servers, hist, load, age, mask, _ = _materialize(5, 8, False, False, "some")
        kw = dict(latency_hist=hist, server_load=load, telemetry_age_s=age,
                  failed_mask=rng.random((len(QUERY_TEXTS), 8)) < 0.4)
        make = dict(servers=_port_servers(servers))
    _, cfg = _cfg(top_s=top_s, top_k=6)
    got = {}
    for use_kernels in (True, False):
        eng = make_sharded_engine("sonar_ft", cfg=cfg, n_shards=n_shards, device="cpu",
                                  use_kernels=use_kernels, **make)
        assert eng.stage1_kernel == (use_kernels and kernel)
        calls.clear()
        got[use_kernels] = eng.route_texts(QUERY_TEXTS, **kw)
        n_q = len(QUERY_TEXTS)
        want = ([((n_q, len(eng.index.templates)), True) if tiled
                 else ((n_shards, n_q, eng.plan.s_pad), False)]
                if eng.stage1_kernel else [])
        assert calls == want
    _same(got[True], got[False], f"tiled={tiled} top_s={top_s}")


def test_kernel_path_parity_with_pallas_interpret():
    """The port's kernel branch against the reference's Pallas
    fused-selection kernel in interpret mode."""
    servers, hist, load, age, mask, _ = _materialize(23, 6, True, False, "some")
    j_cfg, cfg = _cfg(top_s=4, top_k=5)
    want = JSharded(servers, j_cfg, algo="sonar_ft", n_shards=3, use_kernels=True,
                    interpret=True).route_texts(QUERY_TEXTS, hist, load, age, mask)
    got = make_sharded_engine("sonar_ft", _port_servers(servers), cfg, n_shards=3,
                              device="cpu", use_kernels=True).route_texts(
        QUERY_TEXTS, hist, load, age, mask)
    _same(got, want, "pallas interpret")


def test_per_query_telemetry_parity():
    """Per-query windows, loads, ages and masks shard along axis 1."""
    rng = np.random.default_rng(9)
    n, n_q = 6, len(QUERY_TEXTS)
    args = (rng.uniform(5.0, 400.0, size=(n_q, n, 24)).astype(np.float32),
            (rng.random((n_q, n)) * 2.0).astype(np.float32),
            (rng.random((n_q, n)) * 600.0).astype(np.float32),
            rng.random((n_q, n)) < 0.3)
    j_cfg, cfg = _cfg(top_s=4, top_k=5)
    _check(j_replica_fleet(n), j_cfg, cfg, "sonar_ft", 4, args)


def test_region_rtt_gather_dense_shards():
    servers, hist, load, _age, _mask, _ = _materialize(4, 8, False, False, "none")
    rng = np.random.default_rng(4)
    kw = dict(client_region=np.array([1, -1, 0], np.int32),
              region_rtt_ms=(rng.random((2, 8)) * 400.0).astype(np.float32))
    j_cfg, cfg = _cfg(top_s=4, top_k=5)
    for algo in ("sonar_geo", "sonar_adapt"):
        _check(servers, j_cfg, cfg, algo, 3, (hist, load), kw)


def test_device_rule_mesh_route_stats_and_empty_batch(monkeypatch):
    idx = mega_fleet_index(20)
    eng = make_sharded_engine("sonar_adapt", index=idx, device="cpu")
    assert eng.use_kernels is False and eng.learner is not None
    assert eng.mesh is None
    assert make_sharded_engine("sonar", index=idx, device="cpu", mesh="auto").mesh is None
    dec = eng.route_texts([])
    assert len(dec) == 0 and dec.server_idx.dtype == np.int32
    with pytest.raises(NotImplementedError, match="mesh"):
        make_sharded_engine("sonar", index=idx, device="cpu", mesh=object())
    drs = DeviceRouteStats(idx.n_servers)
    d = eng.route(eng.encode(QUERY_TEXTS), route_stats=drs)
    out = drs.fold()
    np.testing.assert_array_equal(out["picks"], np.bincount(d.server_idx, minlength=idx.n_servers))
    assert out["n_routed"] == len(QUERY_TEXTS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_engine("sonar", index=idx)
    with pytest.raises(RuntimeError):
        ShardedRoutingEngine(replica_fleet(3), device="cuda")
