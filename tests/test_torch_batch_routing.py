"""The port's batched engine against the JAX reference, on the CPU.

`repro_torch`'s `make_engine(algo, servers, cfg, device="cpu")` is held to
`repro`'s `BatchRoutingEngine(use_kernels=False)` and to `repro`'s scalar
`Router.select` loop for the eight hand-tuned algorithms, with shared and
per-query telemetry, tie-heavy replica fleets and the failover loop.
Decisions must match exactly; C, N and S within rtol 2e-6 / atol 2e-7.
Both branches of the port's pipeline run: ``use_kernels=True`` goes
through `kernels/ops`, which runs the plain versions for CPU tensors.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dataset as jdataset
from repro.core import routing as jrouting
from repro.core.batch_routing import BatchRoutingEngine as JEngine
from repro.core.batch_routing import EncodedBatch as JEncodedBatch
from repro.traffic import replica_fleet
from repro_torch import convert
from repro_torch.core import dataset, routing
from repro_torch.core.adaptive import AdaptConfig, SonarAdaptRouter
from repro_torch.core.batch_routing import BatchRoutingEngine, make_engine
from repro_torch.core.routing import RoutingConfig

RTOL, ATOL = 2e-6, 2e-7
ALGOS = ["rag", "rerank_rag", "prag", "sonar", "sonar_lb", "sonar_ft", "sonar_geo",
         "sonar_session"]
ROOT = Path(__file__).resolve().parents[1]
QUERIES = [q.text for q in dataset.build_query_dataset(n=10, seed=1)] + [
    "search the web for the latest news",
    "refactor this function in the repository",
]


def _port_servers(j_servers):
    """The reference's Server objects rebuilt as the port's."""
    return [
        dataset.Server(name=s.name, domain=s.domain, description=s.description,
                       tools=[dataset.Tool(t.name, t.description) for t in s.tools])
        for s in j_servers
    ]


def _operands(seed, n_servers, n_q=None, T=24):
    """Telemetry, load, age, failed mask, RTT and affinity from one seed;
    per-server rows, or per-query rows when ``n_q`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if n_q is None else (n_q,)
    hist = rng.uniform(5.0, 400.0, lead + (n_servers, T)).astype(np.float32)
    down = rng.random(lead + (n_servers,)) < 0.3
    hist[..., -1] = np.where(down, 1050.0, hist[..., -1])
    spikes = rng.random(lead + (n_servers,)) < 0.2
    hist[..., -4:] = np.where(spikes[..., None], 900.0, hist[..., -4:])
    return dict(
        latency_hist=hist,
        server_load=(rng.random(lead + (n_servers,)) * 2.0).astype(np.float32),
        telemetry_age_s=(rng.random(lead + (n_servers,)) * 600.0).astype(np.float32),
        failed_mask=rng.random(lead + (n_servers,)) < 0.25,
        client_rtt_ms=(rng.random(lead + (n_servers,)) * 500.0).astype(np.float32),
        affinity=(rng.random(lead + (n_servers,)) * (rng.random(lead + (n_servers,)) < 0.5))
        .astype(np.float32),
    )


def _same(port, ref, ctx):
    np.testing.assert_array_equal(port.server_idx, ref.server_idx, err_msg=f"{ctx}: server")
    np.testing.assert_array_equal(port.tool_idx, ref.tool_idx, err_msg=f"{ctx}: tool")
    for a, b, nm in ((port.expertise, ref.expertise, "C"), (port.network, ref.network, "N"),
                     (port.fused, ref.fused, "S")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{ctx}: {nm}")
    assert port.select_latency_ms == ref.select_latency_ms


def _scalar_same(router, dec, queries, ops, per_query=False, ctx=""):
    for i, text in enumerate(queries):
        kw = {k: (v[i] if per_query else v) for k, v in ops.items()}
        lat = kw.pop("latency_hist")
        d = router.select(text, lat, **kw)
        assert (d.server_idx, d.tool_idx) == (int(dec.server_idx[i]), int(dec.tool_idx[i])), (
            f"{ctx} query {i}"
        )
        if np.isfinite(d.fused):
            np.testing.assert_allclose(dec.fused[i], d.fused, rtol=RTOL, atol=ATOL)
        else:
            assert dec.fused[i] <= -1e29


def _port_cfg(j_cfg):
    return convert.routing_config_from_dict(dataclasses.asdict(j_cfg))


def _check_fleet(algo, j_servers, cfg, ops, queries, n_scalar, per_query=False):
    j_router = jrouting.make_router(algo, j_servers, cfg)
    ref = JEngine(j_servers, cfg, algo=algo, use_kernels=False, index=j_router.index)
    want = ref.route_texts(queries, **ops)
    servers = _port_servers(j_servers)
    for use_kernels in (False, True):
        eng = make_engine(algo, servers, _port_cfg(cfg), device="cpu", use_kernels=use_kernels)
        _same(eng.route_texts(queries, **ops), want, f"{algo} use_kernels={use_kernels}")
    _scalar_same(j_router, want, queries[:n_scalar], ops, per_query, ctx=algo)


@pytest.mark.parametrize("algo", ALGOS)
def test_shared_telemetry_matches_reference_engine_and_scalar(algo):
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=2)
    cfg = jrouting.RoutingConfig(top_s=4, top_k=5)
    _check_fleet(algo, j_servers, cfg, _operands(1, len(j_servers)), QUERIES, n_scalar=3)


@pytest.mark.parametrize("algo", ALGOS)
def test_per_query_telemetry_matches_reference(algo):
    j_servers = jdataset.build_server_pool(0)
    cfg = jrouting.RoutingConfig(top_s=3, top_k=4)
    ops = _operands(2, len(j_servers), n_q=len(QUERIES))
    _check_fleet(algo, j_servers, cfg, ops, QUERIES, n_scalar=2, per_query=True)


@pytest.mark.parametrize(
    "n_servers,algo",
    [(9, "rag"), (9, "sonar_lb"), (11, "sonar_ft"), (11, "sonar_session"), (5, "sonar"),
     (16, "rerank_rag")],
)
def test_identical_replica_fleet_ties(n_servers, algo):
    """Identical replicas tie exactly in every score: the stable top-s and
    top-k must break each tie toward the lower index, as the reference."""
    j_servers = replica_fleet(n_servers)
    cfg = jrouting.RoutingConfig(top_s=min(4, n_servers), top_k=5)
    ops = _operands(n_servers, n_servers)
    ops["latency_hist"][:] = 30.0                   # equal QoS: ties reach the argmax
    _check_fleet(algo, j_servers, cfg, ops, QUERIES[:4], n_scalar=2)


@pytest.mark.parametrize("n_per_template", [3, 4])
def test_larger_mock_clusters(n_per_template):
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(1), n_per_template, seed=1)
    cfg = jrouting.RoutingConfig(top_s=8, top_k=8)
    _check_fleet("sonar_ft", j_servers, cfg, _operands(3, len(j_servers)), QUERIES, n_scalar=2)


def test_region_rtt_gather_matches_reference():
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=2)
    cfg = jrouting.RoutingConfig(top_s=4, top_k=5)
    rng = np.random.default_rng(4)
    ops = _operands(4, len(j_servers))
    ops.pop("client_rtt_ms")
    ops["client_region"] = rng.integers(-1, 3, len(QUERIES)).astype(np.int32)
    ops["region_rtt_ms"] = (rng.random((3, len(j_servers))) * 400.0).astype(np.float32)
    j_router = jrouting.make_router("sonar_session", j_servers, cfg)
    want = JEngine(j_servers, cfg, algo="sonar_session", use_kernels=False,
                   index=j_router.index).route_texts(QUERIES, **ops)
    for use_kernels in (False, True):
        eng = make_engine("sonar_session", _port_servers(j_servers), _port_cfg(cfg),
                          device="cpu", use_kernels=use_kernels)
        _same(eng.route_texts(QUERIES, **ops), want, f"region use_kernels={use_kernels}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_failover_loop_matches_reference(seed):
    """Port `route_failover` against the reference's scalar
    `select_failover` and batched `route_failover` (picks and counts)."""
    rng = np.random.default_rng(seed)
    n_servers = int(rng.integers(2, 6))
    j_servers = (replica_fleet(n_servers) if seed % 2 else
                 [jdataset.build_server_pool(0)[i]
                  for i in rng.choice(15, n_servers, replace=False)])
    ops = _operands(seed + 10, n_servers)
    alive = rng.random(n_servers) < 0.5
    budget = int(rng.integers(0, 4))
    cfg = jrouting.RoutingConfig(top_s=n_servers, top_k=n_servers)
    j_router = jrouting.make_router("sonar_ft", j_servers, cfg)
    j_eng = JEngine(j_servers, cfg, algo="sonar_ft", use_kernels=False, index=j_router.index)
    texts = QUERIES[-2:] + QUERIES[:1]
    args = (ops["latency_hist"], ops["server_load"], ops["telemetry_age_s"])
    want, want_n = j_eng.route_failover(j_eng.encode(texts), *args, alive=alive, budget=budget)
    eng = make_engine("sonar_ft", _port_servers(j_servers), _port_cfg(cfg), device="cpu")
    dec, nf = eng.route_failover(eng.encode(texts), *args, alive=alive, budget=budget)
    _same(dec, want, "failover")
    np.testing.assert_array_equal(nf, want_n)
    for i, q in enumerate(texts):
        d, f = j_router.select_failover(q, *args[:2], telemetry_age_s=args[2], alive=alive,
                                        budget=budget)
        assert (d.server_idx, d.tool_idx, f) == (int(dec.server_idx[i]), int(dec.tool_idx[i]),
                                                 int(nf[i]))


@pytest.mark.parametrize("algo", ALGOS)
def test_kernel_branch_equals_unfused_branch(algo):
    """``use_kernels=True`` (dispatch through `kernels/ops`) and the unfused
    pipeline agree on the CPU, per-query rows included."""
    servers = dataset.mock_cluster(dataset.build_server_pool(2), 3, seed=2)
    cfg = RoutingConfig(top_s=5, top_k=6)
    idx = routing.ToolIndex(servers)
    for ops in (_operands(5, len(servers)), _operands(6, len(servers), n_q=len(QUERIES))):
        a = make_engine(algo, servers, cfg, device="cpu", use_kernels=True, index=idx)
        b = make_engine(algo, servers, cfg, device="cpu", use_kernels=False, index=idx)
        _same(a.route_texts(QUERIES, **ops), b.route_texts(QUERIES, **ops), algo)


def test_port_scalar_router_matches_reference_scalar_router():
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=2)
    servers = _port_servers(j_servers)
    ops = _operands(7, len(servers))
    cfg = RoutingConfig(top_s=4, top_k=5)
    for algo in ALGOS:
        mine = routing.make_router(algo, servers, cfg)
        ref = jrouting.make_router(algo, j_servers, jrouting.RoutingConfig(top_s=4, top_k=5))
        for q in QUERIES[:2]:
            a = mine.select(q, **ops)
            b = ref.select(q, **ops)
            assert (a.server_idx, a.tool_idx) == (b.server_idx, b.tool_idx)
            assert a.candidate_tools == b.candidate_tools
            assert a.candidate_servers == b.candidate_servers
            np.testing.assert_allclose(a.fused, b.fused, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a.network, b.network, rtol=RTOL, atol=ATOL)


def test_empty_batch_slice_and_pad_to():
    servers = dataset.build_server_pool(0)
    eng = make_engine("sonar", servers, device="cpu")
    dec = eng.route_texts([])
    assert len(dec) == 0 and dec.server_idx.dtype == np.int32
    enc = make_engine("rerank_rag", servers, device="cpu").encode(QUERIES[:5])
    j_enc = JEncodedBatch(enc.q_server, enc.q_tool, enc.q_rerank, enc.n)
    for a, b in ((enc.pad_to(8), j_enc.pad_to(8)), (enc.slice(1, 4), j_enc.slice(1, 4)),
                 (enc.pad_to(3), j_enc.pad_to(3)), (enc.slice(4, 99), j_enc.slice(4, 99))):
        assert a.n == b.n
        for f in ("q_server", "q_tool", "q_rerank"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    ops = _operands(8, len(servers))
    full = eng.route(eng.encode(QUERIES[:5]), ops["latency_hist"])
    padded = eng.route(eng.encode(QUERIES[:5]).pad_to(8), ops["latency_hist"])
    np.testing.assert_array_equal(padded.tool_idx[:5], full.tool_idx)
    np.testing.assert_array_equal(padded.fused[:5], full.fused)


def test_convert_index_and_config_from_reference():
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=3)
    j_index = jrouting.ToolIndex(j_servers)
    servers = _port_servers(j_servers)
    index = convert.index_from_arrays(
        j_index.server_corpus.weights, j_index.tool_corpus.weights, j_index.tool_server,
        j_index.server_corpus.vocab, j_index.tool_corpus.vocab, j_index.tool_names, servers,
    )
    own = routing.ToolIndex(servers)
    assert index.server_corpus.weights.tobytes() == own.server_corpus.weights.tobytes()
    assert index.tool_corpus.weights.tobytes() == own.tool_corpus.weights.tobytes()
    assert index.tool_server.tobytes() == own.tool_server.tobytes()
    assert index.tool_names == own.tool_names and index.n_tools == own.n_tools
    j_cfg = jrouting.RoutingConfig(top_s=3, top_k=7, gamma=0.2,
                                   qos=jrouting.QosParams(window=16, w_high=0.5))
    cfg = convert.routing_config_from_dict(dataclasses.asdict(j_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    ops = _operands(9, len(servers))
    for algo in ("rerank_rag", "sonar_session"):
        a = make_engine(algo, servers, cfg, device="cpu", index=index).route_texts(QUERIES, **ops)
        b = make_engine(algo, servers, cfg, device="cpu").route_texts(QUERIES, **ops)
        _same(a, b, f"converted index {algo}")
    with pytest.raises(ValueError):
        convert.index_from_arrays(j_index.server_corpus.weights, j_index.tool_corpus.weights,
                                  j_index.tool_server[:-1], j_index.server_corpus.vocab,
                                  j_index.tool_corpus.vocab, j_index.tool_names, servers)


def test_device_rule_and_deferred_adapt(monkeypatch):
    servers = dataset.build_server_pool(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchRoutingEngine(servers)
    with pytest.raises(RuntimeError):
        make_engine("sonar", servers, device="cuda")
    assert make_engine("sonar", servers, device="cpu").use_kernels is False
    # SONAR-ADAPT is ported: the engine, the adapt= option and the scalar
    # router build, and the learner starts from the config's weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine("sonar_adapt", servers)
    eng = make_engine("sonar_adapt", servers, device="cpu")
    assert eng.learner is not None and eng.learner.state.weights.device.type == "cpu"
    cfg = RoutingConfig()
    assert eng.adapt_weights.tobytes() == np.asarray(
        [cfg.alpha, cfg.beta, cfg.gamma, cfg.delta], np.float32).tobytes()
    assert make_engine("sonar", servers, device="cpu").learner is None
    lr0 = make_engine("sonar", servers, device="cpu", adapt=AdaptConfig(lr=0.0))
    assert lr0.learner.cfg.lr == 0.0 and lr0.learner.pending_weights() is None
    assert isinstance(routing.make_router("sonar-adapt", servers), SonarAdaptRouter)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "for m in ('core.batch_routing', 'core.mesh_routing', 'core.adaptive',\n"
        "          'traffic.fleet', 'kernels.select_fuse', 'kernels.flash_attention',\n"
        "          'kernels.decode_attention', 'models.api', 'models.lm', 'nn.core',\n"
        "          'configs.internlm2_1_8b', 'obs.trace', 'serving.engine'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    pattern = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f"{f} imports jax or the reference"


def test_engine_keeps_transposed_server_weights_and_tool_csr():
    """The engine holds its server weights once, transposed ([V_s,
    n_servers], the BM25 kernel's layout), equal to the reference index's
    weights; and the server -> tools map of its tool array, which for a
    `ToolIndex` (tools listed server by server) is the identity order."""
    j_servers = jdataset.mock_cluster(jdataset.build_server_pool(0), n_per_template=3)
    j_index = jrouting.ToolIndex(j_servers)
    eng = make_engine("sonar", _port_servers(j_servers), device="cpu")
    w = np.asarray(j_index.server_corpus.weights, np.float32)
    assert eng._w_server_t.shape == w.T.shape and eng._w_server_t.is_contiguous()
    assert eng._w_server_t.numpy().tobytes() == np.ascontiguousarray(w.T).tobytes()
    assert not hasattr(eng, "_w_server")          # no second, row-major copy
    assert eng.n_servers == len(j_servers)
    csr = eng._tool_csr
    ts = np.asarray(j_index.tool_server)
    np.testing.assert_array_equal(csr.tools.numpy(), np.arange(len(ts)))
    np.testing.assert_array_equal(csr.offsets.numpy(),
                                  np.searchsorted(ts, np.arange(len(j_servers) + 1)))
