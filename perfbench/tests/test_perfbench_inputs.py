"""The benchmark's generators, counts and references on the CPU: traffic
repeats by seed, counts equal hand-worked formulas, and each plain
reference agrees with the port at a tiny size (this test imports both;
the references import nothing of the port)."""
import ast
import json

import numpy as np
import pytest
import torch

from perfbench.counts import lm as counts
from perfbench.reference import lm as ref_lm
from perfbench.reference import routing as ref_routing
from perfbench.traffic import fleet, requests, tokens
from perfbench.tests.tiny import ROOT, TINY_MODEL

POOL = json.loads((ROOT / "perfbench/data/netmcp_pool.json").read_text())
SERVE = json.loads((ROOT / "perfbench/workloads/internlm2-1.8b.serve-agent.json").read_text())
ROUTE = json.loads((ROOT / "perfbench/workloads/netmcp-mega-1m.sonar_ft-b256.json").read_text())
MEGA = json.loads((ROOT / "perfbench/configs/netmcp-mega-1m.json").read_text())


def tiny_dims():
    cfg = json.loads((ROOT / "perfbench/configs/internlm2-1.8b.json").read_text())
    cfg["model"].update(TINY_MODEL)
    return cfg, ref_lm.dims(cfg)


# -- traffic -----------------------------------------------------------------

def test_token_batches_repeat_by_seed_and_differ_by_step():
    a = tokens.batch(2**33 + 5, 3, 4, 64, 92544, 1.1)
    b = tokens.batch(2**33 + 5, 3, 4, 64, 92544, 1.1)
    c = tokens.batch(2**33 + 5, 4, 4, 64, 92544, 1.1)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].max()) < 4096 and (a["labels"][:, -1] == -100).all()
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_serving_schedule_is_the_cells_own_and_the_seed_draws_the_tokens():
    mix = SERVE["mix"]
    a = requests.schedule(7, 120, mix, 92544)
    b = requests.schedule(7, 120, mix, 92544)
    c = requests.schedule(2**33 + 8, 120, mix, 92544)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    for f in (lambda x: x.due_s, lambda x: len(x.prompt), lambda x: x.max_new_tokens):
        assert list(map(f, a)) == list(map(f, c))           # one schedule for every seed
    lengths = [len(x.prompt) for x in a]
    assert mix["prompt_min"] <= min(lengths) and max(lengths) <= mix["prompt_max"]
    assert len(set(x.max_new_tokens for x in a)) > 10
    assert a[0].due_s == 0.0
    assert abs(a[-1].due_s - 119 / mix["rate_per_s"]) < 119 / mix["rate_per_s"] * 0.3


@pytest.mark.parametrize("rate", [1.5, 6.0])
def test_serving_schedule_is_prefix_stable_and_stretches_with_the_rate(rate):
    mix = SERVE["mix"]
    long = requests.schedule(7, 200, mix, 92544)
    short = requests.schedule(7, 50, dict(mix, rate_per_s=rate), 92544)
    for x, y in zip(short, long):
        assert (len(x.prompt), x.max_new_tokens) == (len(y.prompt), y.max_new_tokens)
        assert x.due_s == pytest.approx(y.due_s * mix["rate_per_s"] / rate, rel=1e-12, abs=1e-12)
    gaps = np.diff([x.due_s for x in long]) * mix["rate_per_s"]
    assert 0.7 < gaps.mean() < 1.3 and gaps.std() / gaps.mean() > 0.7       # exponential gaps
    assert requests.enough(145.0) > 145 + 3 * 145 ** 0.5


def test_fleet_traffic_repeats_by_seed():
    cfg = dict(MEGA["fleet"], n_servers=500)
    a = fleet.make(11, ROUTE["mix"], cfg, POOL["tasks"])
    b = fleet.make(11, ROUTE["mix"], cfg, POOL["tasks"])
    assert a.texts == b.texts and len(a.texts) == ROUTE["mix"]["n_windows"]
    assert all(np.array_equal(x, y) for x, y in zip(a.telemetry, b.telemetry))
    assert all(np.array_equal(x, y) for x, y in zip(a.failed, b.failed))
    # consecutive windows are the same traces one step on
    assert np.array_equal(a.telemetry[0][:, 1:], a.telemetry[1][:, :-1])
    assert (np.stack(a.telemetry) >= 1000).any()            # offline stretches occur


# -- counts --------------------------------------------------------------------

def test_counts_equal_hand_worked_formulas():
    dm = {"d": 8, "H": 2, "Hkv": 1, "hd": 4, "L": 3, "ff": 16, "vocab": 10}
    per_layer = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 3 * 8 * 16          # q, k, v, o, SwiGLU
    assert counts.matmul_params(dm) == 3 * per_layer == 1728
    assert counts.causal_attn_flops(dm, 5) == 2 * 25 * 2 * 4 * 3 == 1200
    assert counts.train_step_flops(dm, 2, 5) == 3 * (2 * 10 * (1728 + 80) + 2 * 1200)
    assert counts.prefill_flops(dm, 5) == 2 * 5 * 1728 + 1200 + 2 * 80
    assert counts.decode_flops(dm, 7) == 2 * (1728 + 80) + 4 * 7 * 2 * 4 * 3
    assert counts.decode_attn_bytes(dm, 7) == (2 * 7 * 1 * 4 * 2 + 2 * 2 * 4 * 2) * 3
    assert counts.flash_prefill_bytes(dm, 5) == 5 * (2 * 2 + 2 * 1) * 4 * 2 * 3


def test_training_count_of_internlm2():
    dm = ref_lm.dims(json.loads((ROOT / "perfbench/configs/internlm2-1.8b.json").read_text()))
    assert counts.matmul_params(dm) == 1_509_949_440
    assert abs(counts.train_step_flops(dm, 4, 2048) / 1e12 - 88.48) < 0.01


# -- references against the port ----------------------------------------------

def test_references_import_nothing_of_the_program():
    for path in (ROOT / "perfbench/reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"repro_torch", "repro", "jax", "perfbench"}, (path, names)


def _program(cfg, attn_impl):
    from perfbench.drivers.train import program_config, program_tree
    from repro_torch.models.api import get_model

    model = get_model(program_config(cfg, {"program": {"attn_impl": attn_impl}}))
    return model, program_tree


def test_lm_reference_loss_and_grads_match_the_port():
    cfg, dm = tiny_dims()
    model, program_tree = _program(cfg, "chunked")
    P = ref_lm.make_params(dm, 3, "cpu", torch.float32)
    params = program_tree(model, P)
    b = tokens.batch(3, 0, 2, 24, dm["vocab"], 1.1)
    leaves = list(P.values())
    for t in leaves:
        t.requires_grad_(True)
    lp, _ = model.loss(params, b)
    gp = torch.autograd.grad(lp, leaves)
    lr = ref_lm.loss(P, b["tokens"], b["labels"], dm, ref_lm.identity)
    gr = torch.autograd.grad(lr, leaves)
    assert abs(lp.item() - lr.item()) < 1e-5
    for a, r in zip(gp, gr):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-6)


def test_lm_reference_serve_matches_the_engine_at_uneven_lengths():
    """Three requests of different lengths share the engine's steps, so the
    shorter decode at the longest's row; the reference fed at the recorded
    rows gives the engine's logits, and fed at its own rows does not."""
    from perfbench.drivers import serve as drv
    from repro_torch.serving.engine import Request, ServeEngine

    cfg, dm = tiny_dims()
    model, program_tree = _program(cfg, "pallas")
    P = ref_lm.make_params(dm, 4, "cpu", torch.float32)
    engine = ServeEngine(model, program_tree(model, P), n_slots=3, cap=96, device="cpu")
    rng = np.random.default_rng(0)
    reqs = {i: Request(rid=i, tokens=rng.integers(0, dm["vocab"], n), max_new_tokens=6)
            for i, n in enumerate((9, 30, 17))}
    for r in reqs.values():
        engine.submit(r)
    log, live = drv.Log(), dict(reqs)
    while engine.pending:
        drv._step(engine, live, log, float("inf"))
    for rid, r in reqs.items():
        gen = [int(x) for x in r.generated]
        prompt = torch.as_tensor(r.tokens)
        lg = ref_lm.serve(P, dm, prompt, gen[:-1], log.positions[rid], 96)
        assert drv.gaps(lg, gen).max() == 0.0
        own = list(range(len(r.tokens), len(r.tokens) + len(gen) - 1))
        if own != log.positions[rid]:
            lg_own = ref_lm.serve(P, dm, prompt, gen[:-1], own, 96)
            assert not torch.allclose(lg_own[1:], lg[1:], atol=1e-4)


def test_routing_reference_matches_the_scalar_router_of_the_port():
    """Per query, the reference's pick equals the port's scalar SONAR-FT
    `Router.select` over the densified fleet."""
    from repro_torch.core.dataset import Server, Tool
    from repro_torch.core.qos import QosParams
    from repro_torch.core.routing import RoutingConfig, SonarFTRouter

    rc = MEGA["routing"]
    n = 45
    tpls = [Server(s["name"], s["domain"], s["description"],
                   [Tool(t["name"], t["description"]) for t in s["tools"]])
            for s in POOL["templates"]]
    servers = [tpls[i % len(tpls)] for i in range(n)]
    tr = fleet.make(5, ROUTE["mix"], dict(MEGA["fleet"], n_servers=n), POOL["tasks"])
    router = SonarFTRouter(servers, RoutingConfig(
        top_s=rc["top_s"], top_k=rc["top_k"], alpha=rc["alpha"], beta=rc["beta"],
        gamma=rc["gamma"], load_knee=rc["load_knee"], load_sharp=rc["load_sharp"],
        stale_half_life_s=rc["stale_half_life_s"], expertise_temp=rc["expertise_temp"],
        qos=QosParams(**rc["qos"])))
    ref_fleet = ref_routing.Fleet(POOL, n, torch.float32, torch.device("cpu"))
    w = 3
    hist = tr.telemetry[w][tr.tel_map]
    server, tool, C, N, S, _ = ref_routing.route(ref_fleet, tr.texts[w][:40], tr.telemetry[w],
                                              tr.tel_map, tr.load[w], tr.age_s[w],
                                              tr.failed[w], rc)
    for i, q in enumerate(tr.texts[w][:40]):
        d = router.select(q, hist, tr.load[w], telemetry_age_s=tr.age_s[w],
                          failed_mask=tr.failed[w])
        assert (d.server_idx, d.tool_idx) == (server[i], tool[i])
        assert abs(d.fused - S[i]) < 1e-5 and abs(d.network - N[i]) < 1e-5


def test_network_score_reference_matches_the_port():
    from repro_torch.core.qos import QosParams, network_score

    tr = fleet.make(9, ROUTE["mix"], dict(MEGA["fleet"], n_servers=10), POOL["tasks"])
    lat = np.concatenate(tr.telemetry[:8])
    got = ref_routing.network_score(torch.as_tensor(lat), MEGA["routing"]["qos"]).numpy()
    want = network_score(torch.as_tensor(lat), QosParams(**MEGA["routing"]["qos"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bm25_reference_weights_match_the_tiled_index(dtype):
    from repro_torch.core.dataset import Server, Tool
    from repro_torch.core.mesh_routing import TiledFleetIndex

    tpls = [Server(s["name"], s["domain"], s["description"],
                   [Tool(t["name"], t["description"]) for t in s["tools"]])
            for s in POOL["templates"]]
    n = 1_000_003
    index = TiledFleetIndex(tpls, np.arange(n) % len(tpls), weights_dtype=dtype)
    ref = ref_routing.Fleet(POOL, n, getattr(torch, dtype), torch.device("cpu"))
    for corpus, vocab, w in ((index.server_corpus, ref.vs, ref.ws),
                             (index.tool_corpus, ref.vt, ref.wt)):
        order = [vocab[t] for t in corpus.vocab]
        if dtype == "bfloat16":       # rounded once: equal
            np.testing.assert_array_equal(w.numpy()[:, order], corpus.weights)
        else:                         # f64 against f32 statistics: an ulp apart
            np.testing.assert_allclose(w.numpy()[:, order], corpus.weights, rtol=1e-6)
