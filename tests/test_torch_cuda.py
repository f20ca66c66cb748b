"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA card.  This file imports neither
JAX nor the reference, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

BM25, the fused stage 2 and the fused selection sum in the same order as
their plain versions and must agree bit for bit at softmax temperature 1
(the engines' default).  At another temperature PyTorch divides by the Python scalar as
a multiply by its reciprocal while the kernel divides, so C and S agree
within rtol 2e-6 / atol 2e-7 there; QoS sums in another order and agrees
within the same tolerance.  Decisions are always exact.  A CUDA tensor
must never reach a plain version.

The attention kernels (flash prefill, flash decode) keep the softmax state
and P in f32 like their plain versions (`mha_ref`, `decode_ref`) but sum in
another order (the bf16 flash body on the tensor cores, with P carried as
two bf16 terms): they agree within rtol = atol = 2e-5 in float32 and 2e-2
in bfloat16 (outputs rounded to bf16), the tolerances of
`tests/test_kernels.py`.  Both merge their partial sums in a fixed order,
so two calls give the same bits.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import bm25, dataset, qos
from repro_torch.core.batch_routing import make_engine
from repro_torch.core.mesh_routing import make_sharded_engine
from repro_torch.core.routing import RoutingConfig, ToolIndex
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_splits
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels import ref as kref
from repro_torch.kernels import qos_score, score_fuse
from repro_torch.traffic import mega_fleet_index

RTOL, ATOL = 2e-6, 2e-7
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fleet(rng, dev, n_q, V, n_srv, n_t, top_s):
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    q = t(rng.poisson(0.4, (n_q, V)).astype(np.float32))
    qr = t(rng.poisson(0.4, (n_q, V)).astype(np.float32))
    w = t((rng.random((n_t, V)) * (rng.random((n_t, V)) < 0.2)).astype(np.float32))
    ts = t(np.sort(rng.integers(0, n_srv, n_t)).astype(np.int32))
    cand = t(np.stack([rng.choice(n_srv, top_s, replace=False) for _ in range(n_q)])
             .astype(np.int32))
    return q, qr, w, ts, cand


@pytest.mark.parametrize("n_q,n_d,V", [(1, 1, 1), (5, 70, 33), (130, 65, 17), (64, 300, 520)])
def test_bm25_kernel_bit_equal_to_plain(cuda, n_q, n_d, V):
    rng = np.random.default_rng(V)
    q = torch.from_numpy(rng.poisson(0.4, (n_q, V)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.random((n_d, V)).astype(np.float32)).to(cuda)
    w[n_d // 2:] = w[0].clone()
    got = ops.bm25_scores(q, w.t())
    assert torch.equal(got, bm25.bm25_scores(w, q))
    assert torch.equal(got[:, n_d // 2:], got[:, :1].expand(-1, n_d - n_d // 2))


def _queries(rng, n_q, V, density):
    """Term counts [n_q, V]: all-zero rows (0), one term per row ("one"),
    a share of the columns, or every column (1.0)."""
    if density == "one":
        q = np.zeros((n_q, V), np.float32)
        q[np.arange(n_q), rng.integers(0, V, n_q)] = rng.integers(1, 4, n_q)
        return q
    return ((rng.random((n_q, V)) < density) * rng.integers(1, 4, (n_q, V))).astype(np.float32)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [1, 17, 123, 793, 1500])
@pytest.mark.parametrize("density", [0.0, "one", 0.02, 1.0])
def test_bm25_sparse_query_kernel_bit_equal(cuda, density, V, wdtype):
    """The sparse-query product against the plain ordered sum over all of
    V: bit-equal at every query density and width, with bf16 weights read
    as they are in the engines' transposed layout, and replica rows tied
    bit for bit."""
    rng = np.random.default_rng(V + (7 if density == "one" else int(100 * density)))
    n_q, n_d = 37, 1100
    q = torch.from_numpy(_queries(rng, n_q, V, density)).to(cuda)
    w = torch.from_numpy((rng.random((n_d, V)) * 4 * (rng.random((n_d, V)) < 0.3))
                         .astype(np.float32)).to(cuda).to(wdtype)
    w[700:] = w[3].clone()
    want = bm25.bm25_scores(w, q)
    got = ops.bm25_scores(q, w.t().contiguous())
    assert torch.equal(got, want)
    assert torch.equal(got[:, 700:], got[:, 3:4].expand(-1, n_d - 700))


def _csr_fleet(rng, case):
    """Stage-2 operands for the candidate walk, by case."""
    n_q, V, n_srv, n_t, top_s, k = 37, 96, 300, 1041, 6, 8
    if case == "top_s_128":
        top_s = 128
    if case == "k_128":                            # a pool of ~220 tools over two rounds
        top_s, k = 64, 128
    if case == "wide_vocab":
        V = 1100
    q = rng.poisson(0.4, (n_q, V)).astype(np.float32)
    qr = rng.poisson(0.4, (n_q, V)).astype(np.float32)
    q[0] = 0.0                                     # a query with no term
    ts = np.sort(rng.integers(0, n_srv - 50 * (case == "no_tool_servers"), n_t))
    if case == "big_server":                       # 400 tools on server 5: > one round of 128
        ts = np.sort(np.concatenate([rng.integers(0, n_srv, n_t - 400), np.full(400, 5)]))
    hosting = np.unique(ts)
    empty = np.setdiff1d(np.arange(n_srv), hosting)
    cand = np.stack([rng.choice(n_srv, top_s, replace=False) for _ in range(n_q)])
    if case == "big_server":
        cand[:, 0] = 5
    if case == "no_tool_servers":                  # some candidates host nothing; row 1 only those
        cand[:, 1] = empty[rng.integers(0, len(empty), n_q)]
        cand[1] = rng.choice(empty, top_s, replace=False)
    if case == "repeated_candidates":              # a candidate twice in a row is walked once
        cand[:, 2] = cand[:, 0]
    if case == "unsorted":
        ts = rng.permutation(ts)
    if case == "dense_queries":
        q = rng.integers(1, 4, (n_q, V)).astype(np.float32)
        qr = rng.integers(1, 4, (n_q, V)).astype(np.float32)
    w = (rng.random((n_t, V)) * (rng.random((n_t, V)) < 0.2)).astype(np.float32)
    w[ts == ts[0]] = w[0]                          # replica tools of one server tie exactly
    return q, qr, w, ts.astype(np.int32), cand.astype(np.int32), n_srv, k


@pytest.mark.parametrize("csr", [True, False])
@pytest.mark.parametrize("case", ["sorted", "unsorted", "big_server", "top_s_128", "k_128",
                                  "no_tool_servers", "dense_queries", "wide_vocab", "bf16",
                                  "repeated_candidates"])
def test_fused_candidate_walk_bit_equal(cuda, case, csr):
    """The CSR walk of the candidates' tools against the plain masked
    product and top-k, bit for bit, with the engine's server -> tools map
    (``csr``) or the one `ops.fused_score_select` builds without it, rerank
    and live weights on."""
    rng = np.random.default_rng(len(case) + 10 * csr)
    q, qr, w, ts, cand, n_srv, k = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                                    if isinstance(x, np.ndarray) else x
                                    for x in _csr_fleet(rng, case))
    if case == "bf16":
        q, qr, w = q.bfloat16(), qr.bfloat16(), w.bfloat16()
    n_t = w.shape[0]
    live = torch.tensor([0.45, 0.55, 0.3, 0.2], device=cuda)
    rows = dict(tool_rtt=torch.rand(n_t, device=cuda), tool_aff=torch.rand(n_t, device=cuda))
    qos_row, load = torch.rand(n_t, device=cuda) * 2 - 1, torch.rand(n_t, device=cuda)
    dead = (torch.rand(n_t, device=cuda) < 0.2).float()
    kw = dict(k=k, alpha=live[0], beta=live[1], gamma=live[2], delta=live[3], eps=0.25, **rows)
    extra = dict(tool_csr=score_fuse.tool_csr(ts, n_srv)) if csr else {}
    for rr in (None, qr):
        got = ops.fused_score_select(q, w, ts, cand.long(), qos_row, load, dead, rr, **kw,
                                     **extra)
        want = kref.fused_score_select_ref(q, w, ts, cand, qos_row, load, dead, rr, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (case, rr is None)
    if case == "no_tool_servers":
        assert int(got[0][1]) == 0 and float(got[3][1]) == float(torch.tensor(kref.NEG))


@pytest.mark.parametrize("D", [8, 24, 40, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_pad_head_dims(cuda, dtype, D):
    """Head dims between the compiled widths run zero-padded to the next
    one, against the unpadded plain versions (scale 1/sqrt(D))."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((2, 4, 130, D), (2, 2, 130, D), (2, 2, 130, D)))
    tol = ATTN_TOL[dtype]
    got = ops.flash_attention(q, k, v)
    assert got.shape == q.shape
    torch.testing.assert_close(got, kref.mha_ref(q, k, v, sm_scale=1 / math.sqrt(D), causal=True),
                               **tol)
    lengths = torch.tensor([1, 130], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q[:, :, 0].contiguous(), k, v, lengths)
    want = kref.decode_ref(q[:, :, 0].reshape(2, 2, 2, D), k, v, lengths.reshape(2, 1),
                           sm_scale=1 / math.sqrt(D)).reshape(2, 4, D)
    torch.testing.assert_close(got, want, **tol)


def test_reduced_qwen2_serves_on_the_kernel_path(cuda):
    """The reduced qwen2-7b (head_dim 8) served on the card with
    attn_impl="pallas": the attention kernels run at head_dim 8 padded to
    16, every request finishes, and the tokens equal the plain path's."""
    from repro_torch import configs
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_reduced("qwen2-7b"), dtype="float32",
                              attn_impl="pallas")
    assert cfg.resolved_head_dim == 8
    params = get_model(cfg).init_params(seed=0, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (11, 4, 9, 6)]
    served = {}
    for impl in ("pallas", "naive"):
        eng = ServeEngine(get_model(dataclasses.replace(cfg, attn_impl=impl)), params,
                          n_slots=2, cap=32, device=cuda)
        reqs = [Request(rid=i, tokens=t, max_new_tokens=5) for i, t in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launches()
        steps = eng.drain()
        launches = ops.launch_counts()
        assert all(r.done and len(r.generated) == 5 for r in reqs)
        served[impl] = [r.generated for r in reqs]
        if impl == "pallas":
            assert launches["flash_attention"] == cfg.n_layers * len(prompts)
            assert launches["decode_attention"] == cfg.n_layers * steps > 0
        else:
            assert launches["flash_attention"] == launches["decode_attention"] == 0
    assert served["pallas"] == served["naive"]


def _qos_window(n, T, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(5.0, 400.0, (n, T)).astype(np.float32)
    lat[::5, -1] = 1200.0
    lat[1::4, -min(T, 3):] = 900.0
    lat[2::7, :] = 1000.0                      # the offline clamp's edge, equal samples
    return lat


@pytest.mark.parametrize("T", [1, 3, 20, 63, 64, 65, 200, 256, 257, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qos_kernel_matches_plain(cuda, T, dtype):
    """Scalar and 16-byte loads, rows kept in registers (T <= 256) or
    streamed, the weight table and the per-sample weights (T > 1024); 333
    rows, not a multiple of any plan's rows per block."""
    x = torch.from_numpy(_qos_window(333, T, T)).to(cuda).to(dtype)
    torch.testing.assert_close(ops.qos_scores(x), qos.network_score(x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [3, 64, 256, 257, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qos_kernel_offset_views(cuda, T, dtype):
    """A contiguous view that starts one element into its storage (not 16-byte
    aligned) takes scalar loads and agrees with the plain version, as does
    the flattened per-query window of the engines."""
    n = 131
    lat = torch.from_numpy(_qos_window(n, T, T + 1)).to(cuda).to(dtype)
    buf = torch.empty(n * T + 1, dtype=dtype, device=cuda)
    view = buf[1:].view(n, T)
    view.copy_(lat)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert qos_score.launch_plan(T, dtype, view.data_ptr(), n).vec == 1
    torch.testing.assert_close(ops.qos_scores(view), qos.network_score(lat), rtol=RTOL,
                               atol=ATOL)
    perq = torch.stack([lat, lat.flip(0)]).reshape(2 * n, T)
    torch.testing.assert_close(ops.qos_scores(perq), qos.network_score(perq), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("variant", ["broadcast", "per_query", "bf16", "rerank_live_aff",
                                     "all_dead", "k_large", "temp"])
def test_fused_kernel_matches_plain(cuda, variant):
    rng = np.random.default_rng(len(variant))
    q, qr, w, ts, cand = _fleet(rng, cuda, 37, 96, 300, 2 * 512 + 17, 6)
    n_q, n_t = q.shape[0], w.shape[0]
    shape = (n_q, n_t) if variant == "per_query" else (n_t,)
    qos_row = torch.rand(shape, device=cuda) * 2 - 1
    load = torch.rand(shape, device=cuda) * 2
    rtt = torch.rand(shape, device=cuda)
    dead = (torch.rand(shape, device=cuda) < (1.1 if variant == "all_dead" else 0.2)).float()
    kw = dict(k=40 if variant == "k_large" else 8, alpha=0.6, beta=0.3, gamma=0.2, delta=0.1,
              temp=0.7 if variant == "temp" else 1.0, tool_rtt=rtt)
    qq, ww, rr = q, w, None
    if variant == "bf16":
        qq, ww = q.bfloat16(), w.bfloat16()
    if variant == "rerank_live_aff":
        live = torch.tensor([0.45, 0.55, 0.3, 0.2], device=cuda)
        kw.update(alpha=live[0], beta=live[1], gamma=live[2], delta=live[3],
                  tool_aff=torch.rand(shape, device=cuda), eps=0.25)
        rr = qr
    got = ops.fused_score_select(qq, ww, ts, cand, qos_row, load, dead, rr, **kw)
    want = kref.fused_score_select_ref(qq, ww, ts, cand, qos_row, load, dead, rr, **kw)
    assert torch.equal(got[0], want[0]), variant
    for a, b in zip(got[1:], want[1:]):
        if variant == "temp":
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(a, b), variant


def test_ops_never_take_the_plain_path_on_cuda(cuda, monkeypatch):
    rng = np.random.default_rng(1)
    q, qr, w, ts, cand = _fleet(rng, cuda, 20, 64, 200, 700, 5)
    lat = torch.rand((200, 30), device=cuda) * 300

    def plain_called(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(ops, "_bm25_plain", plain_called)
    monkeypatch.setattr(ops, "network_score", plain_called)
    monkeypatch.setattr(kref, "fused_score_select_ref", plain_called)
    monkeypatch.setattr(kref, "fused_select_ref", plain_called)
    ops.reset_launches()
    ops.bm25_scores(q, w.t())
    ops.qos_scores(lat)
    ops.fused_score_select(q, w, ts, cand, torch.zeros(700, device=cuda), q_rerank=qr,
                           k=5, alpha=1.0, beta=0.0)
    sel = torch.rand((20, 700), device=cuda)
    ops.fused_select(sel, sel, torch.zeros(700, device=cuda), k=5, alpha=1.0, beta=0.0)
    torch.cuda.synchronize()
    q = torch.randn((1, 4, 70, 64), device=cuda)
    kv = torch.randn((1, 2, 70, 64), device=cuda)
    monkeypatch.setattr(kref, "mha_ref", plain_called)
    monkeypatch.setattr(kref, "decode_ref", plain_called)
    ops.flash_attention(q, kv, kv)
    ops.decode_attention(q[:, :, 0].contiguous(), kv, kv, torch.full((1,), 70, device=cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"bm25_scores": 1, "qos_scores": 1, "fused_score_select": 1,
                                   "fused_select": 1, "flash_attention": 1,
                                   "decode_attention": 1}
    # a head dim between the compiled widths is zero-padded (40 -> 64); one
    # above the widest is refused
    assert ops.flash_attention(q[..., :40], kv[..., :40], kv[..., :40]).shape == (1, 4, 70, 40)
    assert ops.launch_counts()["flash_attention"] == 2
    wide = torch.randn((1, 4, 70, 160), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(wide, wide[:, :2], wide[:, :2])
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.bfloat16(), kv, kv)
    with pytest.raises(ValueError, match="k="):
        ops.fused_select(sel, sel, torch.zeros(700, device=cuda), k=129, alpha=1.0, beta=0.0)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.bm25_scores(q, w.cpu())


def test_engine_kernel_path_equals_plain_path(cuda):
    servers = dataset.mock_cluster(dataset.build_server_pool(0), n_per_template=20)
    index = ToolIndex(servers)
    cfg = RoutingConfig(top_s=8, top_k=8)
    texts = [q.text for q in dataset.build_query_dataset(n=40, seed=1)]
    rng = np.random.default_rng(2)
    n = len(servers)
    lat = rng.uniform(20, 300, (n, 48)).astype(np.float32)
    lat[::9, -1] = 1200.0
    ops_kw = dict(server_load=rng.random(n).astype(np.float32),
                  telemetry_age_s=(rng.random(n) * 600).astype(np.float32),
                  failed_mask=rng.random(n) < 0.1,
                  client_rtt_ms=(rng.random(n) * 300).astype(np.float32),
                  affinity=rng.random(n).astype(np.float32))
    for algo in ("rag", "rerank_rag", "sonar", "sonar_ft", "sonar_session"):
        a = make_engine(algo, servers, cfg, index=index).route_texts(texts, lat, **ops_kw)
        b = make_engine(algo, servers, cfg, index=index, device="cuda",
                        use_kernels=False).route_texts(texts, lat, **ops_kw)
        np.testing.assert_array_equal(a.tool_idx, b.tool_idx, err_msg=algo)
        np.testing.assert_array_equal(a.server_idx, b.server_idx, err_msg=algo)
        for x, y in ((a.expertise, b.expertise), (a.network, b.network), (a.fused, b.fused)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=algo)


@pytest.mark.parametrize("variant", ["broadcast", "per_query", "bf16", "live_aff", "all_invalid",
                                     "all_dead", "k128", "wide", "temp", "one_tool", "narrow"])
def test_select_kernel_matches_plain(cuda, variant):
    """fused_select against its plain version at widths from 1 to 60,000,
    with -inf entries and ties."""
    n_q, n_t = {"wide": (9, 60_000), "one_tool": (5, 1), "narrow": (256, 16),
                "k128": (33, 20_010)}.get(variant, (37, 300))
    g = torch.Generator(device=cuda).manual_seed(len(variant))
    sel = torch.randint(0, 6, (n_q, n_t), generator=g, device=cuda).float()
    sel = torch.where(torch.rand((n_q, n_t), generator=g, device=cuda) < 0.3, -float("inf"), sel)
    if variant == "all_invalid":
        sel.fill_(-float("inf"))
    val = torch.rand((n_q, n_t), generator=g, device=cuda) * 4
    shape = (n_q, n_t) if variant in ("per_query", "live_aff") else (n_t,)

    def row():
        return torch.rand(shape, generator=g, device=cuda)

    dead = (row() < (1.1 if variant == "all_dead" else 0.2)).float()
    kw = dict(k={"k128": 128, "one_tool": 1, "narrow": 16}.get(variant, 12), alpha=0.6,
              beta=0.3, gamma=0.2, delta=0.1, tool_rtt=row(),
              temp=0.7 if variant == "temp" else 1.0)
    if variant == "live_aff":
        live = torch.tensor([0.45, 0.55, 0.3, 0.2], device=cuda)
        kw.update(alpha=live[0], beta=live[1], gamma=live[2], delta=live[3], tool_aff=row(),
                  eps=0.25)
    s, v = (sel.bfloat16(), val.bfloat16()) if variant == "bf16" else (sel, val)
    args = (s, v, row() * 2 - 1, row(), dead)
    got = ops.fused_select(*args, **kw)
    want = kref.fused_select_ref(*args, **kw)
    assert torch.equal(got[0], want[0]), variant
    for a, b in zip(got[1:], want[1:]):
        if variant == "temp":
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(a, b), variant


@pytest.mark.parametrize("T", [4, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qos_ring_mode_matches_plain(cuda, T, dtype):
    """Windows of RING_MIN_ROWS rows or more take the cp.async ring (the
    per-query step's path): a last tile of 17 rows, one lane per row at
    T = 4, the plain version's scores within the tolerance."""
    n = qos_score.RING_MIN_ROWS + 32 * 5 + 17
    x = torch.from_numpy(_qos_window(n, T, T + 2)).to(cuda).to(dtype)
    if dtype == torch.bfloat16 and T == 4:
        x = torch.cat([x, x], dim=1)                  # bf16 rows of 16 bytes
    assert qos_score.launch_plan(x.shape[1], dtype, x.data_ptr(), n).mode == "ring"
    torch.testing.assert_close(ops.qos_scores(x), qos.network_score(x), rtol=RTOL, atol=ATOL)


def _edge_select_rows(g, n_q, n_t, dev):
    """Tie-heavy integer scores with -inf entries, and edge rows: -0/+0 ties
    above negatives, an all-equal row, an all -inf row, an all-NEG row, a
    row of -0/+0 only, and three sparse rows."""
    sel = torch.randint(0, 6, (n_q, n_t), generator=g, device=dev).float()
    sel = torch.where(torch.rand((n_q, n_t), generator=g, device=dev) < 0.3, -float("inf"), sel)
    signs = torch.rand((n_t,), generator=g, device=dev) < 0.5
    zeros = torch.where(signs, torch.tensor(-0.0, device=dev), torch.tensor(0.0, device=dev))
    sel[0] = torch.where(torch.arange(n_t, device=dev) % 3 == 0, zeros, sel[0].clamp_max(-1.0))
    sel[1] = 2.5
    sel[2] = -float("inf")
    sel[3] = kref.NEG
    sel[4] = zeros
    # sparse rows, as on the full tool axis: 20, 200 and 300 scored entries
    # (fewer than k, at most 256 collected, more: the wide kernel's three ways)
    for row, n_valid in ((5, 20), (6, 200), (7, 300)):
        keep = torch.randperm(n_t, generator=g, device=dev)[:n_valid]
        sparse = torch.full((n_t,), -float("inf"), device=dev)
        sparse[keep] = sel[row, keep].clamp_min(0.0)
        sel[row] = sparse
    return sel


@pytest.mark.parametrize("n_t,k", [(n, k) for n in (1, 16, 31, 32, 33, 255, 256, 257, 20010,
                                                       60000)
                                     for k in (1, 16, 128) if k <= n])
def test_select_kernel_widths_and_edge_rows(cuda, n_t, k):
    """Both regimes (a warp per narrow row up to 256, a block per wide row;
    staged in shared memory up to 54,016 entries) and their boundaries,
    against the plain version, bit for bit at temperature 1, on the edge
    rows; also with bf16 values and per-query rows."""
    n_q = 37
    g = torch.Generator(device=cuda).manual_seed(n_t + k)
    sel = _edge_select_rows(g, n_q, n_t, cuda)
    val = torch.rand((n_q, n_t), generator=g, device=cuda) * 4
    val[1] = 1.0
    dead = (torch.rand((n_q, n_t), generator=g, device=cuda) < 0.2).float()
    kw = dict(k=k, alpha=0.6, beta=0.3, gamma=0.2, delta=0.1,
              tool_rtt=torch.rand((n_t,), generator=g, device=cuda))
    for args in ((sel, sel, torch.rand((n_t,), generator=g, device=cuda) * 2 - 1),
                 (sel, val.bfloat16(), torch.rand((n_q, n_t), generator=g, device=cuda),
                  torch.rand((n_t,), generator=g, device=cuda), dead)):
        got = ops.fused_select(*args, **kw)
        want = kref.fused_select_ref(*args, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (n_t, k)


def test_sharded_kernel_path_equals_plain_path(cuda):
    """The shard-stacked engine over a tiled fleet: every algorithm's
    kernel-path decision equals the plain path's, with one fused_select
    launch per route."""
    n = 20_000
    index = mega_fleet_index(n, weights_dtype="bfloat16")
    texts = [q.text for q in dataset.build_query_dataset(n=64, seed=1)]
    rng = np.random.default_rng(3)
    compact = rng.uniform(20, 300, (16, 32)).astype(np.float32)
    compact[::5, -1] = 1200.0
    kw = dict(server_load=rng.random(n).astype(np.float32),
              telemetry_age_s=(rng.random(n) * 400).astype(np.float32),
              failed_mask=rng.random(n) < 0.05,
              client_region=rng.integers(-1, 6, len(texts)).astype(np.int32),
              region_rtt_ms=(rng.random((6, n)) * 300).astype(np.float32),
              affinity=rng.random(n).astype(np.float32),
              telemetry_templates=(compact, (np.arange(n) * 2654435761) % 16))
    cfg = RoutingConfig(top_s=8, top_k=16)
    for algo in ("rerank_rag", "sonar", "sonar_ft", "sonar_session", "sonar_adapt"):
        ek = make_sharded_engine(algo, cfg=cfg, n_shards=4, index=index)
        ops.reset_launches()
        a = ek.route_texts(texts, **kw)
        assert ops.launch_counts()["fused_select"] == 1, algo
        b = make_sharded_engine(algo, cfg=cfg, n_shards=4, index=index,
                                use_kernels=False).route_texts(texts, **kw)
        np.testing.assert_array_equal(a.tool_idx, b.tool_idx, err_msg=algo)
        np.testing.assert_array_equal(a.server_idx, b.server_idx, err_msg=algo)
        for x, y in ((a.expertise, b.expertise), (a.network, b.network), (a.fused, b.fused)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=algo)


ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G,S", [(1, 1), (2, 130), (4, 2048), (8, 130), (1, 2048), (5, 1000)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype, D, G, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S + D + G)
    B, Hkv = (1, 2) if S > 1000 else (2, 2)
    q = _randn(g, (B, Hkv * G, S, D), dtype, cuda)
    k = _randn(g, (B, Hkv, S, D), dtype, cuda)
    v = _randn(g, (B, Hkv, S, D), dtype, cuda)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = kref.mha_ref(q, k, v, sm_scale=1 / math.sqrt(D), causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_model_layout_and_offsets(cuda, dtype):
    """Transposed views of [B, S, H, D] go in without copies and come out in
    q's layout; Sq != Sk takes the tril offset of `mha_ref`."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(g, (2, 300, 8, 64), dtype, cuda)
    k = _randn(g, (2, 300, 2, 64), dtype, cuda)
    v = _randn(g, (2, 300, 2, 64), dtype, cuda)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.stride() == q.transpose(1, 2).stride()
    want = kref.mha_ref(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), sm_scale=0.125)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    qs = q.transpose(1, 2)[:, :, 100:]                         # Sq 200 against Sk 300
    got = ops.flash_attention(qs, k.transpose(1, 2), v.transpose(1, 2))
    want = kref.mha_ref(qs.contiguous(), k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), sm_scale=0.125)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("S", [130, 2048])
@pytest.mark.parametrize("G", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, dtype, D, G, S):
    """Per-sequence lengths from 1 to S_cap; the cache in the op layout
    [B, Hkv, S, D] and in the model's [B, S, Hkv, D] (strided view)."""
    g = torch.Generator(device=cuda).manual_seed(S + D + G)
    B, Hkv = 5, 2
    q = _randn(g, (B, Hkv * G, D), dtype, cuda)
    k = _randn(g, (B, Hkv, S, D), dtype, cuda)
    v = _randn(g, (B, Hkv, S, D), dtype, cuda)
    lengths = torch.tensor([1, S, 63, 64, 65], dtype=torch.int32, device=cuda).clamp(max=S)
    want = kref.decode_ref(q.reshape(B, Hkv, G, D), k, v, lengths.reshape(B, 1),
                           sm_scale=1 / math.sqrt(D)).reshape(B, Hkv * G, D)
    got = ops.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    got_c = ops.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), lengths)
    assert torch.equal(got_c, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_kernel_path_matches_plain_path(cuda, dtype):
    """A narrow 3-layer GQA decoder on the card: prefill and decode under
    attn_impl="pallas" (the kernels, one launch per layer per call) against
    the plain "naive" path on the same weights."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000, dtype=dtype, attn_impl="pallas")
    plain = dataclasses.replace(cfg, attn_impl="naive")
    params = get_model(cfg).init_params(seed=1, device=cuda)
    toks = torch.randint(0, 1000, (2, 150), generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    tol = ATTN_TOL[getattr(torch, dtype)]
    ops.reset_launches()
    lk, ck = get_model(cfg).prefill(params, {"tokens": toks})
    lp, cp = get_model(plain).prefill(params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == 3
    torch.testing.assert_close(lk, lp, rtol=tol["rtol"], atol=tol["atol"] * float(lp.abs().max()))
    from repro_torch.serving.engine import pad_cache_to_capacity
    ck = pad_cache_to_capacity(ck, get_model(cfg).cache_axes(), 200)
    cp = pad_cache_to_capacity(cp, get_model(cfg).cache_axes(), 200)
    nt = toks[:, -1:]
    for step in range(3):
        lk, ck = get_model(cfg).decode_step(params, ck, nt, 150 + step)
        lp, cp = get_model(plain).decode_step(params, cp, nt, 150 + step)
        torch.testing.assert_close(lk, lp, rtol=tol["rtol"],
                                   atol=tol["atol"] * float(lp.abs().max()))
    assert ops.launch_counts()["decode_attention"] == 9


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 65, 130, 1000, 2048])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_bf16_tensor_core_body(cuda, D, S, causal):
    """The bf16 body (wgmma, P split in two bf16 terms) at every head width,
    at lengths off its 128-row q and 64-row kv tiles; two calls give the
    same bits."""
    g = torch.Generator(device=cuda).manual_seed(7 * S + D + causal)
    q = _randn(g, (1, 4, S, D), torch.bfloat16, cuda)
    k = _randn(g, (1, 2, S, D), torch.bfloat16, cuda)
    v = _randn(g, (1, 2, S, D), torch.bfloat16, cuda)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = kref.mha_ref(q, k, v, sm_scale=1 / math.sqrt(D), causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


@pytest.mark.parametrize("Sq,Sk", [(1, 130), (65, 1000), (200, 300), (130, 2048)])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_bf16_query_offset(cuda, D, Sq, Sk):
    """Sq < Sk takes the tril offset of `mha_ref` (the last Sq rows of a
    causal square), with the operands as transposed views of [B, S, H, D]."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q = _randn(g, (2, Sq, 4, D), torch.bfloat16, cuda)
    k = _randn(g, (2, Sk, 1, D), torch.bfloat16, cuda)
    v = _randn(g, (2, Sk, 1, D), torch.bfloat16, cuda)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.stride() == q.transpose(1, 2).stride()
    want = kref.mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        sm_scale=1 / math.sqrt(D))
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("S", [100, 1000, 2048])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_split_edges(cuda, dtype, D, S):
    """Lengths 0 and S, a split boundary and its neighbour, and sequences
    whose splits are all empty but the first: against the plain split
    algebra (`decode_split_ref`, which gives 0 for length 0) and
    `decode_ref` (for lengths above 0); two calls give the same bits."""
    B, Hkv, G = 6, 2, 2
    n_split = decode_splits(B * Hkv, S)
    assert (n_split > 1) == (S >= 128)
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = _randn(g, (B, Hkv * G, D), dtype, cuda)
    k = _randn(g, (B, Hkv, S, D), dtype, cuda)
    v = _randn(g, (B, Hkv, S, D), dtype, cuda)
    edge = S // n_split
    lengths = torch.tensor([0, S, edge, edge + 1, 1, max(edge - 5, 1)], dtype=torch.int32,
                           device=cuda)
    got = ops.decode_attention(q, k, v, lengths)
    qg = q.reshape(B, Hkv, G, D)
    want = kref.decode_split_ref(qg, k, v, lengths, sm_scale=1 / math.sqrt(D),
                                 n_split=n_split).reshape(B, Hkv * G, D)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    assert torch.all(got[0] == 0)
    want_ref = kref.decode_ref(qg, k, v, lengths.reshape(B, 1),
                               sm_scale=1 / math.sqrt(D)).reshape(B, Hkv * G, D)
    torch.testing.assert_close(got[1:].float(), want_ref[1:].float(), **ATTN_TOL[dtype])
    assert torch.equal(ops.decode_attention(q, k, v, lengths), got)


# ---------------------------------------------------------------------------
# the paper harness and the gateway on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_telemetry_ring_oldest_first_on_the_card(cuda, dtype):
    """After more than W pushes the ring hands out its window oldest-first,
    equal to the host roll window's (bf16 rounds each sample once)."""
    from repro_torch.serving.gateway import DeviceTelemetry, _HostTelemetry

    rng = np.random.default_rng(2)
    init = rng.uniform(1.0, 1100.0, (300, 16)).astype(np.float32)
    ring, host = DeviceTelemetry(init, dtype=dtype, device=cuda), _HostTelemetry(init, dtype)
    for k in range(40):
        col = rng.uniform(1.0, 1100.0, 300).astype(np.float32)
        ring.push(col)
        host.push(col)
        if k % 7 == 0:
            assert ring.raw().device.type == "cuda" and ring.raw().is_contiguous()
            np.testing.assert_array_equal(ring.host(), host.host())
    np.testing.assert_array_equal(ring.raw().float().cpu().numpy(), host.host())


def _records_key(recs):
    return [(r.success, r.n_calls, r.n_failures, r.call_latencies_ms, r.completion_ms,
             r.final_server_idx, [(d.server_idx, d.tool_idx) for d in r.decisions])
            for r in recs]


@pytest.mark.parametrize("algo", ["prag", "sonar", "sonar_ft"])
def test_batch_agent_kernel_path_equals_plain_path(cuda, algo):
    """BatchAgent episodes on traces drawn on the card: the kernel path
    (BM25, per-query QoS, fused stage 2) gives the plain path's records."""
    from repro_torch.core.agent import BatchAgent
    from repro_torch.core.platform import NetMCPPlatform

    servers = dataset.mock_cluster(dataset.build_server_pool(0), n_per_template=4)
    queries = dataset.build_query_dataset(n=40, seed=3)
    out = []
    for use_kernels in (True, False):
        plat = NetMCPPlatform(servers, scenario="hybrid", seed=2, device=cuda)
        eng = make_engine(algo, servers, device=cuda, use_kernels=use_kernels)
        ops.reset_launches()
        recs = BatchAgent(plat, eng).run_benchmark(queries, ticks_per_query=150)
        launches = ops.launch_counts()
        out.append((recs, plat.observed.copy()))
        if use_kernels:
            assert launches["bm25_scores"] > 0 and launches["fused_score_select"] > 0
            assert (launches["qos_scores"] > 0) == (algo != "prag")
        else:
            assert not any(launches.values())
    (rk, ok), (rp, op) = out
    assert _records_key(rk) == _records_key(rp)
    np.testing.assert_allclose([r.final_expertise for r in rk], [r.final_expertise for r in rp],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ok, op)


@pytest.mark.parametrize("shards", [None, 2])
def test_gateway_kernel_path_equals_plain_path(cuda, shards):
    """Padded and unpadded `route_batch` flushes on the card (the sharded
    engine reaches the fused selection): picks and end state equal to a
    gateway whose engine runs the plain path."""
    from repro_torch.core.batch_routing import BatchRoutingEngine
    from repro_torch.core.latency import outage_profile
    from repro_torch.core.mesh_routing import ShardedRoutingEngine
    from repro_torch.serving.gateway import SonarGateway, replica_pool

    reps = replica_pool([("yi-6b", "dense"), ("whisper-tiny", "audio"), ("deepseek-moe-16b", "moe")]
                        * 10)
    prof = [outage_profile(probability=0.3, duration_min_s=10.0, duration_max_s=30.0)] * 30
    texts = ["search the web for the latest news", "transcribe this recording",
             "generate a chat reply"]
    for algo in ("sonar_lb", "sonar_ft"):
        gws = []
        for use_kernels in (True, False):
            gw = SonarGateway(reps, profiles=prof, algo=algo, seed=4, use_kernels=True,
                              shards=shards, eject_after=2, device=cuda)
            if not use_kernels:
                cls = ShardedRoutingEngine if shards else BatchRoutingEngine
                kw = dict(n_shards=shards) if shards else {}
                gw._engine = cls(reps, gw.router.cfg, algo=algo, index=gw.router.index,
                                 device=cuda, use_kernels=False, **kw)
            ops.reset_launches()
            res = [gw.route_batch([texts[(i + j) % 3] for j in range(3 + i)],
                                  pad_to=16 if i % 2 else None) for i in range(10)]
            launches = ops.launch_counts()
            assert bool(launches["fused_select" if shards else "fused_score_select"]) \
                == use_kernels
            gws.append((gw, res))
        (gk, rk), (gp, rp) = gws
        assert [[(r.replica_idx, r.latency_ms, r.ok) for r in x] for x in rk] == [
            [(r.replica_idx, r.latency_ms, r.ok) for r in x] for x in rp]
        for f in ("in_flight", "fail_streak", "ejected", "telemetry"):
            np.testing.assert_array_equal(getattr(gk, f), getattr(gp, f))
        assert gk.t == gp.t and gk.report() == gp.report()


def test_crash_recurrence_on_the_card_equals_its_cpu_run(cuda):
    """The crash/restart recurrence fed the same draws gives the same mask
    on the card as on the CPU (f32 compares and decrements), at a size with
    repairs below a tick and a start inside the horizon."""
    from repro_torch.chaos import faults

    gen = torch.Generator(device="cpu").manual_seed(11)
    n_steps, rows = 2000, 700
    u = torch.rand((n_steps, rows), generator=gen)
    e = torch.empty((n_steps, rows)).exponential_(generator=gen)
    for f in (faults.CrashRestartFault(servers=tuple(range(rows)), mttf_s=300.0, mttr_s=40.0,
                                       start_s=125.0),
              faults.CrashRestartFault(servers=tuple(range(rows)), mttf_s=30.0, mttr_s=0.4)):
        params = faults.crash_restart_params(f, 1.0)
        host = faults.crash_restart_recurrence(u, e, *params)
        card = faults.crash_restart_recurrence(u.to(cuda), e.to(cuda), *params)
        assert card.device.type == "cuda" and host.any()
        assert torch.equal(card.cpu(), host)
    # the schedule's own stream on the card is deterministic per seed
    f = faults.CrashRestartFault(servers=(0, 1, 2), mttf_s=100.0, mttr_s=20.0)
    a = faults.crash_restart_masks(torch.Generator(device=cuda).manual_seed(3), f, 500, 1.0)
    b = faults.crash_restart_masks(torch.Generator(device=cuda).manual_seed(3), f, 500, 1.0)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ["prag", "sonar_ft"])
def test_chaos_batch_agent_kernel_path_equals_plain_path(cuda, algo):
    """BatchAgent episodes at 300 servers under `standard_fault_mix(1.0)`
    compiled on the card: staleness ages and failed masks reach the kernel
    path, whose records equal the plain path's."""
    from repro_torch.chaos import build_schedule, standard_fault_mix
    from repro_torch.core.agent import BatchAgent
    from repro_torch.core.platform import NetMCPPlatform

    servers = dataset.mock_cluster(dataset.build_server_pool(0), n_per_template=20)
    n = len(servers)
    chaos = build_schedule(standard_fault_mix(1.0, n, 86400.0), n, 8640, 10.0, seed=1,
                           device=cuda)
    queries = dataset.build_query_dataset(n=64, seed=3)
    out = []
    for use_kernels in (True, False):
        plat = NetMCPPlatform(servers, scenario="hybrid", seed=2, chaos=chaos, device=cuda)
        eng = make_engine(algo, servers, device=cuda, use_kernels=use_kernels)
        ops.reset_launches()
        recs = BatchAgent(plat, eng, max_turns=4).run_benchmark(queries, ticks_per_query=130)
        launches = ops.launch_counts()
        out.append((recs, plat.observed.copy()))
        assert bool(launches["bm25_scores"]) == use_kernels
    (rk, ok), (rp, op) = out
    assert _records_key(rk) == _records_key(rp)
    np.testing.assert_array_equal(ok, op)
    assert any(r.n_failures for r in rk)


@pytest.mark.parametrize("n_real", [None, 0, 37, 64])
def test_device_route_stats_on_the_card_without_a_sync(cuda, n_real):
    """`accumulate` and `drain` queue tensor ops on the card and never read
    back (``set_sync_debug_mode("error")`` raises on any sync); the fold
    equals the host tally, the picks exactly."""
    from repro_torch.obs import DeviceRouteStats

    rng = np.random.default_rng(5)
    drs = DeviceRouteStats(1000)
    calls = []
    for _ in range(3):
        idx = rng.integers(0, 1000, 64).astype(np.int32)
        c, n, s = (rng.uniform(-1.0, 1.0, 64).astype(np.float32) for _ in range(3))
        calls.append((idx, c, n, s))
    dev_calls = [tuple(torch.from_numpy(a).to(cuda) for a in x) for x in calls]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in dev_calls:
            drs.accumulate(*x, n_real=n_real)
        drs.drain()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert drs._buf.device.type == "cuda"
    out = drs.fold()
    k = 64 if n_real is None else n_real
    idx = np.concatenate([x[0][:k] for x in calls])
    np.testing.assert_array_equal(out["picks"], np.bincount(idx, minlength=1000))
    assert out["n_routed"] == len(idx)
    for key, j in (("mean_expertise", 1), ("mean_network", 2), ("mean_fused", 3)):
        host = np.concatenate([x[j][:k] for x in calls]).astype(np.float64)
        # f32 sums of up to 192 values in [-1, 1] on the card, in another order
        np.testing.assert_allclose(out[key], host.mean() if k else 0.0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", [None, 2])
def test_gateway_route_stats_fold_equals_host_tally(cuda, shards):
    """`SonarGateway(use_kernels=True, device_telemetry=True,
    obs=Observability(jit_stats=True))`: padded flushes through the routing
    kernels; the device fold equals the gateway's host tally of its picks."""
    from repro_torch.obs import Observability
    from repro_torch.serving.gateway import SonarGateway, replica_pool

    reps = replica_pool([("yi-6b", "dense"), ("whisper-tiny", "audio")] * 15)
    texts = ["search the web for the latest news", "transcribe this recording",
             "generate a chat reply"]
    obs = Observability(jit_stats=True)
    gw = SonarGateway(reps, algo="sonar_lb", seed=2, use_kernels=True, device_telemetry=True,
                      shards=shards, obs=obs, device=cuda)
    ops.reset_launches()
    for i in range(8):
        gw.route_batch([texts[(i + j) % 3] for j in range(2 + i)], pad_to=16 if i % 2 else None)
        obs.drain_route_stats()
    assert ops.launch_counts()["fused_select" if shards else "fused_score_select"] > 0
    out = obs.fold_route_stats()
    picks = np.bincount([r.replica_idx for r in gw.stats], minlength=len(reps))
    np.testing.assert_array_equal(out["picks"], picks)
    assert out["n_routed"] == len(gw.stats) == sum(2 + i for i in range(8))
    np.testing.assert_allclose(out["mean_expertise"],
                               np.mean([r.expertise for r in gw.stats]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE FFN on the card
# ---------------------------------------------------------------------------

def _moe_cfg(dtype, **over):
    """A narrow DeepSeek-like MoE decoder: a dense prelude layer, then MoE
    layers of 16 experts, top-4, 2 shared experts."""
    return ModelConfig(**dict(dict(
        name="tiny-moe", family="moe", n_layers=3, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=1000, n_experts=16, experts_per_token=4, n_shared_experts=2,
        moe_d_ff=128, first_k_dense=1, dense_d_ff=512, dtype=dtype), **over))


def _moe_layer(cfg, dev):
    """One MoE layer's weights drawn on the CPU from a seed, and their copy on ``dev``."""
    from repro_torch.models import mlp
    from repro_torch.nn import core as nn

    p = mlp.moe_ffn_init(nn.InitCtx(gen=torch.Generator().manual_seed(4),
                                    dtype=cfg.torch_dtype), cfg, 1)
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    on = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
          for k, v in p.items()}
    return p, on


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_on_the_card_equals_its_cpu_run(cuda, dtype, monkeypatch):
    """The dispatch (stable sorts, per-row capacity, drops) on the card equals
    its CPU run exactly, and the layer's output agrees within the dtype's
    tolerance.  The router product is a library product whose rounding may
    differ between the devices, so the CPU run is given the card's router
    logits; 3 rows of 200 tokens at capacity factor 0.5 drop entries."""
    from repro_torch.models import mlp
    from repro_torch.nn import core as nn

    cfg = _moe_cfg(dtype, capacity_factor=0.5)
    p, pd = _moe_layer(cfg, cuda)
    x = torch.randn((3, 200, cfg.d_model), generator=torch.Generator().manual_seed(5)) \
        .to(cfg.torch_dtype)
    xd = x.to(cuda)
    C = mlp._capacity(200, cfg.experts_per_token, cfg.n_experts, cfg.capacity_factor)
    card = mlp._moe_dispatch(pd, cfg, xd, C)
    y_card, aux_card = mlp.moe_ffn_apply(pd, cfg, xd)
    logits = nn.dense(xd, pd["router"]).to(torch.float32).cpu()
    monkeypatch.setattr(mlp, "_route",
                        lambda p_, cfg_, x_: mlp._gates(logits, cfg_.experts_per_token))
    host = mlp._moe_dispatch(p, cfg, x, C)
    y_host, aux_host = mlp.moe_ffn_apply(p, cfg, x)
    buf, slot, token_of, w_keep, _ = (t.cpu() for t in card)
    assert torch.equal(slot, host[1]) and torch.equal(token_of, host[2])
    assert not bool((w_keep > 0).all())                          # entries were dropped
    torch.testing.assert_close(w_keep.float(), host[3].float(), **ATTN_TOL[cfg.torch_dtype])
    assert torch.equal(buf, host[0])                             # gathered rows of x
    torch.testing.assert_close(y_card.cpu().float(), y_host.float(), **ATTN_TOL[cfg.torch_dtype])
    torch.testing.assert_close(aux_card.cpu(), aux_host, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_on_the_card_is_deterministic(cuda, dtype):
    """The combine sums each token's contributions in one fixed order through
    gathers (no atomics): two runs on the card give the same bits, decode
    rows (S = 1, 8 slots) and a prefill row alike."""
    from repro_torch.models import mlp

    cfg = _moe_cfg(dtype)
    _, pd = _moe_layer(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    for shape in ((8, 1, cfg.d_model), (1, 700, cfg.d_model)):
        x = torch.randn(shape, generator=g, device=cuda).to(cfg.torch_dtype)
        a, b = mlp.moe_ffn_apply(pd, cfg, x), mlp.moe_ffn_apply(pd, cfg, x)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moe_model_kernel_path_matches_plain_path(cuda):
    """The narrow MoE decoder (dense prelude + 2 MoE layers) in float32 on the
    card: prefill and decode under attn_impl="pallas" (one launch per layer
    per call, the prelude's included) against the plain "naive" path on the
    same weights."""
    from repro_torch.serving.engine import pad_cache_to_capacity

    cfg = _moe_cfg("float32", attn_impl="pallas")
    plain = dataclasses.replace(cfg, attn_impl="naive")
    params = get_model(cfg).init_params(seed=1, device=cuda)
    toks = torch.randint(0, 1000, (2, 150), generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    tol = ATTN_TOL[torch.float32]
    ops.reset_launches()
    lk, ck = get_model(cfg).prefill(params, {"tokens": toks})
    lp, cp = get_model(plain).prefill(params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == 3
    torch.testing.assert_close(lk, lp, rtol=tol["rtol"], atol=tol["atol"] * float(lp.abs().max()))
    ck = pad_cache_to_capacity(ck, get_model(cfg).cache_axes(), 200)
    cp = pad_cache_to_capacity(cp, get_model(cfg).cache_axes(), 200)
    nt = toks[:, -1:]
    for step in range(3):
        lk, ck = get_model(cfg).decode_step(params, ck, nt, 150 + step)
        lp, cp = get_model(plain).decode_step(params, cp, nt, 150 + step)
        torch.testing.assert_close(lk, lp, rtol=tol["rtol"],
                                   atol=tol["atol"] * float(lp.abs().max()))
    assert ops.launch_counts()["decode_attention"] == 9
    torch.testing.assert_close(ck["prelude_0"][0], cp["prelude_0"][0], **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_jamba_head_layout(cuda, dtype):
    """Jamba-1.5-Large's attention layer: 64 query heads over 8 kv heads (G =
    8), head dim 128; flash prefill at prompts that straddle its SSD chunk,
    in the model's [B, S, H, D] layout, and decode of 4 slots against [4,
    1280, 8, 128] caches."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for S in (3, 257, 1100):
        q = _randn(g, (1, S, 64, 128), dtype, cuda)
        k, v = _randn(g, (1, S, 8, 128), dtype, cuda), _randn(g, (1, S, 8, 128), dtype, cuda)
        got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        want = kref.mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            sm_scale=1 / math.sqrt(128), causal=True)
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    q = _randn(g, (4, 64, 128), dtype, cuda)
    kc, vc = _randn(g, (4, 1280, 8, 128), dtype, cuda), _randn(g, (4, 1280, 8, 128), dtype, cuda)
    lengths = torch.tensor([4, 257, 1024, 1280], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), lengths)
    want = kref.decode_ref(q.reshape(4, 8, 8, 128), kc.transpose(1, 2), vc.transpose(1, 2),
                           lengths.reshape(4, 1), sm_scale=1 / math.sqrt(128)).reshape(4, 64, 128)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


def _hybrid_cfg(**over):
    """A narrow Jamba-like hybrid: one attention layer (8 query heads over 1
    kv head) and three Mamba-2 layers, MoE FFNs at layers 1 and 3."""
    return ModelConfig(**dict(dict(
        name="tiny-hybrid", family="hybrid", n_layers=4, d_model=512, n_heads=8, n_kv_heads=1,
        d_ff=512, vocab_size=1000, block_pattern=("attn", "mamba", "mamba", "mamba"),
        n_experts=4, experts_per_token=2, moe_d_ff=256, moe_every=2, mamba_d_state=16,
        mamba_head_dim=64, mamba_chunk=64, dtype="float32", attn_impl="pallas"), **over))


def test_hybrid_model_kernel_path_matches_plain_path(cuda):
    """The narrow hybrid in float32 on the card: prefill (the SSD over three
    chunks, the last ragged) and decode under attn_impl="pallas" (one flash
    launch per prefill, one decode launch per step) against the plain
    "naive" path on the same weights: logits and every Mamba state."""
    from repro_torch.serving.engine import pad_cache_to_capacity

    cfg = _hybrid_cfg()
    plain = dataclasses.replace(cfg, attn_impl="naive")
    params = get_model(cfg).init_params(seed=1, device=cuda)
    toks = torch.randint(0, 1000, (2, 150), generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    tol = ATTN_TOL[torch.float32]
    ops.reset_launches()
    lk, ck = get_model(cfg).prefill(params, {"tokens": toks})
    lp, cp = get_model(plain).prefill(params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(lk, lp, rtol=tol["rtol"], atol=tol["atol"] * float(lp.abs().max()))
    ck = pad_cache_to_capacity(ck, get_model(cfg).cache_axes(), 200)
    cp = pad_cache_to_capacity(cp, get_model(cfg).cache_axes(), 200)
    nt = toks[:, -1:]
    for step in range(3):
        lk, ck = get_model(cfg).decode_step(params, ck, nt, 150 + step)
        lp, cp = get_model(plain).decode_step(params, cp, nt, 150 + step)
        torch.testing.assert_close(lk, lp, rtol=tol["rtol"],
                                   atol=tol["atol"] * float(lp.abs().max()))
    assert ops.launch_counts()["decode_attention"] == 3
    for j in (1, 2, 3):
        for name in ("h", "conv"):
            torch.testing.assert_close(ck["groups"][f"l{j}"][name], cp["groups"][f"l{j}"][name],
                                       rtol=1e-4, atol=1e-4)


def test_recurrent_scans_on_the_card_equal_their_cpu_run(cuda):
    """`ssd_chunked`, `mlstm_chunked` and `slstm_cell` in float32 (TF32
    off) on the card against their CPU runs on the same inputs, and each
    chunked form against its sequential oracle on the card."""
    from repro_torch.models import mamba as mb
    from repro_torch.models import xlstm as xl
    from repro_torch.nn import core as nn

    g = torch.Generator().manual_seed(3)
    xh, Bm, Cm = (torch.randn(s, generator=g) for s in ((2, 300, 8, 64), (2, 300, 16),
                                                        (2, 300, 16)))
    dt = mb.softplus(torch.randn((2, 300, 8), generator=g))
    a_log = torch.randn(8, generator=g) * 0.5
    y_h, h_h = mb.ssd_chunked(xh, dt, Bm, Cm, a_log, chunk=128)
    y_c, h_c = mb.ssd_chunked(*(t.to(cuda) for t in (xh, dt, Bm, Cm, a_log)), chunk=128)
    torch.testing.assert_close(y_c.cpu(), y_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_c.cpu(), h_h, rtol=1e-4, atol=1e-4)
    y_s, h_s = mb.ssd_scan_ref(*(t.to(cuda) for t in (xh, dt, Bm, Cm, a_log)))
    torch.testing.assert_close(y_c, y_s, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_c, h_s, rtol=1e-4, atol=1e-4)
    q, k, v = (torch.randn((2, 300, 4, 32), generator=g) for _ in range(3))
    lf = xl.log_sigmoid(torch.randn((2, 300, 4), generator=g) + 1)
    li = torch.randn((2, 300, 4), generator=g)
    h_h, s_h = xl.mlstm_chunked(q, k, v, lf, li, chunk=128)
    h_c, s_c = xl.mlstm_chunked(*(t.to(cuda) for t in (q, k, v, lf, li)), chunk=128)
    h_s, s_s = xl.mlstm_scan_ref(*(t.to(cuda) for t in (q, k, v, lf, li)))
    torch.testing.assert_close(h_c.cpu(), h_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_c, h_s, rtol=2e-4, atol=2e-4)
    for name in ("C", "n", "m"):
        torch.testing.assert_close(s_c[name].cpu(), s_h[name], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s_c[name], s_s[name], rtol=2e-4, atol=2e-4)
    cfg = ModelConfig(name="tiny-xlstm", family="ssm", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_ff=0, vocab_size=1000, block_pattern=("mlstm", "slstm"),
                      dtype="float32")
    p = xl.slstm_init(nn.InitCtx(gen=torch.Generator().manual_seed(4), dtype=torch.float32),
                      cfg, 1)
    p = {"w": p["w"][0], "r": p["r"][0], "b": p["b"][0]}
    x = torch.randn((2, 64, 128), generator=g)
    st = xl.init_slstm_state(cfg, 2, "cpu")
    h_h, s_h = xl.slstm_cell(p, cfg, x, st)
    h_c, s_c = xl.slstm_cell({k_: t.to(cuda) for k_, t in p.items()}, cfg, x.to(cuda),
                             {k_: t.to(cuda) for k_, t in st.items()})
    torch.testing.assert_close(h_c.cpu(), h_h, rtol=1e-4, atol=1e-4)
    for name in ("c", "n", "m", "h"):
        torch.testing.assert_close(s_c[name].cpu(), s_h[name], rtol=1e-4, atol=1e-4)
