"""The port's kernel entry points (`repro_torch.kernels.ops`) against the JAX
reference's, on the CPU.

Here the port's wrappers run their plain PyTorch versions (the tensors lie
on the CPU); the reference runs its Pallas kernels in interpret mode and
its jnp oracles.  The fused stage-2 cases mirror `tests/test_score_fuse.py`
and add the live-weight, affinity and per-query-row variants; the
fused-selection cases mirror `tests/test_kernel_edges.py` (off-tile shapes,
one server, fewer tools than k, all invalid, all dead, mixed).  Decisions
must match exactly; C, N and S within rtol 2e-6 / atol 2e-7.
The attention cases hold the plain versions of the flash and flash-decode
kernels (`ops.flash_attention`, `ops.decode_attention` on CPU tensors) to
the reference's entry points (Pallas, interpret mode) and oracles
(`mha_ref`, `decode_ref`) on a subset of `tests/test_kernels.py`'s shapes,
within its tolerances (rtol = atol = 2e-5 in float32, 2e-2 in bfloat16).
The CUDA kernels themselves are tested on the card by
`tests/test_torch_cuda.py`.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jquantize
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels import ref as jref
from repro_torch.core import qos
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bm25_score, qos_score, score_fuse, select_fuse
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels import ref as kref

RTOL, ATOL = 2e-6, 2e-7
STRIPE, QUERY_TILE = 512, 8


def _fleet(rng, n_q, V, n_srv, n_t, top_s, sparsity=0.2):
    q = rng.poisson(0.4, (n_q, V)).astype(np.float32)
    qr = rng.poisson(0.4, (n_q, V)).astype(np.float32)
    w = (rng.random((n_t, V)) * (rng.random((n_t, V)) < sparsity)).astype(np.float32)
    ts = np.sort(rng.integers(0, n_srv, n_t)).astype(np.int32)
    cand = np.stack([rng.choice(n_srv, top_s, replace=False) for _ in range(n_q)]).astype(np.int32)
    return q, qr, w, ts, cand


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _port(q, w, ts, cand, qos_row, qr=None, **kw):
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return ops.fused_score_select(_t(q), _t(w), _t(ts), _t(cand), _t(qos_row),
                                  q_rerank=_t(qr), **kw)


def _check(port_out, ref_out, ctx=""):
    i1, c1, n1, s1 = (np.asarray(x) for x in port_out)
    i2, c2, n2, s2 = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(i1, i2, err_msg=f"{ctx}: tool_idx")
    for a, b, nm in ((c1, c2, "C"), (n1, n2, "N"), (s1, s2, "S")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{ctx}: {nm}")


def _both(q, w, ts, cand, qos_row, qr=None, **kw):
    """Port vs the reference's Pallas kernel (interpret) and its jnp oracle."""
    got = _port(q, w, ts, cand, qos_row, qr, **kw)
    _check(got, jops.fused_score_select(q, w, ts, cand, qos_row, q_rerank=qr,
                                        interpret=True, **kw), "vs pallas")
    _check(got, jref.fused_score_select_ref(jnp.asarray(q), jnp.asarray(w), jnp.asarray(ts),
                                            jnp.asarray(cand), qos_row, q_rerank=qr, **kw),
           "vs oracle")
    return got


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize(
    "extras",
    [
        {},
        {"gamma": 0.4, "with_load": True},
        {"gamma": 0.4, "delta": 0.3, "with_load": True, "with_rtt": True, "with_dead": True},
    ],
)
def test_parity_single_stripe(rerank, extras):
    rng = np.random.default_rng(0)
    n_q, n_t = 13, 45
    q, qr, w, ts, cand = _fleet(rng, n_q, 96, 17, n_t, 5)
    qos_row = rng.uniform(-1, 1, n_t).astype(np.float32)
    kw = dict(k=8, alpha=0.6, beta=0.3, temp=0.7,
              gamma=extras.get("gamma", 0.0), delta=extras.get("delta", 0.0))
    if extras.get("with_load"):
        kw["tool_load"] = rng.uniform(0, 2, (n_q, n_t)).astype(np.float32)
    if extras.get("with_rtt"):
        kw["tool_rtt"] = rng.uniform(0, 1, n_t).astype(np.float32)
    if extras.get("with_dead"):
        kw["tool_dead"] = (rng.random(n_t) < 0.15).astype(np.float32)
    _both(q, w, ts, cand, qos_row, qr if rerank else None, **kw)


def test_parity_multi_stripe_with_skipping():
    rng = np.random.default_rng(1)
    n_q, n_t = 16, 3 * STRIPE - 137
    q, _qr, w, ts, cand = _fleet(rng, n_q, 128, 400, n_t, 4, sparsity=0.1)
    qos_row = rng.uniform(-1, 1, n_t).astype(np.float32)
    _both(q, w, ts, cand, qos_row, k=16, alpha=0.6, beta=0.3, gamma=0.2, temp=1.0,
          tool_load=rng.uniform(0, 2, n_t).astype(np.float32),
          tool_dead=(rng.random(n_t) < 0.3).astype(np.float32))


def test_tie_heavy_integer_scores():
    rng = np.random.default_rng(2)
    n_q, n_t, n_srv = 16, STRIPE + 200, 50
    w = rng.integers(0, 2, (n_t, 64)).astype(np.float32)
    q = rng.integers(0, 2, (n_q, 64)).astype(np.float32)
    ts = np.sort(rng.integers(0, n_srv, n_t)).astype(np.int32)
    cand = np.stack([rng.choice(n_srv, 6, replace=False) for _ in range(n_q)]).astype(np.int32)
    _both(q, w, ts, cand, np.zeros(n_t, np.float32), k=16, alpha=1.0, beta=0.0)


def test_k_exceeds_candidate_tools():
    rng = np.random.default_rng(3)
    q, _qr, w, ts, cand = _fleet(rng, 8, 64, 20, 30, 2)
    _both(q, w, ts, cand, rng.uniform(-1, 1, 30).astype(np.float32), k=25, alpha=0.6, beta=0.3)


def test_all_candidates_dead():
    rng = np.random.default_rng(4)
    q, _qr, w, ts, cand = _fleet(rng, 8, 64, 12, 40, 3)
    _both(q, w, ts, cand, rng.uniform(-1, 1, 40).astype(np.float32), k=8, alpha=0.6, beta=0.3,
          tool_dead=np.ones(40, np.float32))


def test_quantized_bf16_operands():
    rng = np.random.default_rng(5)
    n_t = STRIPE + 64
    q, _qr, w, ts, cand = _fleet(rng, 16, 128, 100, n_t, 4)
    qb = jquantize.round_weights(q, "bfloat16")
    wb = jquantize.round_weights(w, "bfloat16")
    qos_row = jquantize.quantize_bf16(rng.uniform(-1, 1, n_t)).astype(np.float32)
    kw = dict(k=12, alpha=0.6, beta=0.3)
    got = _both(qb, wb, ts, cand, qos_row, **kw)
    # physically bf16 tensors widen exactly to the same decisions
    got_b = ops.fused_score_select(_t(qb).bfloat16(), _t(wb).bfloat16(), _t(ts), _t(cand),
                                   _t(qos_row), **kw)
    for a, b in zip(got, got_b):
        assert torch.equal(a, b)


def test_ragged_query_rows():
    rng = np.random.default_rng(6)
    for n_q in (1, QUERY_TILE - 1, QUERY_TILE + 3):
        q, _qr, w, ts, cand = _fleet(rng, n_q, 64, 15, 33, 3)
        _both(q, w, ts, cand, rng.uniform(-1, 1, 33).astype(np.float32), k=6,
              alpha=0.6, beta=0.3)


@pytest.mark.parametrize("per_query", [False, True])
def test_affinity_and_per_query_rows(per_query):
    rng = np.random.default_rng(7)
    n_q, n_t = 9, 70
    q, qr, w, ts, cand = _fleet(rng, n_q, 48, 30, n_t, 4)
    shape = (n_q, n_t) if per_query else (n_t,)
    rows = {nm: rng.uniform(0, 1, shape).astype(np.float32)
            for nm in ("qos", "tool_load", "tool_rtt", "tool_aff")}
    rows["tool_dead"] = (rng.random(shape) < 0.2).astype(np.float32)
    qos_row = rows.pop("qos")
    _both(q, w, ts, cand, qos_row, qr, k=7, alpha=0.5, beta=0.5, gamma=0.35, delta=0.4,
          eps=0.25, temp=1.0, **rows)


def test_live_weights_match_static_and_reference():
    """Fusion weights as tensors (the live [alpha, beta, gamma, delta] the
    learned-weight router will feed) give the static-weight decisions."""
    rng = np.random.default_rng(8)
    n_q, n_t = 10, 60
    q, _qr, w, ts, cand = _fleet(rng, n_q, 40, 25, n_t, 4)
    qos_row = rng.uniform(-1, 1, n_t).astype(np.float32)
    load = rng.uniform(0, 2, n_t).astype(np.float32)
    rtt = rng.uniform(0, 1, n_t).astype(np.float32)
    wv = np.array([0.45, 0.55, 0.3, 0.2], np.float32)
    static = dict(alpha=float(wv[0]), beta=float(wv[1]), gamma=float(wv[2]), delta=float(wv[3]))
    live_t = torch.from_numpy(wv)
    got = _port(q, w, ts, cand, qos_row, k=6, tool_load=load, tool_rtt=rtt,
                alpha=live_t[0], beta=live_t[1], gamma=live_t[2], delta=live_t[3])
    _check(got, _port(q, w, ts, cand, qos_row, k=6, tool_load=load, tool_rtt=rtt, **static),
           "live vs static")
    live_j = jnp.asarray(wv)
    _check(got, jops.fused_score_select(
        q, w, ts, cand, qos_row, tool_load=load, tool_rtt=rtt, k=6, interpret=True,
        alpha=live_j[0], beta=live_j[1], gamma=live_j[2], delta=live_j[3]), "vs pallas live")


def test_fused_select_ref_matches_reference_oracle():
    rng = np.random.default_rng(9)
    n_q, n_t = 7, 50
    sel = rng.integers(0, 4, (n_q, n_t)).astype(np.float32)       # heavy ties
    sel[rng.random((n_q, n_t)) < 0.5] = -np.inf
    val = rng.random((n_q, n_t)).astype(np.float32)
    qos_row = rng.uniform(-1, 1, (n_q, n_t)).astype(np.float32)
    dead = (rng.random(n_t) < 0.3).astype(np.float32)
    kw = dict(k=9, alpha=0.6, beta=0.4, gamma=0.1, temp=0.8)
    load = rng.random(n_t).astype(np.float32)
    got = kref.fused_select_ref(_t(sel), _t(val), _t(qos_row), _t(load), _t(dead), **kw)
    want = jref.fused_select_ref(jnp.asarray(sel), jnp.asarray(val), jnp.asarray(qos_row),
                                 jnp.asarray(load), jnp.asarray(dead), **kw)
    _check(got, want)


@pytest.mark.parametrize("n_q,n_d,V", [(1, 1, 1), (5, 70, 33), (130, 9, 513), (3, 11, 7)])
def test_bm25_scores_ragged_shapes(n_q, n_d, V):
    rng = np.random.default_rng(n_d)
    q = rng.poisson(0.5, (n_q, V)).astype(np.float32)
    w = (rng.random((n_d, V)) * (rng.random((n_d, V)) < 0.3)).astype(np.float32)
    w[n_d // 2:] = w[0]                               # replica rows tie exactly
    got = ops.bm25_scores(_t(q), _t(w).t()).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.bm25_scores(q, w, interpret=True)),
                               rtol=RTOL, atol=ATOL)
    assert np.all(got[:, n_d // 2:] == got[:, :1])


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_tool_csr_walk_matches_candidate_mask(order):
    """The fused kernel's candidate walk over the server -> tools map
    visits exactly the tools that `candidate_mask` marks, each once,
    ascending within a server, whether the map covers just the hosting
    servers or more; for tools grouped by server the map is the identity
    order."""
    rng = np.random.default_rng(3 + (order == "unsorted"))
    n_srv, n_t, n_q, top_s = 40, 150, 9, 6
    ts = np.sort(rng.integers(0, n_srv - 5, n_t))       # servers 35.. host no tool
    if order == "unsorted":
        ts = rng.permutation(ts)
    cand = np.stack([rng.choice(n_srv, top_s, replace=False) for _ in range(n_q)])
    ts_t, cand_t = _t(ts.astype(np.int32)), _t(cand)
    want = kref.candidate_mask(ts_t, cand_t).numpy()
    csr = score_fuse.tool_csr(ts_t, n_srv)
    wide = score_fuse.tool_csr(ts_t, n_srv + 7)       # servers past every id host nothing
    assert csr.tools.dtype == csr.offsets.dtype == torch.int32
    assert csr.offsets.shape == (n_srv + 1,)
    np.testing.assert_array_equal(wide.tools.numpy(), csr.tools.numpy())
    np.testing.assert_array_equal(wide.offsets.numpy()[:n_srv + 1], csr.offsets.numpy())
    assert np.all(wide.offsets.numpy()[n_srv:] == n_t)
    if order == "sorted":
        np.testing.assert_array_equal(csr.tools.numpy(), np.arange(n_t))
    off, tl = csr.offsets.numpy(), csr.tools.numpy()
    for qi in range(n_q):
        walked = np.concatenate([tl[off[c]:off[c + 1]] for c in cand[qi]])
        assert len(set(walked.tolist())) == len(walked)
        mask = np.zeros(n_t, bool)
        mask[walked] = True
        np.testing.assert_array_equal(mask, want[qi])
        for c in cand[qi]:
            seg = tl[off[c]:off[c + 1]]
            assert np.all(np.diff(seg) > 0) and np.all(ts[seg] == c)


@pytest.mark.parametrize("T", [1, 3, 45, 65])
def test_qos_scores_dispatches_to_plain_on_cpu(T):
    rng = np.random.default_rng(10)
    lat = rng.uniform(5, 1200, (37, T)).astype(np.float32)
    got = ops.qos_scores(_t(lat)).numpy()
    assert np.array_equal(got, qos.network_score(_t(lat)).numpy())
    np.testing.assert_allclose(got, np.asarray(jops.qos_scores(lat, interpret=True)),
                               rtol=RTOL, atol=ATOL)
    assert ops.launch_counts() == {"bm25_scores": 0, "qos_scores": 0, "fused_score_select": 0,
                                   "fused_select": 0, "flash_attention": 0,
                                   "decode_attention": 0}


def test_kernel_launchers_refuse_cpu_tensors_without_building():
    """A launcher never runs a plain version: a CPU tensor is refused
    before any library is looked up."""
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        bm25_score.bm25_scores_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        qos_score.qos_scores_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        score_fuse.fused_score_select_cuda(
            x, x, score_fuse.ToolCsr(torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(3, dtype=torch.int32)),
            torch.zeros((2, 1), dtype=torch.int32),
            {"tool_qos": torch.zeros(3)}, None, k=1, alpha=1.0, beta=0.0, gamma=0.0,
            delta=0.0, eps=0.0, temp=1.0,
        )
    with pytest.raises(ValueError, match="CUDA"):
        select_fuse.fused_select_cuda(x, x, {"tool_qos": torch.zeros(3)}, k=1, alpha=1.0,
                                      beta=0.0, gamma=0.0, delta=0.0, eps=0.0, temp=1.0)
    x4 = torch.zeros((1, 2, 5, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(x4, x4, x4, sm_scale=0.125, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention_cuda(x4[:, :, :1], x4, x4,
                                               torch.ones(1, dtype=torch.int32), sm_scale=0.125)
    assert _build._LIBS == {}


def test_importing_builds_nothing():
    """Importing every kernel module and routing on the CPU never starts a
    compiler or loads a library."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started')\n"
        "subprocess.Popen = refuse\n"
        "from repro_torch.kernels import _build, ops, bm25_score, qos_score, score_fuse, ref\n"
        "from repro_torch.kernels import select_fuse, flash_attention, decode_attention\n"
        "from repro_torch.core import dataset\n"
        "from repro_torch.core.batch_routing import make_engine\n"
        "from repro_torch.core.mesh_routing import make_sharded_engine\n"
        "from repro_torch.traffic import mega_fleet_index\n"
        "s = dataset.build_server_pool(0)\n"
        "e = make_engine('sonar', s, device='cpu', use_kernels=True)\n"
        "d = e.route_texts(['search the web'])\n"
        "m = make_sharded_engine('sonar_adapt', index=mega_fleet_index(30), n_shards=2,\n"
        "                        device='cpu', use_kernels=True)\n"
        "d = m.route_texts(['search the web'])\n"
        "import dataclasses\n"
        "from repro_torch import configs\n"
        "from repro_torch.models.api import get_model\n"
        "from repro_torch.serving.engine import Request, ServeEngine\n"
        "cfg = dataclasses.replace(configs.get_reduced('internlm2-1.8b'), attn_impl='pallas')\n"
        "mdl = get_model(cfg)\n"
        "eng = ServeEngine(mdl, mdl.init_params(0, device='cpu'), 1, 16, device='cpu')\n"
        "eng.submit(Request(0, [1, 2, 3], max_new_tokens=3))\n"
        "eng.drain()\n"
        "assert _build._LIBS == {}\n"
        "assert ops.launch_counts() == {'bm25_scores': 0, 'qos_scores': 0,"
        " 'fused_score_select': 0, 'fused_select': 0, 'flash_attention': 0,"
        " 'decode_attention': 0}\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_qos_kernel_constants():
    """The host-side constants the QoS kernel reads: real window length,
    carry, centred positions' sum of squares (the reference's values)."""
    p = qos.QosParams(window=32, ewma_alpha=0.3)
    window, params = qos_score.kernel_params(p, 20)
    vals = list(params)
    assert window == 20 and vals[15] == 20.0
    x = np.arange(20, dtype=np.float32) - 19 + (20 - 1) / 2.0
    assert vals[16] == float(np.sum(x * x))
    assert vals[5] == float(np.float32(0.7 ** 20))


@pytest.mark.parametrize("T,dtype,misaligned,vec", [
    (64, torch.float32, False, 4), (64, torch.float32, True, 1), (63, torch.float32, False, 1),
    (4, torch.float32, False, 4), (64, torch.bfloat16, False, 8), (60, torch.bfloat16, False, 1),
    (64, torch.bfloat16, True, 1), (2048, torch.float32, False, 4),
])
def test_qos_launch_plan_vector_width(T, dtype, misaligned, vec):
    """16-byte loads only where T keeps every row 16-byte aligned and the
    base address is (an offset view may not be)."""
    ptr = 0x7F00_0000_0000 + (4 if misaligned else 0)
    assert qos_score.launch_plan(T, dtype, ptr, 10_005).vec == vec


@pytest.mark.parametrize("T,group,mode", [
    (1, 1, "registers"), (16, 1, "ring"), (17, 2, "registers"), (63, 4, "registers"),
    (64, 4, "ring"), (65, 8, "registers"), (256, 16, "ring"), (257, 32, "stream"),
    (2048, 32, "stream"),
])
def test_qos_launch_plan_regimes(T, group, mode):
    """Lanes per row: the fewest that read at most 16 samples each; rows up
    to 256 samples are read once (the ring for large windows with 16-byte
    loads), longer ones streamed."""
    n = qos_score.RING_MIN_ROWS
    plan = qos_score.launch_plan(T, torch.float32, 0, n)
    assert (plan.group, plan.mode) == (group, mode)
    assert plan.group & (plan.group - 1) == 0 and plan.group <= 32
    if plan.mode != "stream":
        assert -(-T // plan.group) <= qos_score.LANE_SAMPLES
    small = qos_score.launch_plan(T, torch.float32, 0, n - 1)
    assert small.mode == ("registers" if mode == "ring" else mode)


@pytest.mark.parametrize("n_t,per_lane,staged", [
    (1, 1, False), (32, 1, False), (33, 2, False), (64, 2, False), (65, 4, False),
    (128, 4, False), (129, 8, False), (256, 8, False), (257, 0, True), (20_010, 0, True),
    (54_016, 0, True), (54_017, 0, False), (60_000, 0, False),
])
def test_select_launch_plan_regimes(n_t, per_lane, staged):
    """Narrow rows (up to 256) to a warp with 32 * per_lane >= n_t keys;
    wider rows to a block, staged in shared memory while the keys fit."""
    plan = select_fuse.launch_plan(n_t)
    assert (plan.per_lane, plan.staged) == (per_lane, staged)
    assert (plan.per_lane > 0) == (n_t <= select_fuse.NARROW_MAX)
    if plan.per_lane:
        assert 32 * plan.per_lane >= n_t > 32 * plan.per_lane // 2 or n_t <= 32
    assert plan.dyn_smem == (4 * n_t if staged else 0)


def test_select_launch_plan_shared_memory_bound():
    """No plan asks for more dynamic shared memory than a block may hold
    beside the kernel's static arrays (232,448 bytes on the H100)."""
    for n_t in list(range(1, 600)) + list(range(20_000, 60_001, 977)) + [54_016, 54_017]:
        plan = select_fuse.launch_plan(n_t)
        assert plan.dyn_smem <= select_fuse.WIDE_DYN_MAX
        assert plan.dyn_smem + 16_384 <= 232_448


def _zero_ties(rng, n_q, n_t):
    sel = np.where(rng.random((n_q, n_t)) < 0.5, -0.0, 0.0).astype(np.float32)
    sel[:, ::7] = -1.0
    return sel


@pytest.mark.parametrize("case", ["all_equal", "all_neg", "all_inf", "k_equals_n_t"])
def test_fused_select_edge_rows_match_reference(case):
    """Rows the ranking must break by index alone, against the reference's
    Pallas kernel (interpret mode) and its oracle."""
    rng = np.random.default_rng(len(case))
    n_q, n_t, k = 5, 40, 8
    if case == "all_equal":
        sel = np.full((n_q, n_t), 2.5, np.float32)
    elif case == "all_neg":
        sel = np.full((n_q, n_t), kref.NEG, np.float32)
    elif case == "all_inf":
        sel = np.full((n_q, n_t), -np.inf, np.float32)
    else:
        sel = rng.integers(0, 4, (n_q, n_t)).astype(np.float32)
        sel[rng.random((n_q, n_t)) < 0.3] = -np.inf
        k = n_t
    val = rng.random((n_q, n_t)).astype(np.float32)
    _select_both(sel, val, rng.uniform(-1, 1, n_t).astype(np.float32),
                 load=rng.random(n_t).astype(np.float32), k=k, gamma=0.3)


def test_fused_select_signed_zero_ties():
    """-0 and +0 tie and the lower index wins, as in the reference's Pallas
    kernel (interpret mode), torch's stable sort and the scalar router's
    stable argsort.  The reference's oracle ranks with lax.top_k, which puts
    +0 above -0; it agrees once every -0 is written as +0."""
    rng = np.random.default_rng(4)
    n_q, n_t = 6, 40
    sel = _zero_ties(rng, n_q, n_t)
    val = rng.random((n_q, n_t)).astype(np.float32)
    qos_row = rng.uniform(-1, 1, n_t).astype(np.float32)
    kw = dict(k=8, alpha=0.5, beta=0.5)
    got = ops.fused_select(_t(sel), _t(val), _t(qos_row), **kw)
    jargs = (jnp.asarray(sel), jnp.asarray(val), jnp.asarray(qos_row))
    _check(got, jops.fused_select(*jargs, interpret=True, **kw), "vs pallas")
    plus = sel + np.float32(0.0)                      # -0 -> +0
    assert not np.signbit(plus[plus == 0]).any()
    _check(got, jref.fused_select_ref(jnp.asarray(plus), *jargs[1:], **kw), "vs oracle, +0")
    assert not np.array_equal(np.asarray(jref.fused_select_ref(*jargs, **kw)[0]),
                              got[0].numpy())


# ---------------------------------------------------------------------------
# fused_select: the port's wrapper (plain version on the CPU) against the
# reference's Pallas kernel in interpret mode and its jnp oracle
# ---------------------------------------------------------------------------

def _select_both(sel, val, qos_row, load=None, dead=None, **kw):
    kw.setdefault("alpha", 0.5)
    kw.setdefault("beta", 0.5)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = ops.fused_select(_t(sel), _t(val), _t(qos_row), _t(load), _t(dead), **tkw)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jargs = [None if x is None else jnp.asarray(x) for x in (sel, val, qos_row, load, dead)]
    _check(got, jops.fused_select(*jargs, interpret=True, **jkw), "vs pallas")
    _check(got, jref.fused_select_ref(*jargs, **jkw), "vs oracle")
    return [x.numpy() for x in got]


@pytest.mark.parametrize("n_q,n_t", [(1, 1), (3, 130), (QUERY_TILE + 1, 300), (2, 127)])
def test_fused_select_off_tile_shapes(n_q, n_t):
    rng = np.random.default_rng(n_q * 1000 + n_t)
    sel = rng.standard_normal((n_q, n_t)).astype(np.float32)
    _select_both(sel, sel, rng.uniform(-1, 1, n_t).astype(np.float32), k=min(8, n_t))


def test_fused_select_single_server_fleet():
    sel = np.asarray([[2.5], [0.1], [-1.0]], np.float32)
    idx, c, _n, _s = _select_both(sel, sel, np.asarray([0.3], np.float32), k=4)
    assert (idx == 0).all()
    np.testing.assert_allclose(c, 1.0, rtol=1e-6)


def test_fused_select_fewer_tools_than_k():
    rng = np.random.default_rng(0)
    sel = rng.standard_normal((5, 7)).astype(np.float32)
    qos_row = rng.random((5, 7)).astype(np.float32)
    idx = _select_both(sel, sel, qos_row, k=10)[0]
    full = kref.fused_select_ref(_t(sel), _t(sel), _t(qos_row), k=7, alpha=0.5, beta=0.5)
    assert (idx == full[0].numpy()).all()


def test_fused_select_all_candidates_invalid():
    sel = np.full((4, 40), -np.inf, np.float32)
    idx, _c, _n, s = _select_both(sel, sel, np.zeros(40, np.float32), k=8)
    assert (idx == 0).all() and (s <= kref.NEG / 2).all()


def test_fused_select_all_candidates_dead():
    rng = np.random.default_rng(3)
    sel = rng.standard_normal((6, 90)).astype(np.float32) * 2
    idx, _c, _n, s = _select_both(sel, sel, rng.random(90).astype(np.float32),
                                  dead=np.ones(90, np.float32), k=6)
    assert (idx == np.argmax(sel, axis=1)).all() and (s <= kref.NEG / 2).all()


def test_fused_select_mixed_dead_and_invalid():
    rng = np.random.default_rng(9)
    n_q, n_t = 9, 150
    sel = rng.standard_normal((n_q, n_t)).astype(np.float32) * 3
    sel = np.where(rng.random((n_q, n_t)) < 0.5, sel, -np.inf).astype(np.float32)
    _select_both(sel, sel, rng.uniform(-1, 1, (n_q, n_t)).astype(np.float32),
                 load=rng.random(n_t).astype(np.float32),
                 dead=(rng.random((n_q, n_t)) < 0.5).astype(np.float32), k=12, gamma=0.3)


@pytest.mark.parametrize("per_query", [False, True])
def test_fused_select_rerank_rtt_affinity_live_weights(per_query):
    """val differs from sel (rerank), tie-heavy integer scores, the RTT and
    affinity rows, and the live [4] weight vector the sharded engine feeds."""
    rng = np.random.default_rng(11)
    n_q, n_t = 7, 45
    sel = rng.integers(0, 4, (n_q, n_t)).astype(np.float32)
    sel[rng.random((n_q, n_t)) < 0.3] = -np.inf
    val = rng.random((n_q, n_t)).astype(np.float32)
    shape = (n_q, n_t) if per_query else (n_t,)
    rows = {nm: rng.random(shape).astype(np.float32) for nm in ("qos", "load", "rtt", "aff")}
    dead = (rng.random(shape) < 0.2).astype(np.float32)
    kw = dict(k=9, temp=0.8, tool_rtt=rows["rtt"], tool_aff=rows["aff"], eps=0.25)
    want = _select_both(sel, val, rows["qos"], rows["load"], dead, alpha=0.45, beta=0.55,
                        gamma=0.3, delta=0.2, **kw)
    live = torch.tensor([0.45, 0.55, 0.3, 0.2])
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = ops.fused_select(_t(sel), _t(val), _t(rows["qos"]), _t(rows["load"]), _t(dead),
                           alpha=live[0], beta=live[1], gamma=live[2], delta=live[3], **tkw)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _attn_operands(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,causal",
    [
        (2, 8, 2, 256, 64, True),     # GQA 4:1
        (1, 4, 1, 256, 64, False),    # MQA bidirectional
        (2, 6, 6, 130, 32, True),     # ragged S, no padding in the port
    ],
)
def test_flash_attention_plain_matches_reference(B, Hq, Hkv, S, D, causal, dtype):
    (jq, jk, jv), (q, k, v) = _attn_operands(
        [(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype, S + Hq)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (jops.flash_attention(jq, jk, jv, causal=causal),
                 jref.mha_ref(jq, jk, jv, sm_scale=1 / np.sqrt(D), causal=causal)):
        np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype])
    # the model's [B, S, H, D] layout, as transposed views
    got_t = ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k.transpose(1, 2).contiguous().transpose(1, 2),
                                v.transpose(1, 2).contiguous().transpose(1, 2), causal=causal)
    np.testing.assert_allclose(_f32(got_t), _f32(got), **ATTN_TOL[dtype])
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(4, 8, 2, 256, 64), (3, 7, 7, 200, 32)])
def test_decode_attention_plain_matches_reference(B, Hq, Hkv, S, D, dtype):
    """Random per-row lengths, 1 and S included."""
    (jq, jk, jv), (q, k, v) = _attn_operands(
        [(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype, S + Hq)
    rng = np.random.default_rng(S)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    got = ops.decode_attention(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == q.shape
    G = Hq // Hkv
    for want in (
        jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), bk=128),
        jref.decode_ref(jq.reshape(B, Hkv, G, D), jk, jv, jnp.asarray(lengths).reshape(B, 1),
                        sm_scale=1 / np.sqrt(D)).reshape(B, Hq, D),
    ):
        np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype])
    # the model's cache layout [B, S, Hkv, D] through a transposed view
    got_c = ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                                 v.transpose(1, 2).contiguous().transpose(1, 2),
                                 torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(got_c), _f32(got), **ATTN_TOL[dtype])
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.parametrize("bh,S", [(1, 1), (1, 16), (8, 127), (64, 100), (1, 128), (2, 130),
                                  (64, 2048), (8, 2048), (256, 4096), (1, 32768), (1024, 65536)])
def test_decode_splits(bh, S):
    """One split for tiny caches, a full wave of blocks at the serving
    shape, and never a split shorter than its minimum."""
    n = decode_attention.decode_splits(bh, S)
    assert 1 <= n <= decode_attention.MAX_SPLITS
    assert n == 1 or S // n >= decode_attention.MIN_SPLIT_ROWS
    if S < 2 * decode_attention.MIN_SPLIT_ROWS:
        assert n == 1
    if (bh, S) == (64, 2048):           # the serving step: B 8 x Hkv 8, cap 2048
        assert n * bh >= 2 * decode_attention.SMS
    assert decode_attention.decode_splits(bh, S) == n          # a pure function


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("B,Hkv,G,S,D,bk", [(12, 2, 2, 256, 32, 64), (12, 1, 4, 192, 16, 32)])
def test_decode_split_ref_matches_references(B, Hkv, G, S, D, bk, n_split):
    """The split-and-merge algebra of the split-KV decode kernel against the
    reference's oracle and its Pallas kernel (interpret mode), in f32.
    Lengths: 0, 1, a split boundary and its neighbours, S, and short
    sequences whose later splits are all empty.  `decode_ref` gives the
    mean of V for a length-0 row (a softmax over an all-masked row) while
    the kernels give 0, so that row is held to the Pallas kernel only."""
    rng = np.random.default_rng(S + n_split)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    edge = S // n_split if n_split > 1 else S // 2
    lengths = np.array([0, 1, edge - 1, edge, edge + 1, S, S - 1, 2, 5, 33, S // 3, S // 2 + 7],
                       np.int32)[:B]
    got = kref.decode_split_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lengths), sm_scale=1 / np.sqrt(D),
                                n_split=n_split).numpy()
    want_pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths).reshape(B, 1),
        sm_scale=1 / np.sqrt(D), bk=bk, interpret=True))
    np.testing.assert_allclose(got, want_pallas, rtol=2e-6, atol=2e-6)
    want_ref = np.asarray(jref.decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lengths).reshape(B, 1),
                                          sm_scale=1 / np.sqrt(D)))
    live = lengths > 0
    np.testing.assert_allclose(got[live], want_ref[live], rtol=2e-6, atol=2e-6)
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("S,D", [(64, 64), (300, 128)])
def test_bf16_hi_lo_split_keeps_p_in_f32(S, D):
    """P_hi + P_lo carries a probability row to 2^-16 relative, so an output
    computed through `mha_ref`'s arithmetic with the split P stays within
    2e-5 of the f32-P output; P rounded once to bf16 does not.  This is why
    the bf16 flash kernel pays for two PV products."""
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.standard_normal((1, 2, S, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, S, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, S, D)).astype(np.float32))
    v = v.to(torch.bfloat16).to(torch.float32)           # the kernel's V is bf16
    s = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(D)
    s = torch.where(torch.tril(torch.ones((S, S), dtype=torch.bool)), s, kref.ATTN_NEG)
    p = torch.softmax(s, dim=-1)
    hi, lo = kref.bf16_hi_lo(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    p2 = hi.to(torch.float32) + lo.to(torch.float32)
    assert torch.all((p2 - p).abs() <= 2.0 ** -16 * p.abs())
    want = torch.matmul(p, v)
    split = torch.matmul(hi.to(torch.float32), v) + torch.matmul(lo.to(torch.float32), v)
    once = torch.matmul(hi.to(torch.float32), v)
    assert float((split - want).abs().max()) <= 2e-5
    assert float((once - want).abs().max()) > 2e-5
    torch.testing.assert_close(
        split, kref.mha_ref(q, k, v, sm_scale=1 / np.sqrt(D)), rtol=2e-5, atol=2e-5)


def test_flash_attention_plain_causal_bottom_right_sq_lt_sk():
    """Causal attention with fewer queries than keys: the port's mask is
    bottom-right (``tril(k=Sk - Sq)``, the queries are the last Sq
    positions), as the reference oracle `mha_ref` has it."""
    (jq, jk, jv), (q, k, v) = _attn_operands(
        [(1, 2, 64, 32), (1, 2, 128, 32), (1, 2, 128, 32)], "float32", 64)
    got = ops.flash_attention(q, k, v, causal=True)
    want = jref.mha_ref(jq, jk, jv, sm_scale=1 / np.sqrt(32), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_padded_head_matches_unpadded_at_d8(kind):
    """The head-width padding the wrappers apply on the card, run on the
    plain versions: zero-padding D = 8 to 16 with the scale of the
    original D gives the unpadded result."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 40, 8), (2, 2, 40, 8), (2, 2, 40, 8)))
    scale = 1 / np.sqrt(8)
    assert flash_attention.padded_head_dim(8) == 16
    if kind == "flash":
        def fn(q_, k_, v_):
            return kref.mha_ref(q_, k_, v_, sm_scale=scale, causal=True)
        args = (q, k, v)
    else:
        lengths = torch.tensor([[7], [40]])

        def fn(q_, k_, v_):
            return kref.decode_ref(q_, k_, v_, lengths, sm_scale=scale)
        args = (q[:, :, 0].reshape(2, 2, 2, 8).contiguous(), k, v)
    got = ops.with_padded_head(fn, *args, width=16)
    want = fn(*args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.padded_head_dim(160)
