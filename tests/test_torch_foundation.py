"""Foundation of the PyTorch port against the JAX reference, on the CPU.

Dataset, BM25 corpora, QoS terms and quantization of `repro_torch` are fed
the same numpy inputs as their twins in `repro`.  Pools, corpus weights and
bf16 rounding must be byte-equal; QoS scores agree within the port's
parity tolerance (rtol 2e-6, atol 2e-7: sums taken in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bm25 as jbm25
from repro.core import dataset as jdataset
from repro.core import qos as jqos
from repro.core import quantize as jquantize
from repro.kernels import ops as jops
from repro_torch.core import bm25, dataset, qos, quantize

RTOL, ATOL = 2e-6, 2e-7


def _asdicts(items):
    return [dataclasses.asdict(x) for x in items]


@pytest.mark.parametrize("seed", [0, 3])
def test_pools_and_queries_equal_reference(seed):
    pool = dataset.build_server_pool(seed)
    assert _asdicts(pool) == _asdicts(jdataset.build_server_pool(seed))
    for n_per in (1, 4):
        assert _asdicts(dataset.mock_cluster(pool, n_per, seed=seed)) == _asdicts(
            jdataset.mock_cluster(jdataset.build_server_pool(seed), n_per, seed=seed)
        )
    assert _asdicts(dataset.build_query_dataset(n=70, seed=seed)) == _asdicts(
        jdataset.build_query_dataset(n=70, seed=seed)
    )


def _docs():
    pool = dataset.build_server_pool(0)
    servers = dataset.mock_cluster(pool, 3)
    server_docs = [s.description for s in servers]
    tool_docs = [f"{t.name.replace('_', ' ')} {t.description}" for s in servers for t in s.tools]
    return server_docs, tool_docs


@pytest.mark.parametrize("which", ["servers", "tools", "tiled", "empty"])
def test_corpus_weights_byte_equal(which):
    server_docs, tool_docs = _docs()
    if which == "tiled":
        counts = list(range(1, len(server_docs[:15]) + 1))
        a = bm25.build_corpus_tiled(server_docs[:15], counts)
        b = jbm25.build_corpus_tiled(server_docs[:15], counts)
    else:
        docs = {"servers": server_docs, "tools": tool_docs, "empty": ["", "..."]}[which]
        a, b = bm25.build_corpus(docs), jbm25.build_corpus(docs)
    assert a.vocab == b.vocab and a.n_docs == b.n_docs
    assert a.weights.dtype == b.weights.dtype == np.float32
    assert a.weights.tobytes() == b.weights.tobytes()
    for text in ("search the web for live news", "refactor a function", ""):
        assert bm25.tokenize(text) == jbm25.tokenize(text)
        assert a.encode_query(text).tobytes() == b.encode_query(text).tobytes()


def test_bm25_scores_rows_tie_exactly_and_match_reference():
    rng = np.random.default_rng(0)
    w = (rng.random((11, 37)) * (rng.random((11, 37)) < 0.4)).astype(np.float32)
    w[3:] = w[2]                                  # identical replica rows
    q = rng.poisson(0.8, (6, 37)).astype(np.float32)
    got = bm25.bm25_scores(torch.from_numpy(w), torch.from_numpy(q)).numpy()
    want = np.asarray(jbm25.bm25_scores(jnp.asarray(w), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:, 3:] == got[:, 2:3])


def test_topk_breaks_ties_toward_lower_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = bm25.topk(s, 4)
    assert idx.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]
    assert vals[0].tolist() == [3.0, 3.0, 3.0, 2.0]
    j_vals, j_idx = jbm25.topk(jnp.asarray(s.numpy()), 4)
    assert np.array_equal(np.asarray(j_idx), idx.numpy())


def _windows(n, T, seed, kind):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(5.0, 400.0, (n, T)).astype(np.float32)
    if kind in ("offline", "mixed"):
        lat[::3, -1] = 1000.0 + rng.uniform(0, 500, len(lat[::3]))
        lat[1, -1] = 1000.0                     # exactly at the clamp
    if kind in ("spikes", "mixed"):
        lat[1::2, -min(T, 6):] = 850.0 + rng.uniform(0, 300, (len(lat[1::2]), min(T, 6)))
    if kind == "ideal":
        lat[:] = 30.0                           # inside the band: N = 1 exactly
    return lat


@pytest.mark.parametrize(
    "n,T,kind,bf16",
    [
        (9, 20, "mixed", False),      # T < window
        (13, 32, "ideal", False),     # T == window, saturated score
        (7, 130, "offline", False),   # T not a multiple of 128
        (6, 64, "spikes", False),
        (5, 1, "mixed", False),       # a single sample
        (8, 48, "mixed", True),       # bf16 windows
    ],
)
def test_network_score_matches_reference_and_kernel(n, T, kind, bf16):
    lat = _windows(n, T, seed=T, kind=kind)
    if bf16:
        lat = jquantize.quantize_bf16(lat)
        t_lat = torch.from_numpy(lat).to(torch.bfloat16)
        j_lat = jnp.asarray(lat, jnp.bfloat16)
    else:
        t_lat, j_lat = torch.from_numpy(lat), jnp.asarray(lat)
    got = qos.network_score(t_lat).numpy()
    np.testing.assert_allclose(got, np.asarray(jqos.network_score(j_lat)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.qos_scores(jnp.asarray(lat, jnp.float32), interpret=True)),
        rtol=RTOL, atol=ATOL,
    )
    assert np.all(got[lat[:, -1] >= 1000.0] == -1.0)
    for a, b in zip(qos.penalties(t_lat), jqos.penalties(j_lat)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_network_score_custom_params():
    p = qos.QosParams(window=8, ewma_alpha=0.5, ideal_high_ms=80.0, w_outage=0.5)
    jp = jqos.QosParams(window=8, ewma_alpha=0.5, ideal_high_ms=80.0, w_outage=0.5)
    lat = _windows(10, 24, seed=1, kind="mixed")
    np.testing.assert_allclose(
        qos.network_score(torch.from_numpy(lat), p).numpy(),
        np.asarray(jqos.network_score(jnp.asarray(lat), jp)), rtol=RTOL, atol=ATOL,
    )
    # per-query windows [n_q, n_servers, T] score row by row
    lat3 = np.stack([lat, lat[::-1]])
    np.testing.assert_allclose(
        qos.network_score(torch.from_numpy(lat3), p).numpy(),
        np.asarray(jqos.network_score(jnp.asarray(lat3), jp)), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("shape", [(17,), (3, 11)])
def test_staleness_rtt_load_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    age = rng.uniform(-10.0, 900.0, shape).astype(np.float32)
    age.flat[0] = 0.0
    rtt = rng.uniform(-5.0, 400.0, shape).astype(np.float32)
    rho = rng.uniform(-0.5, 2.5, shape).astype(np.float32)
    np.testing.assert_allclose(
        qos.staleness_discount(torch.from_numpy(age), 120.0).numpy(),
        np.asarray(jqos.staleness_discount(jnp.asarray(age), 120.0)), rtol=RTOL, atol=ATOL,
    )
    assert qos.staleness_discount(torch.zeros(3)).tolist() == [1.0, 1.0, 1.0]
    np.testing.assert_array_equal(
        qos.rtt_penalty(torch.from_numpy(rtt), 150.0).numpy(),
        np.asarray(jqos.rtt_penalty(jnp.asarray(rtt), 150.0)),
    )
    np.testing.assert_array_equal(
        qos.load_penalty(torch.from_numpy(rho), 0.75, 4.0).numpy(),
        np.asarray(jqos.load_penalty(jnp.asarray(rho), 0.75, 4.0)),
    )


def test_quantize_bf16_bit_equal_to_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 100,
        # exact ties between two bf16 neighbours (round half to even)
        (np.arange(1, 200, dtype=np.uint32) * 0x10000 + 0x8000).view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e38, 3.4e38], np.float32),
    ])
    got, want = quantize.quantize_bf16(x), jquantize.quantize_bf16(x)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    nan = quantize.quantize_bf16(np.array([np.nan], np.float32))
    assert np.isnan(nan).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_round_weights_match_reference(dtype):
    rng = np.random.default_rng(1)
    w = (rng.random((9, 33)) * 4).astype(np.float32)
    w[2] = 0.0
    assert quantize.round_weights(w, dtype).tobytes() == jquantize.round_weights(w, dtype).tobytes()
    q, s = quantize.quantize_int8_rows(w)
    jq, js = jquantize.quantize_int8_rows(w)
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    with pytest.raises(ValueError):
        quantize.round_weights(w, "fp8")
