"""The port's MoE FFN and DeepSeek-MoE's dense prelude (`repro_torch.models`)
against the JAX reference, on the CPU.

Both sides run the reference's random weights (carried over by
`convert.lm_params_from_arrays`) on the same numpy inputs, drawn from fixed
seeds.  The dispatch must agree exactly in its integer outputs (``slot``,
``token_of``) and within rtol = atol = 1e-6 in float32 (``buf``,
``w_keep``), with drops (capacity factor 0.5) and with tied router
probabilities (duplicated router columns: `jax.lax.top_k` puts the lower
expert first, the port's stable descending sort does too).  The layer's
``(y, aux)`` agree within 1e-5 in float32 and 2e-2 in bfloat16, the whole
model within `tests/test_torch_models.py`'s tolerances (the bf16 logits'
atol taken relative to their largest magnitude, each bf16 decode step
started from the reference's cache), and `ServeEngine`'s greedy tokens
equal the JAX engine's in float32.  The invariants of `tests/test_moe.py`
are run on the port's own weights over fixed seeds.  Only reduced configs
build parameters here; the full configs are checked by their fields and
`param_counts`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro.models.api import get_model as jget_model
from repro.models.config import ModelConfig as JModelConfig
from repro.nn.core import InitCtx as JInitCtx
from repro.nn.core import unzip
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.engine import pad_cache_to_capacity as jpad
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models import mlp
from repro_torch.models.api import get_model
from repro_torch.nn import core as nn
from repro_torch.serving.engine import Request, ServeEngine, pad_cache_to_capacity

MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _moe_cfg(E=8, K=2, shared=0, cf=1.25, dtype="float32"):
    """tests/test_moe.py's layer config, as (reference cfg, port cfg)."""
    jcfg = JModelConfig(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=128, n_experts=E, experts_per_token=K,
        n_shared_experts=shared, moe_d_ff=16, capacity_factor=cf, dtype=dtype,
    )
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


def _ref_layer(jcfg, seed=0, tie=False):
    """The reference's MoE layer weights (jax tree, port tree on the CPU);
    ``tie`` copies the first half of the router's columns onto the second,
    so every expert has a twin of equal probability."""
    p, _ = unzip(jmlp.moe_ffn_init(JInitCtx(key=jax.random.PRNGKey(seed), dtype=jcfg.jdtype),
                                   jcfg))
    if tie:
        half = jcfg.n_experts // 2
        p["router"] = p["router"].at[:, half:2 * half].set(p["router"][:, :half])
    return p, lm_params_from_arrays(jax.tree.map(np.asarray, p), "cpu")


# the reference's functions compiled once per config (eager JAX runs each
# small op on its own and takes seconds a call)
_jdispatch = jax.jit(jmlp._moe_dispatch, static_argnums=(1, 3))
_jmoe = jax.jit(jmlp.moe_ffn_apply, static_argnums=(1,))


def _x(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# dispatch against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_equals_reference(factor):
    for T in (1, 2, 7, 16, 33, 100, 1536, 2048):
        for k in (1, 2, 6):
            for E in (1, 4, 16, 64):
                assert mlp._capacity(T, k, E, factor) == jmlp._capacity(T, k, E, factor), \
                    (T, k, E, factor)


@pytest.mark.parametrize("case", [
    dict(E=8, K=2, cf=1.25), dict(E=8, K=2, cf=0.5), dict(E=4, K=1, cf=0.5),
    dict(E=8, K=3, cf=1.25, tie=True), dict(E=8, K=2, cf=0.5, tie=True),
    dict(E=16, K=6, cf=1.25, tie=True),
], ids=["base", "drops", "top1-drops", "ties", "ties-drops", "e16k6-ties"])
def test_dispatch_equals_reference(case):
    jcfg, cfg = _moe_cfg(E=case["E"], K=case["K"], cf=case["cf"])
    jp, p = _ref_layer(jcfg, seed=case["E"] + case["K"], tie=case.get("tie", False))
    rng = np.random.default_rng(11)
    T = 64
    jx, x = _x(rng, (3, T, cfg.d_model), "float32")
    C = mlp._capacity(T, cfg.experts_per_token, cfg.n_experts, cfg.capacity_factor)
    buf, slot, token_of, w_keep, aux = mlp._moe_dispatch(p, cfg, x, C)
    kept = 0
    for b in range(3):
        jbuf, jslot, jtok, jw, jaux = _jdispatch(jp, jcfg, jx[b], C)
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(token_of[b].numpy(), np.asarray(jtok))
        np.testing.assert_allclose(buf[b].numpy(), np.asarray(jbuf), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(w_keep[b].numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(aux[b]), float(jaux), rtol=1e-6, atol=1e-6)
        kept += int((np.asarray(jw) > 0).sum())
    if case["cf"] < 1:
        assert kept < 3 * T * cfg.experts_per_token          # the case really drops
    if case.get("tie"):
        _, _, sel = mlp._route(p, cfg, x)
        half = cfg.n_experts // 2
        # a twin pair is chosen together, the lower index first
        assert (sel[..., 0] < half).all()


# ---------------------------------------------------------------------------
# tests/test_moe.py's invariants, on the port's own weights
# ---------------------------------------------------------------------------

def _port_layer(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = mlp.moe_ffn_init(nn.InitCtx(gen=gen, dtype=torch.float32), cfg, 1)
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
            for k, v in p.items()}


@pytest.mark.parametrize("seed,T,E,K", [
    (0, 4, 4, 1), (1, 40, 8, 2), (2, 17, 4, 2), (3, 9, 8, 1),
    (4, 33, 8, 2), (5, 40, 4, 1), (6, 5, 8, 2), (7, 28, 4, 2),
])
def test_dispatch_invariants(seed, T, E, K):
    _, cfg = _moe_cfg(E=E, K=K)
    p = _port_layer(cfg, seed % 7)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, T, cfg.d_model)).astype(np.float32))
    C = mlp._capacity(T, K, E, cfg.capacity_factor)
    buf, slot, token_of, w_keep, aux = mlp._moe_dispatch(p, cfg, x, C)
    slot, token_of, w_keep = slot[0].numpy(), token_of[0].numpy(), w_keep[0].numpy()
    assert buf.shape == (1, E, C, cfg.d_model)
    assert ((slot >= 0) & (slot < E * C)).all()
    assert ((token_of >= 0) & (token_of < T)).all()
    w = np.zeros(T)
    np.add.at(w, token_of, w_keep)
    assert (w_keep >= 0).all()
    assert (w <= 1.0 + 1e-5).all()
    occup = np.bincount(slot[w_keep > 0] // C, minlength=E)
    assert (occup <= C).all()
    assert np.isfinite(float(aux[0]))


def test_no_drops_at_high_capacity():
    _, cfg = _moe_cfg(E=4, K=2, cf=8.0)
    p = _port_layer(cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, cfg.d_model))
                         .astype(np.float32))
    C = mlp._capacity(16, 2, 4, 8.0)
    _, _, token_of, w_keep, _ = mlp._moe_dispatch(p, cfg, x, C)
    for b in range(2):
        tot = np.zeros(16)
        np.add.at(tot, token_of[b].numpy(), w_keep[b].numpy())
        np.testing.assert_allclose(tot, 1.0, rtol=1e-5)


def test_moe_matches_dense_when_one_expert():
    """E=1, K=1, no drops: the MoE layer is its single expert run densely."""
    _, cfg = _moe_cfg(E=1, K=1, cf=4.0)
    p = _port_layer(cfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    y, aux = mlp.moe_ffn_apply(p, cfg, x)
    ref = nn.swiglu(x, p["w_gate"][0], p["w_up"][0], p["w_down"][0])
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def test_shared_experts_always_active():
    _, cfg = _moe_cfg(E=4, K=1, shared=2)
    p = _port_layer(cfg)
    assert p["shared"]["w_gate"].shape == (cfg.d_model, 2 * cfg.moe_d_ff)
    y0, _ = mlp.moe_ffn_apply(p, cfg, torch.zeros((1, 4, cfg.d_model)))
    y1, _ = mlp.moe_ffn_apply(p, cfg, torch.ones((1, 4, cfg.d_model)))
    assert not torch.allclose(y0, y1)
    no_routed = dict(p, w_down=torch.zeros_like(p["w_down"]))
    y_shared, _ = mlp.moe_ffn_apply(no_routed, cfg, torch.ones((1, 4, cfg.d_model)))
    torch.testing.assert_close(y_shared, mlp.dense_ffn_apply(p["shared"],
                                                             torch.ones((1, 4, cfg.d_model))))


# ---------------------------------------------------------------------------
# the layer and the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(E=8, K=2, shared=2, cf=1.25), dict(E=4, K=1, shared=1, cf=1.25),
    dict(E=8, K=2, shared=0, cf=0.5), dict(E=8, K=3, shared=1, cf=1.25, tie=True),
], ids=["deepseek-like", "scout-like", "drops", "ties"])
def test_moe_ffn_apply_matches_reference(case, dtype):
    jcfg, cfg = _moe_cfg(E=case["E"], K=case["K"], shared=case["shared"], cf=case["cf"],
                         dtype=dtype)
    jp, p = _ref_layer(jcfg, seed=3, tie=case.get("tie", False))
    rng = np.random.default_rng(12)
    jx, x = _x(rng, (2, 20, cfg.d_model), dtype)
    jy, jaux = _jmoe(jp, jcfg, jx)
    y, aux = mlp.moe_ffn_apply(p, cfg, x)
    assert y.dtype == cfg.torch_dtype and y.shape == (2, 20, cfg.d_model)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(y), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mlp.ffn_apply({"moe": p}, cfg, x), (y, aux), rtol=0, atol=0)


_MODELS: dict = {}


def _model(arch, dtype):
    """(reference cfg, reference params, port cfg, port params) of a reduced
    MoE config."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype)
        jp, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        cfg = model_config_from_dict(dataclasses.asdict(jcfg))
        _MODELS[key] = (jcfg, jp, cfg, lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[key]


def _close(got, want, dtype, what):
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _port_cache(jcache):
    """The reference's cache tree as port tensors, (k, v) pairs kept as
    tuples (prelude entries included)."""
    if isinstance(jcache, dict):
        return {k: _port_cache(v) for k, v in jcache.items()}
    return tuple(lm_params_from_arrays({"t": np.asarray(t)}, "cpu")["t"] for t in jcache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """`Model.prefill` of a [2, 20] prompt, then four `decode_step`s: logits
    and caches (the prelude's included) agree."""
    jcfg, jp, cfg, p = _model(arch, dtype)
    jm, m = jget_model(jcfg), get_model(cfg)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and lg.dtype == torch.float32
    assert set(c) == set(jc) == ({"prelude_0", "groups"} if cfg.first_k_dense else {"groups"})
    _close(lg, jl, dtype, "prefill logits")
    for name in set(c) - {"groups"}:
        _close(c[name][0], jc[name][0], dtype, f"{name} k cache")
    jc, c = jpad(jc, jm.cache_axes(), 32), pad_cache_to_capacity(c, m.cache_axes(), 32)
    clen = 20
    for step in range(4):
        if dtype == "bfloat16":
            c = _port_cache(jc)
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nt), jnp.int32(clen))
        lg, c = m.decode_step(p, c, torch.from_numpy(nt), clen)
        _close(lg, jl, dtype, f"decode step {step} logits")
        for name in c:
            want = jc[name]["l0"] if name == "groups" else jc[name]
            got = c[name]["l0"] if name == "groups" else c[name]
            _close(got[1], want[1], dtype, f"{name} v cache after step {step}")
        clen += 1


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_match_reference(arch, impl):
    """Five requests of 3 to 11 tokens through 2 slots, float32: the port's
    `ServeEngine` generates the JAX engine's tokens (the prelude's cache and
    the per-row dispatch of the decode slots included)."""
    jcfg, jp, cfg, p = _model(arch, "float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (11, 4, 3, 9, 6)]
    max_new = [3 + i % 3 for i in range(5)]
    jeng = JServeEngine(jget_model(jcfg), jp, n_slots=2, cap=32)
    eng = ServeEngine(get_model(dataclasses.replace(cfg, attn_impl=impl)), p, n_slots=2, cap=32,
                      device="cpu")
    jreqs = [JRequest(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    assert eng.run() == jeng.run()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in reqs)
    if cfg.first_k_dense:
        assert eng.cache["prelude_0"][0].shape == (2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_lm_params_from_arrays_carries_moe_tree():
    """The reference's bf16 deepseek tree (prelude_0, router, experts,
    shared experts) arrives leaf for leaf: the same paths, shapes and bits."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("deepseek-moe-16b"), dtype="bfloat16")
    params, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, params)
    port = lm_params_from_arrays(host, "cpu")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(host)]
    assert paths == [jax.tree_util.keystr(k)
                     for k, _ in jax.tree_util.tree_leaves_with_path(port)]
    assert any("prelude_0" in s and "dense" in s for s in paths)
    assert sum("['moe']" in s for s in paths) == 7      # router, 3 experts, 3 shared
    for a, t in zip(jax.tree.leaves(host), jax.tree.leaves(port)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_configs_are_served(arch):
    """The full MoE configs pass the port's checks without building weights:
    the fields, the per-layer FFN kinds and the parameter counts are the
    reference's, and the layer count a full model needs adds up."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    model = get_model(cfg)                               # no longer refused
    assert model.cfg is cfg and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] == \
        [jcfg.layer_is_moe(i) for i in range(jcfg.n_layers)]
    counts = cfg.param_counts()
    assert counts == jcfg.param_counts()
    axes = model.cache_axes()
    assert set(axes) == {f"prelude_{i}" for i in range(cfg.first_k_dense)} | {"groups"}
    if arch == "deepseek-moe-16b":
        assert 16.0e9 < counts["total"] < 16.8e9 and cfg.ffn_hidden(0) == 10944
        assert axes["prelude_0"][0] == ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    else:
        assert not cfg.first_k_dense and cfg.n_heads // cfg.n_kv_heads == 5
