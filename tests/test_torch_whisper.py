"""The port's encoder-decoder (`repro_torch.models.whisper`) and the
cross-attention and non-causal branches of `models.attention` against the
JAX reference, on the CPU.

Both sides run the reduced whisper config (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, 24 audio frames) with the reference's random
weights carried over by `convert.lm_params_from_arrays`, on the same numpy
frames and tokens.  The port runs ``naive``, ``chunked`` (chunks of 8
rows, so the 20-token prompts and the 24 frames really chunk) and
``pallas`` (on the CPU the kernels' plain versions, P kept in f32); a
layer is held to the reference's ``naive`` path, the whole model to the
reference's Pallas flash kernel (interpret mode) under ``pallas`` and to
its ``naive`` path otherwise.  Tolerances: rtol = atol = 1e-5 in float32 and
2e-2 in bfloat16 for a layer, the bf16 logits' atol taken relative to
their largest magnitude as in `tests/test_torch_models.py` (a P entry that
rounds to the other bf16 neighbour moves every logit through the head).
Under ``pallas`` in bf16 the port's decode keeps P in f32, so it is held to
the reference's decode with its own flash-decode kernel in place of the
grouped einsums (`_jax_kernel_decode`, monkeypatched for the one test), and
each bf16 decode step starts from the reference's cache.  The engines
serve in float32 and their greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import whisper as jwhisper
from repro.models.api import get_model as jget_model
from repro.nn import core as jnn
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.engine import pad_cache_to_capacity as jpad
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models import attention, whisper
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServeEngine, pad_cache_to_capacity

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")
IMPLS = ("naive", "chunked", "pallas")
ARCH = "whisper-tiny"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _close(got, want, dtype, what="", logits=False):
    tol = dict(TOL[dtype])
    if logits and dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _pair(dtype, impl="naive", ref_impl="naive"):
    """(reference cfg on ``ref_impl``, port cfg on ``impl``), chunk 8."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype, attn_chunk=8)
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    return dataclasses.replace(jcfg, attn_impl=ref_impl), dataclasses.replace(cfg, attn_impl=impl)


_PARAMS: dict = {}


def _params(dtype):
    """The reference's random weights of the reduced config as (jax tree,
    port tree on the CPU)."""
    if dtype not in _PARAMS:
        jcfg, _ = _pair(dtype)
        params = jax.jit(lambda key: jget_model(jcfg).init_params(key)[0])(
            jax.random.PRNGKey(0))
        _PARAMS[dtype] = (params, lm_params_from_arrays(jax.tree.map(np.asarray, params), "cpu"))
    return _PARAMS[dtype]


_REF: dict = {}


def _ref_model(dtype, ref_impl):
    """The reference model on ``ref_impl`` with its jitted prefill and
    decode_step, compiled once per (dtype, path) and shared by the tests."""
    if (dtype, ref_impl) not in _REF:
        jm = jget_model(_pair(dtype, ref_impl=ref_impl)[0])
        _REF[dtype, ref_impl] = (jm, jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _REF[dtype, ref_impl]


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _x(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _jax_kernel_decode(p, cfg, x, cache, cache_len, cross=False):
    """The reference's `attn_decode` with its flash-decode kernel in place of
    the grouped einsums, self and cross: the JAX counterpart of the port's
    ``pallas`` decode."""
    B = x.shape[0]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    kc, vc = cache
    q = jnn.dense(x, p["wq"], p.get("bq")).reshape(B, 1, nq, hd)
    valid = cache_len
    if not cross:
        k_new = jnn.dense(x, p["wk"], p.get("bk")).reshape(B, 1, nkv, hd)
        v_new = jnn.dense(x, p["wv"], p.get("bv")).reshape(B, 1, nkv, hd)
        pos = jnp.full((B, 1), cache_len, dtype=jnp.int32)
        q = jattn.apply_rope(q, pos, cfg.rope_theta)
        k_new = jattn.apply_rope(k_new, pos, cfg.rope_theta)
        kc = jax.lax.dynamic_update_slice(kc, k_new.astype(kc.dtype), (0, cache_len, 0, 0))
        vc = jax.lax.dynamic_update_slice(vc, v_new.astype(vc.dtype), (0, cache_len, 0, 0))
        valid = cache_len + 1
    lengths = jnp.full((B,), valid, jnp.int32)
    o = jops.decode_attention(q.reshape(B, nq, hd), kc.transpose(0, 2, 1, 3),
                              vc.transpose(0, 2, 1, 3), lengths)
    y = jnn.dense(o.reshape(B, 1, nq * hd).astype(x.dtype), p["wo"])
    return y, (kc, vc)


@pytest.mark.parametrize("n,d", [(1, 2), (24, 64), (448, 64), (1500, 384)])
def test_sinusoidal_pos_bit_for_bit(n, d):
    got = whisper.sinusoidal_pos(n, d)
    want = np.asarray(jwhisper.sinusoidal_pos(n, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_apply_cross_and_non_causal_match_reference(dtype, impl):
    """The encoder's non-causal self-attention (RoPE on q and k, Sq = Sk =
    24) and the decoder's cross-attention (20 queries against 24 memory
    rows, no RoPE, no bias) against the reference's naive path."""
    jcfg, cfg = _pair(dtype, impl)
    jp, p = _params(dtype)
    rng = np.random.default_rng(2)
    F = cfg.n_audio_frames
    jx, x = _x(rng, (2, F, cfg.d_model), dtype)
    jenc, enc = _layer0(jp["enc_blocks"]["attn"]), _layer0(p["enc_blocks"]["attn"])
    jy, (jk, _) = jattn.attn_apply(jenc, jcfg, jx, jnp.arange(F), causal=False, return_cache=True)
    y, (k, _) = attention.attn_apply(enc, cfg, x, torch.arange(F), causal=False)
    _close(y, jy, dtype, f"{impl} encoder y")
    _close(k, jk, dtype, "encoder k")
    jcross, cross = _layer0(jp["dec_blocks"]["cross_attn"]), _layer0(p["dec_blocks"]["cross_attn"])
    assert "bq" not in cross and set(cross) == set(jcross)
    jq, q = _x(rng, (2, 20, cfg.d_model), dtype)
    jy, (jk, jv) = jattn.attn_apply(jcross, jcfg, jq, jnp.arange(20), causal=False, kv=jx,
                                    return_cache=True)
    y, (k, v) = attention.attn_apply(cross, cfg, q, torch.arange(20), causal=False, kv=x)
    assert y.shape == (2, 20, cfg.d_model) and k.shape == (2, F, cfg.n_kv_heads, 16)
    _close(y, jy, dtype, f"{impl} cross y")
    _close(k, jk, dtype, "cross k")
    _close(v, jv, dtype, "cross v")


@pytest.mark.parametrize("impl", ("naive", "pallas"))
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_decode_cross_matches_reference(dtype, impl):
    """Cross-attention decode over the full static cache (cache_len = F):
    nothing written, the output equal to the reference's (its kernel under
    ``pallas`` in bf16); a cache_len outside [1, F] is refused."""
    jcfg, cfg = _pair(dtype, impl)
    jp, p = _params(dtype)
    jpa, pa = _layer0(jp["dec_blocks"]["cross_attn"]), _layer0(p["dec_blocks"]["cross_attn"])
    rng = np.random.default_rng(3)
    F, hd, nkv = cfg.n_audio_frames, cfg.resolved_head_dim, cfg.n_kv_heads
    cache_np = rng.standard_normal((2, 3, F, nkv, hd)).astype(np.float32)
    jx, x = _x(rng, (3, 1, cfg.d_model), dtype)
    jcache = tuple(jnp.asarray(c, jcfg.jdtype) for c in cache_np)
    cache = tuple(torch.from_numpy(c.copy()).to(cfg.torch_dtype) for c in cache_np)
    before = [c.clone() for c in cache]
    ref = _jax_kernel_decode if (impl, dtype) == ("pallas", "bfloat16") else jattn.attn_decode
    for n in (F, 7):
        jy, _ = ref(jpa, jcfg, jx, jcache, jnp.int32(n), cross=True)
        y, (k, v) = attention.attn_decode(pa, cfg, x, cache, n, cross=True)
        _close(y, jy, dtype, f"{impl} cross decode y at {n}")
    assert all(torch.equal(a, b) for a, b in zip(cache, before))
    for bad in (0, F + 1):
        with pytest.raises(ValueError, match="cache_len"):
            attention.attn_decode(pa, cfg, x, cache, bad, cross=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    jcfg, cfg = _pair(dtype)
    jp, p = _params(dtype)
    frames = np.random.default_rng(4).standard_normal((2, cfg.n_audio_frames, cfg.d_model))
    frames = frames.astype(np.float32)
    want = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    got = whisper.encode(p, cfg, torch.from_numpy(frames))
    assert got.dtype == cfg.torch_dtype and got.shape == (2, cfg.n_audio_frames, cfg.d_model)
    _close(got, want, dtype, "encoder output")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_reference(dtype, impl, monkeypatch):
    """`Model.prefill` of [2, 20] tokens against [2, 24] frames (logits,
    self and cross caches), then three `decode_step`s at growing cache_len
    (the self cache written in place, the cross cache untouched): logits
    and caches agree.  The reference runs its Pallas flash kernel (interpret
    mode) under ``pallas`` and its naive path otherwise (the chunked path
    computes each row as the naive one does).  In float32 the port runs on
    its own cache; in bfloat16 each step starts from the reference's."""
    _, cfg = _pair(dtype, impl)
    jp, p = _params(dtype)
    if (impl, dtype) == ("pallas", "bfloat16"):
        monkeypatch.setattr(jattn, "attn_decode", _jax_kernel_decode)
    jm, jprefill, jdecode = _ref_model(dtype, "pallas" if impl == "pallas" else "naive")
    m = get_model(cfg)
    rng = np.random.default_rng(5)
    F = cfg.n_audio_frames
    frames = rng.standard_normal((2, F, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and lg.dtype == torch.float32
    _close(lg, jl, dtype, "prefill logits", logits=True)
    for part in ("self", "cross"):
        for i in (0, 1):
            assert c["dec"][part][i].shape == jc["dec"][part][i].shape
            _close(c["dec"][part][i], jc["dec"][part][i], dtype, f"prefill {part} cache {i}")
    cap = 23
    jc, c = jpad(jc, jm.cache_axes(), cap), pad_cache_to_capacity(c, m.cache_axes(), cap)
    assert c["dec"]["cross"][0].shape[2] == F and c["dec"]["self"][0].shape[2] == cap
    cross = c["dec"]["cross"][0].clone()
    clen = 20
    for step in range(3):
        if dtype == "bfloat16":
            c = jax.tree.map(lambda a: lm_params_from_arrays({"t": np.asarray(a)}, "cpu")["t"],
                             jc)
            cross = c["dec"]["cross"][0].clone()
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nt), jnp.int32(clen))
        lg, c = m.decode_step(p, c, torch.from_numpy(nt), clen)
        _close(lg, jl, dtype, f"decode step {step} logits", logits=True)
        _close(c["dec"]["self"][1], jc["dec"]["self"][1], dtype, f"self v after step {step}")
        assert torch.equal(c["dec"]["cross"][0], cross)
        clen += 1


def test_forward_modes_and_cache_layout():
    jcfg0, cfg = _pair("float32")
    m = get_model(cfg)
    jp, p = _params("float32")
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = jwhisper.whisper_forward(jp, jcfg0, {"frames": jnp.asarray(frames),
                                                "tokens": jnp.asarray(tokens)}, "train")[0]
    got, aux = whisper.whisper_forward(p, cfg, {"frames": torch.from_numpy(frames),
                                                "tokens": torch.from_numpy(tokens)}, "train")
    assert got.shape == (2, 9, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, "float32", "train logits at every position", logits=True)
    with pytest.raises(ValueError, match="unknown mode"):
        whisper.whisper_forward(p, cfg, {"tokens": torch.from_numpy(tokens)}, "score")
    cache = m.init_cache(3, 20, device="cpu")
    L, F, H, hd = cfg.n_layers, cfg.n_audio_frames, cfg.n_kv_heads, cfg.resolved_head_dim
    assert cache["dec"]["self"][0].shape == (L, 3, 20, H, hd)
    assert cache["dec"]["cross"][1].shape == (L, 3, F, H, hd)
    jcfg, _ = _pair("float32")
    assert m.cache_axes() == jax.tree.map(
        lambda a: a, jwhisper.whisper_cache_axes(jcfg),
        is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(i, str) for i in x))


def test_port_initialiser_tree_and_std():
    """The port's own random weights: the reference's tree and shapes, the
    cross-attention layers without biases even under ``qkv_bias``, drawn in
    the reference's distributions, reproducibly from the seed."""
    jcfg, cfg = _pair("float32")
    ref = jax.tree.map(lambda a: a.shape,
                       jget_model(jcfg).init_params(jax.random.PRNGKey(0), abstract=True)[0])
    params = get_model(cfg).init_params(seed=3, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == ref
    again = get_model(cfg).init_params(seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    d = cfg.d_model
    for t, std in ((params["embed"], 0.02), (params["head"], d ** -0.5),
                   (params["enc_blocks"]["attn"]["wq"], d ** -0.5),
                   (params["dec_blocks"]["cross_attn"]["wk"], d ** -0.5),
                   (params["dec_blocks"]["ffn"]["w_down"], cfg.d_ff ** -0.5)):
        assert abs(float(t.std()) / std - 1.0) < 0.1
    for name in ("enc_norm", "dec_norm"):
        assert torch.equal(params[name], torch.ones(d))
    biased = dataclasses.replace(cfg, qkv_bias=True)
    bp = get_model(biased).init_params(seed=3, device="cpu")["dec_blocks"]
    assert "bq" in bp["self_attn"] and "bq" not in bp["cross_attn"]


_ENGINE: dict = {}


def _engine_models():
    """The f32 reference model, its weights on both sides, five requests
    (prompts of 2, 5 and 9 tokens, 3 to 5 new tokens, each with its own frames)
    and the JAX `ServeEngine`'s run of them through 2 slots of cap 20."""
    if not _ENGINE:
        jcfg, cfg = _pair("float32")
        jm = jget_model(jcfg)
        jp, p = _params("float32")
        rng = np.random.default_rng(6)
        news = [3, 5, 4, 3, 5]
        reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 rng.standard_normal((cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
                for n in (9, 2, 9, 5, 2)]
        jeng = JServeEngine(jm, jp, n_slots=2, cap=20)
        jr = [JRequest(i, t, news[i], extras={"frames": f}) for i, (t, f) in enumerate(reqs)]
        for r in jr:
            jeng.submit(r)
        _ENGINE.update(cfg=cfg, p=p, reqs=reqs, news=news, jsteps=jeng.run(), jreqs=jr,
                       jsnap=jeng.obs.registry.snapshot())
    return _ENGINE


@pytest.mark.parametrize("impl", ("naive", "pallas"))
def test_engine_tokens_match_reference_engine(impl):
    """The five requests through the port's engine, in float32: greedy
    tokens, steps and engine counters equal the JAX `ServeEngine`'s (slot
    reuse and the uniform decode length included; cap 20 <=
    n_audio_frames)."""
    e = _engine_models()
    eng = ServeEngine(get_model(dataclasses.replace(e["cfg"], attn_impl=impl)), e["p"],
                      n_slots=2, cap=20, device="cpu")
    reqs = [Request(i, t, e["news"][i], extras={"frames": f}) for i, (t, f) in enumerate(e["reqs"])]
    for r in reqs:
        eng.submit(r)
    assert eng.run() == e["jsteps"]
    assert [r.generated for r in reqs] == [r.generated for r in e["jreqs"]]
    assert all(r.done and len(r.generated) == e["news"][r.rid] for r in reqs)
    assert eng.obs.registry.snapshot() == e["jsnap"]


def test_engine_refusals():
    """cap above n_audio_frames, missing, unexpected or misshapen frames,
    and a prompt that reaches cap raise `ValueError`."""
    e = _engine_models()
    m, F, d = get_model(e["cfg"]), e["cfg"].n_audio_frames, e["cfg"].d_model
    with pytest.raises(ValueError, match="n_audio_frames"):
        ServeEngine(m, e["p"], 1, F + 1, device="cpu")
    eng = ServeEngine(m, e["p"], 1, F, device="cpu")
    frames = np.zeros((F, d), np.float32)
    for extras in (None, {"frames": frames, "patches": frames}, {"frames": frames[:-1]},
                   {"frames": np.zeros((F, d + 1))}):
        with pytest.raises(ValueError, match="frames|extras"):
            eng.submit(Request(0, np.arange(3), extras=extras))
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(0, np.arange(F), extras={"frames": frames}))
    req = Request(0, np.arange(F - 1), max_new_tokens=5, extras={"frames": frames.astype(float)})
    eng.submit(req)
    assert eng.drain() == 1 and req.done and len(req.generated) == 2   # stopped by cap
