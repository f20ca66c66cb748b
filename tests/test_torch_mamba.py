"""The port's Mamba-2 block and the Jamba hybrid (`repro_torch.models.mamba`,
`models.lm`) against the JAX reference, on the CPU.

Inputs are drawn with numpy from fixed seeds and go through the reference's
function and its twin.  The SSD twins (`ssd_chunked` at chunks 8, 32 and
128 on L = 100, `ssd_scan_ref`) agree with the reference within rtol = atol
= 2e-5 in float32, and the port's chunked form with its own sequential
oracle within the reference's 1e-4 (`tests/test_models.py`).  The block
(`mamba_apply`, `mamba_decode`) agrees within 1e-5 in float32 and 2e-2 in
bfloat16 on the reference's weights (carried over by
`convert.lm_params_from_arrays`); token-by-token decode equals the full
forward within the reference's 2e-3.  The reduced Jamba model's prefill and
decode logits agree with the reference's `Model` within
`tests/test_torch_models.py`'s tolerances (bf16 logits' atol relative to
their largest magnitude, each bf16 decode step started from the
reference's cache), and `ServeEngine`'s greedy tokens equal the JAX
engine's in float32.  A prompt shorter than the conv tail (1 or 2 tokens)
leaves a tail left-padded with zeros, held to `mamba_apply` over the whole
sequence (the reference keeps the short tail; `ROADMAP.md` queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as jmb
from repro.models.api import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.engine import pad_cache_to_capacity as jpad
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models import mamba as mb
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServeEngine, pad_cache_to_capacity

ARCH = "jamba-1.5-large-398b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _both(a, dtype="float32"):
    """A numpy f32 array as (jax array, tensor) in ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _ssd_inputs(seed, B=2, L=100, nH=4, P=8, N=16):
    """tests/test_models.py's SSD inputs: x, softplus dt, B, C, a_log and a
    non-zero starting state, as numpy f32."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, L, nH, P))
    dt = np.logaddexp(rng.standard_normal((B, L, nH)), 0.0)
    Bm = rng.standard_normal((B, L, N))
    Cm = rng.standard_normal((B, L, N))
    a_log = rng.standard_normal(nH) * 0.5
    h0 = rng.standard_normal((B, nH, N, P)) * 0.5
    return [np.asarray(t, np.float32) for t in (xh, dt, Bm, Cm, a_log, h0)]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the SSD scans against the reference and against the port's own oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-none", "h0-given"])
@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    xh, dt, Bm, Cm, a_log, h0 = _ssd_inputs(0)
    jin = [jnp.asarray(t) for t in (xh, dt, Bm, Cm, a_log)]
    tin = [torch.from_numpy(t) for t in (xh, dt, Bm, Cm, a_log)]
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else (None, None)
    jy, jh = jmb.ssd_chunked(*jin, chunk=chunk, h0=jh0)
    y, h = mb.ssd_chunked(*tin, chunk=chunk, h0=th0)
    assert y.dtype == torch.float32 and y.shape == xh.shape
    _close(y, jy, 2e-5, "y")
    _close(h, jh, 2e-5, "h_final")


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-none", "h0-given"])
def test_ssd_scan_ref_matches_reference(with_h0):
    xh, dt, Bm, Cm, a_log, h0 = _ssd_inputs(1, L=40)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else (None, None)
    jy, jh = jmb.ssd_scan_ref(*(jnp.asarray(t) for t in (xh, dt, Bm, Cm, a_log)), h0=jh0)
    y, h = mb.ssd_scan_ref(*(torch.from_numpy(t) for t in (xh, dt, Bm, Cm, a_log)), h0=th0)
    _close(y, jy, 2e-5, "y")
    _close(h, jh, 2e-5, "h_final")


@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_ssd_chunked_matches_own_oracle(chunk):
    """The reference's test_ssd_chunked_matches_sequential on the port, with
    a starting state as well; bf16 activations leave as bf16."""
    xh, dt, Bm, Cm, a_log, h0 = (torch.from_numpy(t) for t in _ssd_inputs(0))
    for start in (None, h0):
        y1, h1 = mb.ssd_chunked(xh, dt, Bm, Cm, a_log, chunk=chunk, h0=start)
        y2, h2 = mb.ssd_scan_ref(xh, dt, Bm, Cm, a_log, h0=start)
        torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)
    yb, hb = mb.ssd_chunked(xh.to(torch.bfloat16), dt, Bm, Cm, a_log, chunk=chunk,
                            out_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32


def test_softplus_is_logaddexp():
    """`jax.nn.softplus` (logaddexp(x, 0)), also above F.softplus's threshold
    of 20, to an f32 ulp."""
    x = np.linspace(-40.0, 40.0, 161, dtype=np.float32)
    np.testing.assert_allclose(mb.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# the block against the reference
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _model(dtype, arch=ARCH):
    """(reference cfg, reference params, port cfg, port params) of a reduced
    config."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype)
        jp, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        cfg = model_config_from_dict(dataclasses.asdict(jcfg))
        _MODELS[key] = (jcfg, jp, cfg, lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[key]


def _layer(tree, j="l1", kind="mamba"):
    """Layer 0 of group entry ``j``'s mixer, on either side."""
    return {k: v[0] for k, v in tree["groups"][j][kind].items()}


_japply = jax.jit(jmb.mamba_apply, static_argnums=(1, 4))
_jdecode = jax.jit(jmb.mamba_decode, static_argnums=(1,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_and_decode_match_reference(dtype):
    """`mamba_apply` over 37 tokens (three chunks of 16, the last ragged)
    with its state, then four `mamba_decode` steps from that state."""
    jcfg, jp, cfg, p = _model(dtype)
    jl, pl = _layer(jp), _layer(p)
    rng = np.random.default_rng(3)
    jx, x = _both(rng.standard_normal((2, 37, cfg.d_model)), dtype)
    jy, js = _japply(jl, jcfg, jx, None, True)
    y, s = mb.mamba_apply(pl, cfg, x, return_state=True)
    tol = BLOCK_TOL[dtype]
    assert y.dtype == cfg.torch_dtype and s["h"].dtype == torch.float32
    assert s["conv"].dtype == cfg.torch_dtype and s["conv"].shape == (2, 3, cfg.d_inner)
    _close(y, jy, tol, "apply y")
    _close(s["h"], js["h"], tol, "state h")
    _close(s["conv"], js["conv"], tol, "state conv")
    for step in range(4):
        jxt, xt = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
        jy, js = _jdecode(jl, jcfg, jxt, js)
        y, s = mb.mamba_decode(pl, cfg, xt, s)
        _close(y, jy, tol, f"decode {step} y")
        _close(s["h"], js["h"], tol, f"decode {step} h")
        _close(s["conv"], js["conv"], tol, f"decode {step} conv")


def test_causal_conv_and_project_match_reference():
    jcfg, jp, cfg, p = _model("bfloat16")
    jl, pl = _layer(jp), _layer(p)
    jx, x = _both(np.random.default_rng(4).standard_normal((2, 21, cfg.d_model)), "bfloat16")
    want = jax.jit(jmb._project, static_argnums=(1,))(jl, jcfg, jx)
    got = mb._project(pl, cfg, x)
    for name, g, w in zip(("xh", "dt", "B", "C", "z", "conv_tail"), got, want):
        assert g.dtype == getattr(torch, str(w.dtype)), name
        _close(g, w, 2e-2, name)
    # the taps in index order: bit for bit with the reference in bf16
    a = jnp.asarray(np.random.default_rng(5).standard_normal((2, 9, cfg.d_inner)), jnp.bfloat16)
    conv = jax.jit(jmb._causal_conv)(a, jl["conv_w"], jl["conv_b"])
    mine = mb._causal_conv(torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16),
                           pl["conv_w"], pl["conv_b"])
    np.testing.assert_array_equal(_np(mine), _np(conv))


@pytest.mark.parametrize("L0", [1, 2, 3, 10, 16, 17])
def test_mamba_decode_matches_full_forward(L0):
    """`mamba_apply` over the first ``L0`` tokens, then token-by-token decode
    of the rest, against `mamba_apply` over all 20 (the reference's 2e-3);
    ``L0`` of 1 and 2 leave a conv tail shorter than d_conv - 1, which is
    left-padded with zeros."""
    _, _, cfg, p = _model("float32")
    pl = _layer(p)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 20, cfg.d_model))
                         .astype(np.float32))
    y_full, _ = mb.mamba_apply(pl, cfg, x)
    y0, state = mb.mamba_apply(pl, cfg, x[:, :L0], return_state=True)
    assert state["conv"].shape == (1, cfg.mamba_d_conv - 1, cfg.d_inner)
    n_pad = max(cfg.mamba_d_conv - 1 - L0, 0)
    assert not state["conv"][:, :n_pad].any()
    ys = [y0]
    for t in range(L0, 20):
        y_t, state = mb.mamba_decode(pl, cfg, x[:, t:t + 1], state)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, rtol=2e-3, atol=2e-3)
    from_zero = mb.init_mamba_state(cfg, 1, "cpu")
    for t in range(3):
        y_t, from_zero = mb.mamba_decode(pl, cfg, x[:, t:t + 1], from_zero)
        torch.testing.assert_close(y_t, y_full[:, t:t + 1], rtol=2e-3, atol=2e-3)


def test_short_prompt_conv_tail_against_reference():
    """The tail of a 2-token prompt: the reference keeps 2 rows, the port
    puts them last behind a zero row."""
    jcfg, jp, cfg, p = _model("float32")
    jx, x = _both(np.random.default_rng(7).standard_normal((1, 2, cfg.d_model)))
    _, js = _japply(_layer(jp), jcfg, jx, None, True)
    _, s = mb.mamba_apply(_layer(p), cfg, x, return_state=True)
    assert js["conv"].shape[1] == 2 and s["conv"].shape[1] == 3
    assert not s["conv"][:, 0].any()
    _close(s["conv"][:, 1:], js["conv"], 1e-6)


# ---------------------------------------------------------------------------
# the reduced Jamba model, its engine and its weights
# ---------------------------------------------------------------------------

def _port_cache(jcache):
    """The reference's cache tree as port tensors ((k, v) kept as tuples)."""
    if isinstance(jcache, dict):
        return {k: _port_cache(v) for k, v in jcache.items()}
    if isinstance(jcache, (tuple, list)):
        return tuple(_port_cache(t) for t in jcache)
    return lm_params_from_arrays({"t": np.asarray(jcache)}, "cpu")["t"]


def _logits_close(got, want, dtype, what):
    """In bf16 the atol is 2e-2 of the largest |value|: a layer's rounding
    differences reach every later activation (`tests/test_torch_models.py`)."""
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


_JITTED: dict = {}


def _jitted(jcfg):
    """The reference model's jitted prefill and decode_step, once per config."""
    if jcfg not in _JITTED:
        jm = jget_model(jcfg)
        _JITTED[jcfg] = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _JITTED[jcfg]


@pytest.mark.parametrize("dtype,impl", [("float32", "naive"), ("bfloat16", "naive"),
                                        ("float32", "pallas")])
def test_prefill_and_decode_steps_match_reference(dtype, impl):
    """`Model.prefill` of a [2, 37] prompt (the SSD over three chunks), then
    four `decode_step`s: logits, the attention cache and every Mamba state
    agree.  Under "pallas" the port runs its attention kernels' plain
    versions."""
    jcfg, jp, cfg, p = _model(dtype)
    jm, m = jget_model(jcfg), get_model(dataclasses.replace(cfg, attn_impl=impl))
    jprefill, jdecode = _jitted(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and lg.dtype == torch.float32
    _logits_close(lg, jl, dtype, "prefill logits")
    for j in range(1, 8):
        _logits_close(c["groups"][f"l{j}"]["h"], jc["groups"][f"l{j}"]["h"], dtype,
                      f"l{j} prefill state")
    jc, c = jpad(jc, jm.cache_axes(), 48), pad_cache_to_capacity(c, m.cache_axes(), 48)
    clen = 37
    for step in range(4):
        if dtype == "bfloat16":
            c = _port_cache(jc)
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nt), jnp.int32(clen))
        before = c["groups"]["l3"]["h"]
        lg, c2 = m.decode_step(p, c, torch.from_numpy(nt), clen)
        assert c2 is c and c["groups"]["l3"]["h"] is before      # states written in place
        _logits_close(lg, jl, dtype, f"decode step {step} logits")
        _close(c["groups"]["l0"][1], jc["groups"]["l0"][1], BLOCK_TOL[dtype],
               f"v cache after step {step}")
        for j in range(1, 8):
            for name in ("h", "conv"):
                _logits_close(c["groups"][f"l{j}"][name], jc["groups"][f"l{j}"][name], dtype,
                              f"l{j} {name} after step {step}")
        clen += 1


_ENGINE_PROMPTS = (19, 4, 3, 19, 4)     # three lengths: the reference compiles each
_JAX_TOKENS: list = []


def _jax_engine_tokens():
    """The JAX engine's greedy tokens for `_ENGINE_PROMPTS` (computed once)."""
    if not _JAX_TOKENS:
        jcfg, jp, cfg, _ = _model("float32")
        rng = np.random.default_rng(1)
        jeng = JServeEngine(jget_model(jcfg), jp, n_slots=2, cap=32)
        reqs = [JRequest(rid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                         max_new_tokens=3 + i % 3) for i, n in enumerate(_ENGINE_PROMPTS)]
        for r in reqs:
            jeng.submit(r)
        steps = jeng.run()
        _JAX_TOKENS.append((steps, reqs))
    return _JAX_TOKENS[0]


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_engine_greedy_tokens_match_reference(impl):
    """Five requests of 3, 4 and 19 tokens through 2 slots, float32: the port's
    `ServeEngine` generates the JAX engine's tokens (Mamba states inserted
    into reused slots, the MoE layers' per-row dispatch)."""
    _, _, cfg, p = _model("float32")
    jsteps, jreqs = _jax_engine_tokens()
    eng = ServeEngine(get_model(dataclasses.replace(cfg, attn_impl=impl)), p, n_slots=2, cap=32,
                      device="cpu")
    reqs = [Request(rid=r.rid, tokens=r.tokens, max_new_tokens=r.max_new_tokens) for r in jreqs]
    for r in reqs:
        eng.submit(r)
    assert eng.run() == jsteps
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert eng.cache["groups"]["l1"]["h"].shape == (1, 2, cfg.mamba_heads, cfg.mamba_d_state,
                                                    cfg.mamba_head_dim)


def test_engine_short_prompts_follow_full_forward():
    """Prompts of 1 and 2 tokens (conv tails shorter than d_conv - 1) through
    the engine: every greedy token equals the argmax of a fresh prefill over
    the prompt and the tokens so far."""
    _, _, cfg, p = _model("float32")
    m = get_model(cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (1, 2, 1)]
    eng = ServeEngine(m, p, n_slots=1, cap=16, device="cpu")    # one slot: no padded decode
    reqs = [Request(rid=i, tokens=t, max_new_tokens=4) for i, t in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.drain()
    for r, t in zip(reqs, prompts):
        seq = list(t)
        for tok in r.generated:
            lg, _ = m.prefill(p, {"tokens": torch.tensor([seq])})
            assert int(torch.argmax(lg[0, -1])) == tok
            seq.append(tok)


def test_lm_params_from_arrays_carries_hybrid_tree():
    """The reference's bf16 Jamba tree arrives leaf for leaf: the same paths,
    shapes and bits; ``a_log`` stays f32."""
    jcfg, jp, cfg, _ = _model("bfloat16")
    host = jax.tree.map(np.asarray, jp)
    port = lm_params_from_arrays(host, "cpu")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(host)]
    assert paths == [jax.tree_util.keystr(k)
                     for k, _ in jax.tree_util.tree_leaves_with_path(port)]
    assert sum("['a_log']" in s for s in paths) == 7
    for s, a, t in zip(paths, jax.tree.leaves(host), jax.tree.leaves(port)):
        assert tuple(t.shape) == a.shape
        if "a_log" in s:
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
        else:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    mine = get_model(cfg).init_params(seed=0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), port)


def test_full_config_is_served():
    """jamba-1.5-large-398b passes the port's checks without building
    weights: the fields, block kinds, MoE layers, Mamba widths and parameter
    counts are the reference's, and so is the cache layout."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    model = get_model(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_counts() == jcfg.param_counts()
    assert 397e9 < cfg.param_counts()["total"] < 399e9
    assert (cfg.d_inner, cfg.mamba_heads) == (16384, 256)
    assert [cfg.layer_is_moe(i) for i in range(8)] == [False, True] * 4
    axes = model.cache_axes()
    assert axes["groups"]["l0"][0] == ("layers", "cache_batch", "cache_seq", "kv_heads",
                                       "head_dim")
    assert axes["groups"]["l1"] == {k: ("layers",) + v for k, v in mb.MAMBA_STATE_AXES.items()}
    cut = dataclasses.replace(cfg, n_layers=8, n_experts=8)
    assert cut.param_counts()["total"] == 25_820_591_360
