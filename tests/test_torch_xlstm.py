"""The port's xLSTM blocks and the xlstm-125m stack (`repro_torch.models.xlstm`,
`models.lm`) against the JAX reference, on the CPU.

Inputs are drawn with numpy from fixed seeds and go through the reference's
function and its twin.  `mlstm_chunked` (chunks 8 and 32 on L = 90),
`mlstm_scan_ref` and `slstm_cell` agree with the reference within rtol =
atol = 2e-5 in float32, from the empty state and from a given one; the
port's chunked mLSTM agrees with its own sequential oracle within the
reference's 2e-4 (`tests/test_models.py`).  The blocks (`mlstm_apply` /
`mlstm_decode`, `slstm_apply` / `slstm_decode`) agree within 1e-5 in
float32 and 2e-2 in bfloat16 on the reference's weights (carried over by
`convert.lm_params_from_arrays`).  The reduced xLSTM model's prefill and
decode logits and states agree with the reference's `Model` within
`tests/test_torch_models.py`'s tolerances (bf16 values' atol relative to
their largest magnitude, each bf16 decode step started from the
reference's cache), and `ServeEngine`'s greedy tokens equal the JAX
engine's in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xlstm as jxl
from repro.models.api import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models import xlstm as xl
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServeEngine, pad_cache_to_capacity

ARCH = "xlstm-125m"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _both(a, dtype="float32"):
    """A numpy f32 array as (jax array, tensor) in ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


def _scaled_close(got, want, dtype, what):
    """In bf16 the atol is 2e-2 of the largest |value|: a layer's rounding
    differences reach every later activation (`tests/test_torch_models.py`)."""
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _mlstm_inputs(seed, B=2, L=90, nH=2, dh=16):
    """tests/test_models.py's mLSTM inputs (q, k, v, log f, log i) and a
    state {C, n, m} from a first stretch of the same recurrence, numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, nH, dh)).astype(np.float32) for _ in range(3))
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.standard_normal((B, L, nH)) + 1,
                                                   jnp.float32)))
    li = rng.standard_normal((B, L, nH)).astype(np.float32)
    _, st = jxl.mlstm_scan_ref(*(jnp.asarray(t[:, :7]) for t in (q, k, v, lf, li)))
    return (q, k, v, lf, li), {n: np.array(t) for n, t in st.items()}


def _state(st, lib):
    return None if st is None else {n: (jnp.asarray(t) if lib == "jax" else torch.from_numpy(t))
                                    for n, t in st.items()}


# ---------------------------------------------------------------------------
# the scans against the reference and against the port's own oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "given"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunked_matches_reference(chunk, with_state):
    ins, st = _mlstm_inputs(1)
    st = st if with_state else None
    jh, js = jxl.mlstm_chunked(*(jnp.asarray(t) for t in ins), chunk=chunk,
                               state=_state(st, "jax"))
    h, s = xl.mlstm_chunked(*(torch.from_numpy(t) for t in ins), chunk=chunk,
                            state=_state(st, "torch"))
    assert h.dtype == torch.float32 and h.shape == ins[0].shape
    _close(h, jh, 2e-5, "h")
    for name in ("C", "n", "m"):
        _close(s[name], js[name], 2e-5, name)


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "given"])
def test_mlstm_scan_ref_matches_reference(with_state):
    ins, st = _mlstm_inputs(2, L=30)
    st = st if with_state else None
    jh, js = jxl.mlstm_scan_ref(*(jnp.asarray(t) for t in ins), state=_state(st, "jax"))
    h, s = xl.mlstm_scan_ref(*(torch.from_numpy(t) for t in ins), state=_state(st, "torch"))
    _close(h, jh, 2e-5, "h")
    for name in ("C", "n", "m"):
        _close(s[name], js[name], 2e-5, name)


@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_mlstm_chunked_matches_own_oracle(chunk):
    """The reference's test_mlstm_chunked_matches_sequential on the port,
    from the empty state and from a given one."""
    ins, st = _mlstm_inputs(1)
    tins = [torch.from_numpy(t) for t in ins]
    for start in (None, _state(st, "torch")):
        h1, s1 = xl.mlstm_chunked(*tins, chunk=chunk, state=start)
        h2, s2 = xl.mlstm_scan_ref(*tins, state=start)
        torch.testing.assert_close(h1, h2, rtol=2e-4, atol=2e-4)
        for name in ("C", "n", "m"):
            torch.testing.assert_close(s1[name], s2[name], rtol=2e-4, atol=2e-4)


def test_log_sigmoid_is_minus_softplus():
    x = np.linspace(-40.0, 40.0, 161, dtype=np.float32)
    np.testing.assert_allclose(xl.log_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))), rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# the blocks against the reference
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _model(dtype):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced config."""
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype)
        jp, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        cfg = model_config_from_dict(dataclasses.asdict(jcfg))
        _MODELS[dtype] = (jcfg, jp, cfg, lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[dtype]


def _layer(tree, kind):
    """Layer 0 of a block kind's stacked weights (l0: mLSTM, l1: sLSTM)."""
    sub = tree["groups"]["l0" if kind == "mlstm" else "l1"][kind]
    return jax.tree.map(lambda a: a[0], sub)


_JFN = {
    "mlstm": (jax.jit(jxl.mlstm_apply, static_argnums=(1, 4)),
              jax.jit(jxl.mlstm_decode, static_argnums=(1,))),
    "slstm": (jax.jit(jxl.slstm_apply, static_argnums=(1, 4)),
              jax.jit(jxl.slstm_decode, static_argnums=(1,))),
}
_FN = {"mlstm": (xl.mlstm_apply, xl.mlstm_decode), "slstm": (xl.slstm_apply, xl.slstm_decode)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_and_decode_match_reference(kind, dtype):
    """`*_apply` over 37 tokens (mLSTM: three chunks of 16, the last ragged)
    with its state, then four `*_decode` steps from that state."""
    jcfg, jp, cfg, p = _model(dtype)
    jl, pl = _layer(jp, kind), _layer(p, kind)
    japply, jdecode = _JFN[kind]
    apply, decode = _FN[kind]
    rng = np.random.default_rng(3)
    jx, x = _both(rng.standard_normal((2, 37, cfg.d_model)), dtype)
    jy, js = japply(jl, jcfg, jx, None, True)
    y, s = apply(pl, cfg, x, return_state=True)
    tol = BLOCK_TOL[dtype]
    assert y.dtype == cfg.torch_dtype and set(s) == set(js)
    assert all(t.dtype == torch.float32 for t in s.values())
    _close(y, jy, tol, "apply y")
    for name in s:
        _close(s[name], js[name], tol, f"state {name}")
    for step in range(4):
        jxt, xt = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
        jy, js = jdecode(jl, jcfg, jxt, js)
        y, s = decode(pl, cfg, xt, s)
        _close(y, jy, tol, f"decode {step} y")
        for name in s:
            _close(s[name], js[name], tol, f"decode {step} {name}")


def test_slstm_cell_matches_reference():
    """The recurrence alone, float32, from a non-empty state."""
    jcfg, jp, cfg, p = _model("float32")
    jl, pl = _layer(jp, "slstm"), _layer(p, "slstm")
    rng = np.random.default_rng(4)
    jx, x = _both(rng.standard_normal((2, 25, cfg.d_model)))
    st = {k: rng.standard_normal((2, cfg.d_model)).astype(np.float32) for k in ("c", "h")}
    st["n"] = np.abs(rng.standard_normal((2, cfg.d_model))).astype(np.float32) + 0.5
    st["m"] = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jh, js = jax.jit(jxl.slstm_cell, static_argnums=(1,))(jl, jcfg, jx, _state(st, "jax"))
    h, s = xl.slstm_cell(pl, cfg, x, _state(st, "torch"))
    _close(h, jh, 2e-5, "h")
    for name in ("c", "n", "m", "h"):
        _close(s[name], js[name], 2e-5, name)


def test_mlstm_decode_matches_full_forward():
    """`mlstm_apply` over 23 tokens, then decode of 17 more, against
    `mlstm_apply` over all 40 (the reference's 2e-3 of the Mamba twin)."""
    _, _, cfg, p = _model("float32")
    pl = _layer(p, "mlstm")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 40, cfg.d_model))
                         .astype(np.float32))
    y_full, _ = xl.mlstm_apply(pl, cfg, x)
    y0, state = xl.mlstm_apply(pl, cfg, x[:, :23], return_state=True)
    ys = [y0]
    for t in range(23, 40):
        y_t, state = xl.mlstm_decode(pl, cfg, x[:, t:t + 1], state)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the reduced xLSTM model, its engine and its weights
# ---------------------------------------------------------------------------

def _port_cache(jcache):
    if isinstance(jcache, dict):
        return {k: _port_cache(v) for k, v in jcache.items()}
    return lm_params_from_arrays({"t": np.asarray(jcache)}, "cpu")["t"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(dtype):
    """`Model.prefill` of a [2, 37] prompt, then four `decode_step`s: logits
    and every layer's mLSTM and sLSTM state agree; the states are written in
    place."""
    jcfg, jp, cfg, p = _model(dtype)
    jm, m = jget_model(jcfg), get_model(cfg)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and lg.dtype == torch.float32
    _scaled_close(lg, jl, dtype, "prefill logits")
    c = pad_cache_to_capacity(c, m.cache_axes(), 48)            # no cache_seq axis: as it was
    for j, names in (("l0", "Cnm"), ("l1", "cnmh")):
        for name in names:
            _scaled_close(c["groups"][j][name], jc["groups"][j][name], dtype,
                          f"{j} {name} after prefill")
    for step in range(4):
        if dtype == "bfloat16":
            c = _port_cache(jc)
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nt), jnp.int32(37 + step))
        before = c["groups"]["l0"]["C"]
        lg, c2 = m.decode_step(p, c, torch.from_numpy(nt), 37 + step)
        assert c2 is c and c["groups"]["l0"]["C"] is before     # written in place
        _scaled_close(lg, jl, dtype, f"decode step {step} logits")
        for j, names in (("l0", "Cnm"), ("l1", "cnmh")):
            for name in names:
                _scaled_close(c["groups"][j][name], jc["groups"][j][name], dtype,
                              f"{j} {name} after step {step}")


def test_engine_greedy_tokens_match_reference():
    """Five requests of 2 to 19 tokens through 2 slots, float32: the port's
    `ServeEngine` generates the JAX engine's tokens (states inserted into
    reused slots)."""
    jcfg, jp, cfg, p = _model("float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (19, 2, 19, 2, 5)]
    max_new = [3 + i % 3 for i in range(5)]
    jeng = JServeEngine(jget_model(jcfg), jp, n_slots=2, cap=32)
    eng = ServeEngine(get_model(cfg), p, n_slots=2, cap=32, device="cpu")
    jreqs = [JRequest(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    assert eng.run() == jeng.run()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert eng.cache["groups"]["l0"]["m"].shape == (cfg.n_layers // 2, 2, cfg.n_heads)


def test_lm_params_from_arrays_carries_xlstm_tree():
    """The reference's bf16 xLSTM tree arrives leaf for leaf: the same paths,
    shapes and bits; the port's initialiser makes the same tree."""
    jcfg, jp, cfg, _ = _model("bfloat16")
    host = jax.tree.map(np.asarray, jp)
    port = lm_params_from_arrays(host, "cpu")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(host)]
    assert paths == [jax.tree_util.keystr(k)
                     for k, _ in jax.tree_util.tree_leaves_with_path(port)]
    assert any("['mlstm']['w_q']" in s for s in paths) and any("['up']['w_down']" in s
                                                              for s in paths)
    for a, t in zip(jax.tree.leaves(host), jax.tree.leaves(port)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    mine = get_model(cfg).init_params(seed=0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), port)


def test_full_config_is_served():
    """xlstm-125m passes the port's checks without building weights: the
    fields, block kinds and parameter counts are the reference's, and so is
    the cache layout."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    model = get_model(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_counts() == jcfg.param_counts()
    assert cfg.param_counts()["total"] == 187_085_616
    assert cfg.layer_kinds() == ["mlstm", "slstm"] * 6
    axes = model.cache_axes()
    assert axes["groups"] == {
        "l0": {k: ("layers",) + v for k, v in xl.MLSTM_STATE_AXES.items()},
        "l1": {k: ("layers",) + v for k, v in xl.SLSTM_STATE_AXES.items()},
    }
    cache = model.init_cache(2, 8, device="cpu")
    assert cache["groups"]["l0"]["C"].shape == (6, 2, 4, 384, 384)
    assert (cache["groups"]["l0"]["m"] == xl.NEG_INF).all()
    assert (cache["groups"]["l1"]["m"] == -30.0).all()
