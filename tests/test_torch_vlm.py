"""The port's vision tokens (`repro_torch.models.lm` with ``n_vision_tokens``)
against the JAX reference, on the CPU.

Both sides run the reduced internvl2 config (2 layers, d_model 56, 7 query
heads over 1 kv head of 8, QKV bias, 8 vision tokens) with the reference's
random weights carried over by `convert.lm_params_from_arrays`, on the
same numpy patches and tokens, each port path (``naive``, ``chunked`` with
chunks of 8 rows, ``pallas``: on the CPU the kernels' plain versions) held
to the reference's Pallas flash kernel (interpret mode) under ``pallas``
and to its ``naive`` path otherwise (the chunked path computes each row as
the naive one does).
Tolerances are `tests/test_torch_models.py`'s: rtol = atol = 2e-5 in
float32, 2e-2 in bfloat16 with the logits' atol relative to their largest
magnitude, each bf16 decode step started from the reference's cache.
The engine serves in float32 and its greedy tokens must equal greedy
decoding over the reference's own full forward (``mode="train"``), the
prompt re-run whole for every token.  The JAX `ServeEngine` counts a VLM
slot's length as its tokens only (``slot_len = len(tokens)``), so its
decode writes and attends at the wrong position; the port counts the
prefill's positions, V + len(tokens) (`ROADMAP.md` queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.serving.engine import pad_cache_to_capacity as jpad
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServeEngine, pad_cache_to_capacity

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "internvl2-1b"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _close(got, want, dtype, what="", logits=False):
    tol = dict(TOL[dtype])
    if logits and dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _pair(dtype, impl="naive"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype, attn_chunk=8,
                               attn_impl=impl)
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


_PARAMS: dict = {}


def _params(dtype):
    """The reference's random weights of the reduced config, with random
    QKV biases (its init makes them zero), as (jax tree, port tree)."""
    if dtype not in _PARAMS:
        jcfg, _ = _pair(dtype)
        params = jax.jit(lambda key: jget_model(jcfg).init_params(key)[0])(
            jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        attn_p = params["groups"]["l0"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn_p[b] = jnp.asarray(rng.standard_normal(attn_p[b].shape) * 0.5, attn_p[b].dtype)
        _PARAMS[dtype] = (params, lm_params_from_arrays(jax.tree.map(np.asarray, params), "cpu"))
    return _PARAMS[dtype]


_REF: dict = {}


def _ref_model(dtype, ref_impl):
    """The reference model on ``ref_impl`` with its jitted prefill and
    decode_step, compiled once per (dtype, path) and shared by the tests."""
    if (dtype, ref_impl) not in _REF:
        jm = jget_model(_pair(dtype, ref_impl)[0])
        _REF[dtype, ref_impl] = (jm, jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _REF[dtype, ref_impl]


def _to_port(tree):
    """A reference cache tree (tuples kept) as the port's tensors."""
    return jax.tree.map(lambda a: lm_params_from_arrays({"t": np.asarray(a)}, "cpu")["t"], tree)


@pytest.mark.parametrize("impl", ("naive", "chunked", "pallas"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_prefill_with_patches_and_decode_match_reference(dtype, impl):
    """`Model.prefill` of [2, 12] tokens after [2, 8] patches: logits and
    the K/V cache of all 20 positions; then two `decode_step`s at cache_len
    V + S and V + S + 1 (the reference's own test drives decode there)."""
    _, cfg = _pair(dtype, impl)
    jp, p = _params(dtype)
    jm, jprefill, jdecode = _ref_model(dtype, "pallas" if impl == "pallas" else "naive")
    m = get_model(cfg)
    rng = np.random.default_rng(5)
    V, S = cfg.n_vision_tokens, 12
    patches = rng.standard_normal((2, V, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks), "patches": torch.from_numpy(patches)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and c["groups"]["l0"][0].shape[2] == V + S
    _close(lg, jl, dtype, "prefill logits", logits=True)
    for i in (0, 1):
        _close(c["groups"]["l0"][i], jc["groups"]["l0"][i], dtype, f"prefill cache {i}")
    cap = V + S + 4
    jc, c = jpad(jc, jm.cache_axes(), cap), pad_cache_to_capacity(c, m.cache_axes(), cap)
    for clen in (V + S, V + S + 1):
        if dtype == "bfloat16":
            c = _to_port(jc)
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nt), jnp.int32(clen))
        lg, c = m.decode_step(p, c, torch.from_numpy(nt), clen)
        _close(lg, jl, dtype, f"decode logits at {clen}", logits=True)
        _close(c["groups"]["l0"][1], jc["groups"]["l0"][1], dtype, f"v cache at {clen}")


def test_patches_are_cast_before_the_projection():
    """bf16: ``patches`` are rounded to the model dtype before
    ``vision_proj`` (as the reference), so f32 patches and their bf16
    rounding give the same prefill."""
    _, cfg = _pair("bfloat16")
    p = _params("bfloat16")[1]
    rng = np.random.default_rng(9)
    patches = torch.from_numpy(rng.standard_normal((1, cfg.n_vision_tokens, cfg.d_model))
                               .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 5)))
    a, _ = get_model(cfg).prefill(p, {"tokens": toks, "patches": patches})
    b, _ = get_model(cfg).prefill(p, {"tokens": toks, "patches": patches.to(torch.bfloat16)})
    assert torch.equal(a, b)


def test_port_initialiser_tree_has_vision_proj():
    jcfg, cfg = _pair("float32")
    ref = jax.tree.map(lambda a: a.shape,
                       jget_model(jcfg).init_params(jax.random.PRNGKey(0), abstract=True)[0])
    params = get_model(cfg).init_params(seed=3, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == ref
    vp = params["vision_proj"]
    assert vp.shape == (cfg.d_model, cfg.d_model)
    assert abs(float(vp.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


_GREEDY: dict = {}


def _greedy(prompt, patches, n_new):
    """Greedy decoding over the reference's full forward (``mode="train"``,
    float32): the whole prompt re-run for each new token."""
    if not _GREEDY:
        jcfg, _ = _pair("float32")
        jm = jget_model(jcfg)
        _GREEDY["fwd"] = jax.jit(lambda p, b: jm.forward(p, b, mode="train")[0])
    jp = _params("float32")[0]
    toks = list(prompt)
    out = []
    for _ in range(n_new):
        logits = _GREEDY["fwd"](jp, {"tokens": jnp.asarray([toks], jnp.int32),
                                     "patches": jnp.asarray(patches[None])})
        out.append(int(jnp.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("impl", ("naive", "pallas"))
def test_engine_tokens_match_greedy_over_reference_forward(impl):
    """Four 5-token requests, each with its own patches, through 2 slots
    (admitted in pairs, so both slots decode at their own length), and two
    of 5 and 7 tokens through 1 slot: every request's tokens equal greedy
    decoding over the reference's full forward.  Slot lengths count the
    patches."""
    _, cfg = _pair("float32", impl)
    p = _params("float32")[1]
    rng = np.random.default_rng(11)
    V, d = cfg.n_vision_tokens, cfg.d_model
    for n_slots, lens in ((2, (5, 5, 5, 5)), (1, (5, 7))):
        eng = ServeEngine(get_model(cfg), p, n_slots=n_slots, cap=24, device="cpu")
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 9 - n,
                        extras={"patches": rng.standard_normal((V, d)).astype(np.float32)})
                for i, n in enumerate(lens)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert sorted(eng.slot_len.tolist())[-1] == V + lens[0] + 1
        eng.drain()
        for r in reqs:
            want = _greedy(r.tokens, r.extras["patches"], 9 - len(r.tokens))
            assert r.done and r.generated == want


def test_engine_refusals():
    """V + len(tokens) >= cap, and missing, unexpected or misshapen patches
    raise `ValueError`."""
    _, cfg = _pair("float32")
    p = _params("float32")[1]
    V, d = cfg.n_vision_tokens, cfg.d_model
    eng = ServeEngine(get_model(cfg), p, n_slots=1, cap=16, device="cpu")
    patches = np.zeros((V, d), np.float32)
    with pytest.raises(ValueError, match="prefill positions"):
        eng.submit(Request(0, np.arange(16 - V), extras={"patches": patches}))
    for extras in (None, {"patches": patches, "frames": patches}, {"patches": patches[1:]}):
        with pytest.raises(ValueError, match="patches|extras"):
            eng.submit(Request(0, np.arange(3), extras=extras))
    req = Request(0, np.arange(15 - V), max_new_tokens=4, extras={"patches": patches})
    eng.submit(req)
    eng.drain()
    assert req.done and len(req.generated) == 2    # one decode at position cap - 1, then cap


@pytest.mark.parametrize("arch", ("whisper-tiny", "internvl2-1b"))
def test_params_from_arrays_keep_bf16_bits_of_every_family(arch):
    """`convert.lm_params_from_arrays` carries any model's tree leaf for
    leaf, bf16 bits kept: whisper's (embed, enc_blocks, enc_norm,
    dec_blocks, dec_norm, head) and internvl2's (vision_proj included)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="bfloat16")
    params = jax.jit(lambda key: jget_model(jcfg).init_params(key)[0])(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, params)
    port = lm_params_from_arrays(host, "cpu")
    assert jax.tree.structure(port) == jax.tree.structure(host)
    want = {"whisper-tiny": {"embed", "enc_blocks", "enc_norm", "dec_blocks", "dec_norm", "head"},
            "internvl2-1b": {"embed", "final_norm", "head", "vision_proj", "groups"}}[arch]
    assert set(port) == want
    for a, t in zip(jax.tree.leaves(host), jax.tree.leaves(port)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
