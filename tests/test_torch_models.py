"""The port's LLM scaffold (`repro_torch.models`, `nn`, `configs`) against
the JAX reference, on the CPU.

Both sides run the same reduced configs of internlm2 (GQA 2:1) and qwen2
(MQA, QKV bias) in float32 and bfloat16, the reference's random weights
carried over by `convert.lm_params_from_arrays`, on the same numpy inputs.
The reference's ``pallas`` path runs its Pallas flash kernel in interpret
mode (as `tests/test_kernels.py` does); the port's runs the kernels' plain
versions, since its tensors lie on the CPU.  Each port path is compared
with the same reference path, except decode under ``pallas``, which the
reference computes with grouped einsums and the port with its flash-decode
kernel's plain version (P kept in f32 rather than rounded to the model
dtype): in float32 the port is held to the reference's einsum decode, in
bfloat16 to the reference's decode with its own flash-decode kernel
(`repro.kernels.ops.decode_attention`, interpret mode) in place of the
einsums (`_jax_kernel_decode`), so like is compared with like.
Tolerances are those of `tests/test_kernels.py`: rtol = atol = 2e-5 in
float32, 2e-2 in bfloat16, except that the bf16 logits of the whole model
take their atol relative to their largest magnitude (2e-2 x max|logit|).
The reason: XLA and PyTorch sum the f32 scores and the softmax in other
orders, so a few P entries differ by an f32 ulp, and now and then one of
them rounds to the other bf16 neighbour; the change that makes in a layer's
output reaches every logit through the head, so a logit near 0 can move by
more than 2e-2 absolute while all stay within 2e-2 of the logits' scale.
For the same reason each bf16 decode step of the model starts from the
reference's cache, so such a flip does not compound over steps.  No test
changes process-global state (the one substitution of a reference
function goes through pytest's monkeypatch and is undone after the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.kernels import ops as jops
from repro.models.api import get_model as jget_model
from repro.nn import core as jnn
from repro.serving.engine import pad_cache_to_capacity as jpad
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models import attention, mlp
from repro_torch.models.api import get_model
from repro_torch.nn import core as nn
from repro_torch.obs import Observability
from repro_torch.serving.engine import pad_cache_to_capacity

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ARCHS = ("internlm2-1.8b", "qwen2-7b")
DTYPES = ("float32", "bfloat16")
IMPLS = ("naive", "chunked", "pallas")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


def _close(got, want, dtype, what="", logits=False):
    """``logits``: in bf16 the atol is 2e-2 of the largest |logit| (see above)."""
    tol = dict(TOL[dtype])
    if logits and dtype == "bfloat16":
        tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _pair(arch, dtype, **over):
    """(reference cfg, port cfg) of one reduced config; chunk 8 so the
    chunked path really chunks the 20-token prompts."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype, attn_chunk=8, **over)
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


_PARAMS: dict = {}


def _params(arch, dtype):
    """The reference's random weights of a reduced config, with random QKV
    biases (its init makes them zero), as (jax tree, port tree on the CPU)."""
    key = (arch, dtype)
    if key not in _PARAMS:
        jcfg, _ = _pair(arch, dtype)
        params, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        attn_p = params["groups"]["l0"]["attn"]
        for b in ("bq", "bk", "bv"):
            if b in attn_p:
                attn_p[b] = jnp.asarray(rng.standard_normal(attn_p[b].shape) * 0.5,
                                        attn_p[b].dtype)
        host = jax.tree.map(np.asarray, params)
        _PARAMS[key] = (params, lm_params_from_arrays(host, "cpu"))
    return _PARAMS[key]


def _layer0(tree):
    """Layer 0 of a stacked group, on either side."""
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _jax_kernel_decode(p, cfg, x, cache, cache_len, cross=False):
    """The reference's `attn_decode` with its flash-decode kernel in place of
    the grouped einsums: the JAX counterpart of the port's ``pallas`` decode."""
    B = x.shape[0]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    kc, vc = cache
    q = jnn.dense(x, p["wq"], p.get("bq")).reshape(B, 1, nq, hd)
    k_new = jnn.dense(x, p["wk"], p.get("bk")).reshape(B, 1, nkv, hd)
    v_new = jnn.dense(x, p["wv"], p.get("bv")).reshape(B, 1, nkv, hd)
    pos = jnp.full((B, 1), cache_len, dtype=jnp.int32)
    q = jattn.apply_rope(q, pos, cfg.rope_theta)
    k_new = jattn.apply_rope(k_new, pos, cfg.rope_theta)
    kc = jax.lax.dynamic_update_slice(kc, k_new.astype(kc.dtype), (0, cache_len, 0, 0))
    vc = jax.lax.dynamic_update_slice(vc, v_new.astype(vc.dtype), (0, cache_len, 0, 0))
    lengths = jnp.full((B,), cache_len + 1, jnp.int32)
    o = jops.decode_attention(q.reshape(B, nq, hd), kc.transpose(0, 2, 1, 3),
                              vc.transpose(0, 2, 1, 3), lengths)
    y = jnn.dense(o.reshape(B, 1, nq * hd).astype(x.dtype), p["wo"])
    return y, (kc, vc)


def _x(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(1)
    jx, x = _x(rng, (2, 11, 4, 16), dtype)
    js, s = _x(rng, (16,), dtype)
    _close(nn.rms_norm(x, s, 1e-5), jnn.rms_norm(jx, js, 1e-5), dtype, "rms_norm")
    pos = rng.integers(0, 300, (2, 11)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(attention.apply_rope(x, torch.from_numpy(pos), theta),
               jattn.apply_rope(jx, jnp.asarray(pos), theta), dtype, "rope [B, S]")
        _close(attention.apply_rope(x, torch.arange(11), theta),
               jattn.apply_rope(jx, jnp.arange(11), theta), dtype, "rope [S]")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_matches_reference(arch, dtype, impl):
    jcfg, cfg = _pair(arch, dtype, attn_impl=impl)
    jp, p = _params(arch, dtype)
    jpa, pa = _layer0(jp["groups"]["l0"]["attn"]), _layer0(p["groups"]["l0"]["attn"])
    rng = np.random.default_rng(2)
    jx, x = _x(rng, (2, 20, cfg.d_model), dtype)
    jy, (jk, jv) = jattn.attn_apply(jpa, jcfg, jx, jnp.arange(20), return_cache=True)
    y, (k, v) = attention.attn_apply(pa, cfg, x, torch.arange(20))
    assert y.dtype == cfg.torch_dtype and y.shape == (2, 20, cfg.d_model)
    _close(y, jy, dtype, f"{impl} y")
    _close(k, jk, dtype, "k cache")
    _close(v, jv, dtype, "v cache")


@pytest.mark.parametrize("impl", ("naive", "pallas"))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode_matches_reference(arch, dtype, impl):
    """Grouped einsums (``naive``) or the flash-decode kernel's plain version
    (``pallas``) against the reference's decode (its kernel under
    ``pallas`` in bf16): the new K/V land at cache_len, in place, and the
    output agrees."""
    jcfg, cfg = _pair(arch, dtype, attn_impl=impl)
    jp, p = _params(arch, dtype)
    jpa, pa = _layer0(jp["groups"]["l0"]["attn"]), _layer0(p["groups"]["l0"]["attn"])
    rng = np.random.default_rng(3)
    cap, clen = 24, 13
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    cache_np = rng.standard_normal((2, 2, cap, nkv, hd)).astype(np.float32)
    cache_np[:, :, clen:] = 0.0
    jx, x = _x(rng, (2, 1, cfg.d_model), dtype)
    jcache = tuple(jnp.asarray(c, jcfg.jdtype) for c in cache_np)
    cache = tuple(torch.from_numpy(c.copy()).to(cfg.torch_dtype) for c in cache_np)
    ref_decode = _jax_kernel_decode if (impl, dtype) == ("pallas", "bfloat16") \
        else jattn.attn_decode
    jy, (jk, jv) = ref_decode(jpa, jcfg, jx, jcache, jnp.int32(clen))
    y, (k, v) = attention.attn_decode(pa, cfg, x, cache, clen)
    assert k is cache[0] and v is cache[1]          # updated in place
    _close(y, jy, dtype, f"{impl} y")
    _close(k, jk, dtype, "k cache")
    _close(v, jv, dtype, "v cache")


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ffn_matches_reference(dtype):
    jcfg, cfg = _pair("internlm2-1.8b", dtype)
    jp, p = _params("internlm2-1.8b", dtype)
    rng = np.random.default_rng(4)
    jx, x = _x(rng, (2, 9, cfg.d_model), dtype)
    jy, _ = jmlp.ffn_apply(_layer0(jp["groups"]["l0"]["ffn"]), jcfg, jx)
    _close(mlp.ffn_apply(_layer0(p["groups"]["l0"]["ffn"]), cfg, x)[0], jy, dtype, "ffn")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype, impl, monkeypatch):
    """`Model.prefill` of a [2, 20] prompt, then three `decode_step`s at
    growing cache_len: logits and caches agree.  In float32 the port runs
    on its own cache; in bfloat16 each step starts from the reference's."""
    jcfg, cfg = _pair(arch, dtype, attn_impl=impl)
    jp, p = _params(arch, dtype)
    if (impl, dtype) == ("pallas", "bfloat16"):
        monkeypatch.setattr(jattn, "attn_decode", _jax_kernel_decode)
    jm, m = jget_model(jcfg), get_model(cfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert lg.shape == (2, 1, cfg.padded_vocab) and lg.dtype == torch.float32
    _close(lg, jl, dtype, "prefill logits", logits=True)
    _close(c["groups"]["l0"][0], jc["groups"]["l0"][0], dtype, "prefill k cache")
    jc, c = jpad(jc, jm.cache_axes(), 32), pad_cache_to_capacity(c, m.cache_axes(), 32)
    clen = 20
    for step in range(3):
        if dtype == "bfloat16":
            c = {"groups": {"l0": tuple(lm_params_from_arrays({"t": np.asarray(t)}, "cpu")["t"]
                                        for t in jc["groups"]["l0"])}}
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nt), jnp.int32(clen))
        lg, c = m.decode_step(p, c, torch.from_numpy(nt), clen)
        _close(lg, jl, dtype, f"decode step {step} logits", logits=True)
        _close(c["groups"]["l0"][1], jc["groups"]["l0"][1], dtype, f"v cache after step {step}")
        clen += 1


@pytest.mark.parametrize("arch", configs.PORTED)
def test_configs_and_param_counts_match_reference(arch):
    for port_cfg, ref_cfg in ((configs.get_config(arch), jconfigs.get_config(arch)),
                              (configs.get_reduced(arch), jconfigs.get_reduced(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.param_counts() == ref_cfg.param_counts()
        assert port_cfg.padded_vocab == ref_cfg.padded_vocab
        assert port_cfg.resolved_head_dim == ref_cfg.resolved_head_dim
        assert port_cfg.layer_kinds() == ref_cfg.layer_kinds()
        assert [port_cfg.ffn_hidden(i) for i in range(port_cfg.n_layers)] == \
            [ref_cfg.ffn_hidden(i) for i in range(ref_cfg.n_layers)]
        assert port_cfg.torch_dtype == getattr(torch, ref_cfg.dtype)
        assert model_config_from_dict(dataclasses.asdict(ref_cfg)) == port_cfg


def test_registry_grid_and_unported_families():
    """The reference's grid, and every architecture of it ported: the
    registry refuses only a name it does not know."""
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.PORTED == configs.ARCHS
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[name])
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(include_skipped=True) == jconfigs.cells(include_skipped=True)
    full = configs.get_config("internlm2-1.8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.d_ff,
            full.padded_vocab, full.resolved_head_dim) == (24, 2048, 16, 8, 8192, 92672, 128)
    for getter in (configs.get_config, configs.get_reduced):
        with pytest.raises(KeyError, match="unknown architecture"):
            getter("whisper-large")
    on = Observability(jit_stats=True, audit=True)
    assert on.audit_tap is not None and on.ensure_route_stats(3).n_servers == 3


def _mixer_std(cfg, kind: str, p: dict) -> dict:
    """The reference's initial stds of a recurrent mixer's random leaves
    (`repro.models.mamba.mamba_init`, `repro.models.xlstm`'s inits)."""
    d = cfg.d_model
    if kind == "mamba":
        di = cfg.d_inner
        return {"w_in": (p["w_in"], d ** -0.5), "conv_w": (p["conv_w"], 0.1),
                "w_bc": (p["w_bc"], di ** -0.5), "w_dt": (p["w_dt"], 0.02),
                "w_out": (p["w_out"], di ** -0.5)}
    if kind == "mlstm":
        di = int(cfg.mlstm_proj_factor * d)
        return {"w_up": (p["w_up"], d ** -0.5), "w_q": (p["w_q"], di ** -0.5),
                "w_v": (p["w_v"], di ** -0.5), "w_i": (p["w_i"], 0.02),
                "w_f": (p["w_f"], 0.02), "w_down": (p["w_down"], di ** -0.5)}
    dff = int(cfg.slstm_proj_factor * d)
    return {"w": (p["w"], d ** -0.5), "r": (p["r"], 0.02),
            "up w_gate": (p["up"]["w_gate"], d ** -0.5),
            "up w_down": (p["up"]["w_down"], dff ** -0.5)}


@pytest.mark.parametrize("arch", ARCHS + ("deepseek-moe-16b", "llama4-scout-17b-a16e",
                                          "jamba-1.5-large-398b", "xlstm-125m"))
def test_port_initialiser_shapes_dtypes_and_std(arch):
    """The port's own random weights: the reference's tree, shapes and dtype
    (DeepSeek-MoE's dense prelude, the MoE leaves and the Mamba, mLSTM and
    sLSTM mixers included; Mamba's ``a_log`` f32 in every model dtype, as
    in the reference), drawn in its distributions (embedding std 0.02,
    fan-in normals, router std 0.02, ones, zero biases), reproducibly from
    the seed."""
    jcfg, cfg = _pair(arch, "float32")
    ref_shapes = jax.tree.map(lambda a: a.shape,
                              jget_model(jcfg).init_params(jax.random.PRNGKey(0), abstract=True)[0])
    params = get_model(cfg).init_params(seed=3, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == ref_shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))
    again = get_model(cfg).init_params(seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    d, hd = cfg.d_model, cfg.resolved_head_dim
    want_std = {"embed": (params["embed"], 0.02), "head": (params["head"], d ** -0.5)}
    groups = params["groups"]
    a = groups["l0"].get("attn")
    if a is not None:
        want_std.update(wq=(a["wq"], d ** -0.5), wk=(a["wk"], d ** -0.5),
                        wo=(a["wo"], (cfg.n_heads * hd) ** -0.5))
        for b in ("bq", "bk", "bv"):
            assert (b in a) == cfg.qkv_bias
            if b in a:
                assert not a[b].any()
    ffn = groups["l0"].get("ffn", {})
    if "dense" in ffn:
        f = ffn["dense"]
        want_std.update(w_gate=(f["w_gate"], d ** -0.5), w_down=(f["w_down"], cfg.d_ff ** -0.5))
    elif "moe" in ffn:
        f = ffn["moe"]
        want_std.update(router=(f["router"], 0.02), w_gate=(f["w_gate"], d ** -0.5),
                        w_up=(f["w_up"], d ** -0.5), w_down=(f["w_down"], cfg.moe_d_ff ** -0.5),
                        shared_w_down=(f["shared"]["w_down"],
                                       (cfg.n_shared_experts * cfg.moe_d_ff) ** -0.5))
    n_stack = (cfg.n_layers - cfg.first_k_dense) // len(cfg.block_pattern)
    for j, kind in enumerate(cfg.block_pattern):
        g = groups[f"l{j}"]
        if kind == "mamba":
            m = g["mamba"]
            assert not m["conv_b"].any() and not m["dt_bias"].any()
            assert torch.equal(m["d_skip"], torch.ones(n_stack, cfg.mamba_heads))
            torch.testing.assert_close(
                m["a_log"], torch.log(torch.linspace(1.0, 16.0, cfg.mamba_heads)).expand(n_stack, -1))
        elif kind == "mlstm":
            m = g["mlstm"]
            assert not m["b_i"].any() and torch.equal(m["b_f"], torch.ones(n_stack, cfg.n_heads))
            assert torch.equal(m["norm"], torch.ones_like(m["norm"]))
        elif kind == "slstm":
            assert not g["slstm"]["b"].any()
        if kind != "attn":
            want_std.update({f"l{j} {k}": v for k, v in _mixer_std(cfg, kind, g[kind]).items()})
        assert set(g) == ({"norm1", kind, "norm2", "ffn"} if kind in ("attn", "mamba")
                          else {"norm1", kind})
        for name in ("norm1", "norm2"):
            if name in g:
                assert torch.equal(g[name], torch.ones(n_stack, d))
    for i in range(cfg.first_k_dense):
        pre = params[f"prelude_{i}"]
        want_std[f"prelude_{i} w_down"] = (pre["ffn"]["dense"]["w_down"], cfg.dense_d_ff ** -0.5)
        for name in ("norm1", "norm2"):
            assert torch.equal(pre[name], torch.ones(d))
    for name, (t, std) in want_std.items():
        assert abs(float(t.std()) / std - 1.0) < 0.06, name
        assert abs(float(t.mean())) < 0.05 * std * 10, name
    assert torch.equal(params["final_norm"], torch.ones(d))
    bf = get_model(dataclasses.replace(cfg, dtype="bfloat16")).init_params(seed=3, device="cpu")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(bf)]
    for path, t in zip(paths, jax.tree.leaves(bf)):
        assert t.dtype == (torch.float32 if path.endswith("['a_log']") else torch.bfloat16), path


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m", "whisper-tiny",
                                  "internvl2-1b"])
def test_check_supported_still_refuses_unported_families(arch):
    """Nothing is refused any more: the recurrent families, the
    encoder-decoder and vision tokens build, full and reduced, with the
    reference's cache axes; the reduced config draws its weights and
    prefills a 3-token prompt (with its frames or patches) to finite
    logits."""
    for ref_cfg in (jconfigs.get_config(arch), jconfigs.get_reduced(arch)):
        cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
        m = get_model(cfg)
        assert m.cfg is cfg
        is_axes = lambda x: isinstance(x, tuple) and all(isinstance(i, str) for i in x)  # noqa: E731
        assert jax.tree.leaves(m.cache_axes(), is_leaf=is_axes) == \
            jax.tree.leaves(jget_model(ref_cfg).cache_axes(), is_leaf=is_axes)
    batch = {"tokens": torch.tensor([[1, 2, 3]])}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((1, cfg.n_audio_frames, cfg.d_model))
    if cfg.n_vision_tokens:
        batch["patches"] = torch.ones((1, cfg.n_vision_tokens, cfg.d_model))
    logits, _ = m.prefill(m.init_params(seed=0, device="cpu"), batch)
    assert logits.shape == (1, 1, cfg.padded_vocab) and torch.isfinite(logits).all()


def test_lm_params_from_arrays_keeps_bf16_bits():
    jcfg, _ = _pair("qwen2-7b", "bfloat16")
    params, _ = jget_model(jcfg).init_params(jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, params)
    port = lm_params_from_arrays(host, "cpu")
    for a, t in zip(jax.tree.leaves(host), jax.tree.leaves(port)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
