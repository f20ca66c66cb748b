"""The port's training path (`repro_torch.training`, `repro_torch.data`,
the train mode of `repro_torch.models` and `repro_torch.launch.train`)
against the JAX reference, on the CPU.

The first tests mirror `tests/test_training.py` on the port alone.  The
parity tests give both sides the same inputs: the reference's random
weights of a reduced config in float32 (carried over by
`convert.lm_params_from_arrays`) and the reference's batches (its
`make_batch` draws from `jax.random`, the port's from a `torch.Generator`,
so the port's own batches are checked by signature and distribution).
Tolerances: the loss within rtol 1e-5 and every gradient leaf within
1e-4 x its largest magnitude + 1e-7, on the reduced config of each family
(dense, MoE with a dense prelude, Mamba hybrid, xLSTM, encoder-decoder,
VLM); an optimizer update within 1e-6 when both optimizers get the
reference's gradients; `quantize_grads` and `_zipf_probs` exact.

No test here changes global state (JAX config, environment, torch
defaults, grad or deterministic mode, threads, working directory); the
autouse fixture checks the first five after every test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch import train as jtrain
from repro.models.api import get_model as jget_model
from repro.nn import core as jnn
from repro.training import optimizer as jopt
from repro_torch import configs, tree
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as train_mod
from repro_torch.models.api import get_model
from repro_torch.nn import core as nn
from repro_torch.obs import Observability
from repro_torch.training.optimizer import (Adafactor, AdafactorState, AdamW, AdamWState,
                                            global_norm, quantize_grads)
from repro_torch.training.train_step import make_eval_step, make_train_step

FAMILIES = ("internlm2-1.8b", "deepseek-moe-16b", "jamba-1.5-large-398b", "xlstm-125m",
            "whisper-tiny", "internvl2-1b")


def _global_state():
    return (jax.config.jax_enable_x64, jax.config.jax_threefry_partitionable,
            torch.get_default_dtype(), torch.is_grad_enabled(),
            torch.are_deterministic_algorithms_enabled())


@pytest.fixture(autouse=True)
def _leaves_global_state_alone():
    before = _global_state()
    yield
    assert _global_state() == before


def _f32(arch: str):
    """(reference cfg, port cfg) of the reduced ``arch`` in float32."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


_REF: dict = {}


def _ref_params(arch: str):
    """The reference's random weights of the reduced f32 config, as (jax
    tree, numpy tree); port trees are fresh copies (`_port_params`), since
    the optimizers update in place."""
    if arch not in _REF:
        jcfg, _ = _f32(arch)
        jp = jax.jit(lambda key: jget_model(jcfg).init_params(key)[0])(jax.random.PRNGKey(0))
        _REF[arch] = (jp, jax.tree.map(np.asarray, jp))
    return _REF[arch]


def _port_params(arch: str):
    return lm_params_from_arrays(_ref_params(arch)[1], "cpu")


def _ref_batch(cfg, B: int = 2, S: int = 16, step: int = 0):
    """The reference's batch (and a VLM's patches or whisper's frames from
    a seeded numpy rng) as (jax dict, torch dict)."""
    jb = dict(jpipeline.make_batch(jpipeline.DataConfig(cfg.vocab_size, S, B), step))
    jb = jtrain.add_batch_extras(jb, cfg, B, np.random.default_rng(step))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _np(x):
    return np.asarray(x) if isinstance(x, jax.Array) else x.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# Mirrors of tests/test_training.py
# ---------------------------------------------------------------------------

def _quadratic_problem():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    loss = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2    # noqa: E731
    return params, loss


def _grad(loss, params):
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad():
        g = torch.autograd.grad(loss(tree.unflatten(params, leaves)), leaves)
    return tree.unflatten(params, list(g))


@pytest.mark.parametrize("opt", [AdamW(lr=0.1, warmup_steps=1), Adafactor(lr=0.1)],
                         ids=["adamw", "adafactor"])
def test_optimizer_descends(opt):
    params, loss = _quadratic_problem()
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(50):
        params, state, _ = opt.update(_grad(loss, params), state, params)
    assert float(loss(params)) < 0.05 * l0


def test_grad_clipping():
    opt = AdamW(grad_clip=1.0, warmup_steps=1)
    params, loss = _quadratic_problem()
    state = opt.init(params)
    big = tree.map(lambda g: g * 1e6, _grad(loss, params))
    _, _, gnorm = opt.update(big, state, params)
    assert float(gnorm) > 1e5  # reported pre-clip norm


def test_quantize_grads_small_error():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
    q8 = quantize_grads(g, bits=8)
    err = float((q8["a"] - g["a"]).abs().max())
    scale = float(g["a"].abs().max()) / 127
    assert err <= scale * 0.51 + 1e-7


def _descends(arch, steps, bits=None):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    model = get_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=5)
    params = model.init_params(seed=0, device="cpu")
    state = opt.init(params)
    step = make_train_step(model, opt, grad_compression_bits=bits)
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, pipeline.make_batch(dc, i))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    return losses


def test_train_step_reduces_loss_end_to_end():
    losses = _descends("internlm2-1.8b", 30)
    assert losses[-1] < losses[0] - 0.1, losses[::10]


def test_train_step_spans():
    """The step runs under ``netmcp.train_step``, the optimizer's update
    under ``netmcp.optimizer`` inside it."""
    cfg = dataclasses.replace(configs.get_reduced("internlm2-1.8b"), dtype="float32")
    model = get_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=5)
    params = model.init_params(seed=0, device="cpu")
    obs = Observability(trace=True)
    step = make_train_step(model, opt, obs=obs)
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    step(params, opt.init(params), pipeline.make_batch(dc, 0))
    inner, outer = obs.tracer.events
    assert (inner["name"], outer["name"]) == ("netmcp.optimizer", "netmcp.train_step")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_grad_compression_trains():
    losses = _descends("yi-6b", 20, bits=8)
    assert losses[-1] < losses[0]


def test_pipeline_deterministic_and_sharded():
    dc = pipeline.DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    b1, b2 = pipeline.make_batch(dc, 3), pipeline.make_batch(dc, 3)
    assert (b1["tokens"] == b2["tokens"]).all()
    b3 = pipeline.make_batch(dc, 4)
    assert not (b1["tokens"] == b3["tokens"]).all()
    assert (b1["labels"][:, -1] == -100).all()
    s0 = pipeline.host_shard(b1, 0, 2)
    s1 = pipeline.host_shard(b1, 1, 2)
    assert s0["tokens"].shape[0] == 4
    assert not torch.equal(s0["tokens"], s1["tokens"])


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _port_loss_and_grads(arch, cfg, batch):
    m = get_model(cfg)
    p = _port_params(arch)
    leaves = [t.requires_grad_(True) for t in tree.leaves(p)]
    with torch.enable_grad():
        loss, metrics = m.loss(p, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads


_REF_GRADS: dict = {}


def _ref_loss_and_grads(arch):
    if arch not in _REF_GRADS:
        jcfg, cfg = _f32(arch)
        jb, _ = _ref_batch(cfg)
        vg = jax.jit(jax.value_and_grad(jget_model(jcfg).loss, has_aux=True))
        (jl, jmet), jg = vg(_ref_params(arch)[0], jb)
        _REF_GRADS[arch] = (jl, jmet, jg)
    return _REF_GRADS[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """Model.loss and every gradient leaf against the reference's on its
    weights and batch: loss rtol 1e-5 (the MoE's aux and a VLM's labels
    padded over the patches included), grads 1e-4 x max|leaf| + 1e-7."""
    jcfg, cfg = _f32(arch)
    _, batch = _ref_batch(cfg)
    jl, jmet, jg = _ref_loss_and_grads(arch)
    loss, metrics, grads = _port_loss_and_grads(arch, cfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert sorted(metrics) == sorted(jmet)
    assert int(metrics["n_tokens"]) == int(jmet["n_tokens"])
    if cfg.n_experts:
        assert float(jmet["aux"]) > 0
        np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]), rtol=1e-5)
    names = [n for n, _ in tree.flatten_with_path(_port_params(arch))]
    for name, g, jgl in zip(names, grads, jax.tree.leaves(jg)):
        want = np.asarray(jgl)
        assert g.shape == want.shape, name
        tol = 1e-4 * float(np.abs(want).max()) + 1e-7
        np.testing.assert_allclose(_np(g), want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_and_chunk_checkpoints_keep_values(remat):
    """Rematerialisation and the chunked attention's per-chunk checkpoints
    change memory, not values: the loss and the grads under each ``remat``,
    with 8-row chunks over 32 positions, equal the naive path's (summation
    order aside)."""
    arch = "internlm2-1.8b"
    _, cfg = _f32(arch)
    _, batch = _ref_batch(cfg, S=32)
    base = _port_loss_and_grads(arch, dataclasses.replace(cfg, remat="none"), batch)
    cfg2 = dataclasses.replace(cfg, remat=remat, attn_impl="chunked", attn_chunk=8)
    got = _port_loss_and_grads(arch, cfg2, batch)
    np.testing.assert_allclose(float(got[0]), float(base[0]), rtol=1e-6)
    for a, b in zip(got[2], base[2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-5 * float(b.abs().max()) + 1e-8)


def _optimizer_pair(kind):
    if kind == "adamw":
        return jopt.AdamW(lr=1e-3, warmup_steps=3), AdamW(lr=1e-3, warmup_steps=3)
    return jopt.Adafactor(lr=1e-3), Adafactor(lr=1e-3)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(kind):
    """Two updates with the reference's gradients (clipped: their norm is
    above 1) fed to both optimizers: parameters, moments and step within
    1e-6, the reported norm within 1e-6 relative.  Feeding each side its
    own gradients would not do: at step 1 an Adam step is about lr·sign(g)
    and a gradient near 0 can flip sign."""
    arch = "internlm2-1.8b"
    jo, o = _optimizer_pair(kind)
    jp = _ref_params(arch)[0]
    p = _port_params(arch)
    jg = _ref_loss_and_grads(arch)[2]
    g = lm_params_from_arrays(jax.tree.map(np.asarray, jg), "cpu")
    js, s = jo.init(jp), o.init(p)
    jupdate = jax.jit(jo.update)
    for i in range(2):
        scale = 1.0 if i == 0 else 0.5
        jp, js, jn = jupdate(jax.tree.map(lambda a: a * scale, jg), js, jp)
        p, s, n = o.update(tree.map(lambda t: t * scale, g), s, p)
        assert float(jn) > 1.0
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for (name, got), want in zip(tree.flatten_with_path((p, s)),
                                     jax.tree.leaves((jp, js))):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=f"update {i}: {name}")
    assert isinstance(s, AdamWState if kind == "adamw" else AdafactorState)
    assert s.step.dtype == torch.int32 and int(s.step) == 2


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32) * 4
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    labels[0, 1] = labels[2, :] = -100
    for lab in (labels, np.full_like(labels, -100)):
        for z in (0.0, 1e-2):
            want, wn = jnn.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab), z_loss=z)
            got, n = nn.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                                              z_loss=z)
            assert int(n) == int(wn)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    assert float(nn.softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.full((3, 5), -100))[0]) == 0.0


def test_quantize_grads_bit_equal_to_reference():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((33, 65)) * rng.uniform(0.1, 10)).astype(np.float32)
    a[3, 4] = 0.0
    for bits in (8, 4):
        want = np.asarray(jopt.quantize_grads({"g": jnp.asarray(a)}, bits)["g"])
        got = quantize_grads({"g": torch.from_numpy(a)}, bits)["g"].numpy()
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint32),
                                                          want.view(np.uint32))


def test_zipf_probs_byte_equal_to_reference():
    for vocab, alpha in ((4096, 1.1), (512, 1.1), (1000, 0.9)):
        want = jpipeline._zipf_probs(vocab, alpha)
        got = pipeline._zipf_probs(vocab, alpha)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_make_batch_signature_and_distribution():
    """The port's batches against the reference's by signature and
    distribution (the bits differ by design): int32 [B, S] tokens in range,
    labels the tokens rolled left with -100 last; over 8192 positions the
    copy share is 0.5 ± 0.03 and the most frequent base token's share
    within 0.02 of `_zipf_probs[0]` (redrawn from the same generator), and
    the rate of repeated neighbours is the reference's within 0.02."""
    dc = pipeline.DataConfig(vocab_size=92544, seq_len=1024, global_batch=8, seed=3)
    jdc = jpipeline.DataConfig(vocab_size=92544, seq_len=1024, global_batch=8, seed=3)
    b, jb = pipeline.make_batch(dc, 7), jpipeline.make_batch(jdc, 7)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32 and tuple(b[k].shape) == tuple(jb[k].shape)
    tok = b["tokens"]
    assert int(tok.min()) >= 0 and int(tok.max()) < 4096
    assert torch.equal(b["labels"][:, :-1], tok[:, 1:]) and (b["labels"][:, -1] == -100).all()
    gen = pipeline._generator(dc.seed, 7)
    probs = torch.from_numpy(pipeline._zipf_probs(4096, dc.zipf_alpha))
    base = torch.multinomial(probs, tok.numel(), replacement=True, generator=gen).reshape(8, 1024)
    copy = torch.rand((8, 1024), generator=gen) < 0.5
    assert torch.equal(tok, torch.where(copy, torch.roll(base, 1, dims=1), base).to(torch.int32))
    assert abs(float(copy.float().mean()) - 0.5) <= 0.03
    assert abs(float((base == 0).float().mean()) - float(probs[0])) <= 0.02
    rep = float((tok[:, 1:] == tok[:, :-1]).float().mean())
    jt = np.asarray(jb["tokens"])
    jrep = float((jt[:, 1:] == jt[:, :-1]).mean())
    assert abs(rep - jrep) <= 0.02, (rep, jrep)


def test_train_loop_matches_reference_on_its_batches(monkeypatch):
    """The port's `train_loop` on the reduced internlm2 (f32) gives the
    reference's `train_loop` losses within 1e-4 when it starts from the
    reference's weights and draws the reference's batches (its `get_model`
    and `make_batch` patched for this test only); the fleet monitor sees
    the same injected failures."""
    arch = "internlm2-1.8b"
    jcfg, cfg = _f32(arch)
    kw = dict(steps=4, global_batch=2, seq_len=16, log_every=100, inject_failures=True)
    want = jtrain.train_loop(jcfg, **kw)

    class _RefWeights(type(get_model(cfg))):
        def init_params(self, seed=0, device=None):
            return _port_params(arch)

    def ref_batch(dc, step):
        jb = jpipeline.make_batch(jpipeline.DataConfig(dc.vocab_size, dc.seq_len,
                                                       dc.global_batch, dc.seed), step)
        return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}

    monkeypatch.setattr(train_mod, "get_model", lambda c: _RefWeights(cfg=c))
    monkeypatch.setattr(train_mod, "make_batch", ref_batch)
    got = train_mod.train_loop(cfg, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_launcher_main_on_cpu(capsys):
    train_mod.main(["--arch", "internlm2-1.8b", "--steps", "12", "--batch", "8", "--seq", "32",
                    "--device", "cpu", "--inject-failures"])
    out = capsys.readouterr().out
    assert "final loss" in out and "[inject] pod 2 crashed at step 6" in out


# ---------------------------------------------------------------------------
# The flash kernel is forward only
# ---------------------------------------------------------------------------

def test_flash_refuses_grad_and_serves_the_eval_step():
    """Under grad an attention kernel call with an operand that requires
    grad raises (the reference's Pallas kernel has no VJP either: `jax.grad`
    through it raises); under `torch.no_grad()` the eval step runs it, and
    its loss equals the chunked path's."""
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.decode_attention(q[:, :, 0], k, v, torch.full((1,), 8))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape
    arch = "internlm2-1.8b"
    _, cfg = _f32(arch)
    _, batch = _ref_batch(cfg)
    pallas = get_model(dataclasses.replace(cfg, attn_impl="pallas"))
    opt = AdamW()
    params = _port_params(arch)
    with pytest.raises(RuntimeError, match="forward only"):
        make_train_step(pallas, opt)(params, opt.init(params), batch)
    assert not any(t.requires_grad for t in tree.leaves(params))
    got = make_eval_step(pallas)(params, batch)["loss"]
    want = make_eval_step(get_model(dataclasses.replace(cfg, attn_impl="chunked",
                                                        attn_chunk=4)))(params, batch)["loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
