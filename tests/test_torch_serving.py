"""The port's `ServeEngine` against the JAX reference's, on the CPU.

Both engines serve the same float32 reduced model (the reference's random
weights carried over by `convert.lm_params_from_arrays`) and the same
requests.  The generated tokens must be equal: for one request (as
`tests/test_serving.py::test_engine_matches_manual_decode`) and for five
requests of different prompt lengths through two slots, which exercises
slot reuse and the uniform decode length (every slot decodes at the
largest active length and a shorter slot attends over the zeroed tail of
its cache).  The registries' engine counters must be equal too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.models.api import get_model
from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.serving.engine import Request, ServeEngine, insert_slot, pad_cache_to_capacity

_MODELS: dict = {}


def _models(arch):
    """(reference model, reference params, port config, port params), f32."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
        jm = jget_model(jcfg)
        jp, _ = jm.init_params(jax.random.PRNGKey(0))
        cfg = model_config_from_dict(dataclasses.asdict(jcfg))
        _MODELS[arch] = (jm, jp, cfg, lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[arch]


def _prompts(n, lengths, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lengths[i % len(lengths)]).astype(np.int32) for i in range(n)]


def _serve_both(arch, prompts, max_new, n_slots, cap, impl="naive"):
    jm, jp, cfg, p = _models(arch)
    jeng = JServeEngine(jm, jp, n_slots=n_slots, cap=cap)
    eng = ServeEngine(get_model(dataclasses.replace(cfg, attn_impl=impl)), p, n_slots=n_slots,
                      cap=cap, device="cpu")
    jreqs = [JRequest(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=max_new[i]) for i, t in enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    return jeng, eng, jreqs, reqs, jeng.run(), eng.run()


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_engine_matches_reference_single_request(impl):
    jm, jp, cfg, _ = _models("internlm2-1.8b")
    prompt = _prompts(1, [8], 0, cfg.vocab_size)
    _, eng, jreqs, reqs, jsteps, steps = _serve_both("internlm2-1.8b", prompt, [5], 2, 64, impl)
    assert reqs[0].done and jreqs[0].done
    assert reqs[0].generated == jreqs[0].generated and len(reqs[0].generated) == 5
    assert steps == jsteps


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-7b"])
def test_engine_matches_reference_continuous_batching(arch, impl):
    """5 requests through 2 slots; prompts of 3 to 11 tokens, so a slot that
    held a long request is reused by a shorter one and decode steps mix
    lengths."""
    _, _, cfg, _ = _models(arch)
    prompts = _prompts(5, [11, 4, 3, 9, 6], 1, cfg.vocab_size)
    max_new = [3 + i % 3 for i in range(5)]
    jeng, eng, jreqs, reqs, jsteps, steps = _serve_both(arch, prompts, max_new, 2, 32, impl)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in reqs)
    assert steps == jsteps
    assert eng.obs.registry.snapshot() == jeng.obs.registry.snapshot()


def test_reused_slot_tail_is_zero_and_evicted_at_capacity():
    """A short request admitted into a slot that held a long one sees zeros
    past its own length; a request that reaches the cache capacity is
    evicted, as in the reference."""
    _, _, cfg, p = _models("internlm2-1.8b")
    eng = ServeEngine(get_model(cfg), p, n_slots=1, cap=16, device="cpu")
    long_req, short_req = Request(0, np.arange(1, 13), max_new_tokens=2), \
        Request(1, np.arange(1, 4), max_new_tokens=30)
    eng.submit(long_req)
    eng.submit(short_req)
    eng.step()                      # admits the long request; its second token ends it
    k = eng.cache["groups"]["l0"][0]
    assert k[:, 0, :13].abs().sum() > 0
    assert long_req.done and eng.slot_req[0] is None
    eng._admit()                    # the short one takes the slot
    assert not k[:, 0, 3:].any() and k[:, 0, :3].abs().sum() > 0
    eng.drain()
    assert short_req.done and len(short_req.generated) == 16 - 3   # stopped by cap, not 30


def test_drain_pending_and_tracer():
    _, _, cfg, p = _models("internlm2-1.8b")
    reg = MetricsRegistry()
    eng = ServeEngine(get_model(cfg), p, n_slots=2, cap=32, device="cpu",
                      obs=Observability(trace=True, registry=reg))
    assert eng.pending == 0 and eng.drain() == 0
    prompts = _prompts(3, [5, 7], 2, cfg.vocab_size)
    for i, t in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=t, max_new_tokens=4))
    assert eng.pending == 3 and reg.value("engine_queue_depth") == 3
    eng.step()
    assert eng.pending == 3 and reg.value("engine_active_slots") == 2
    assert reg.value("engine_queue_depth") == 1
    steps = eng.drain()
    assert eng.pending == 0 and steps > 0
    assert reg.value("engine_admitted_total") == 3 == reg.value("engine_completed_total")
    assert reg.value("engine_tokens_total") == 12
    names = [e["name"] for e in eng.obs.tracer.events]
    assert names.count("netmcp.prefill") == 3 and names.count("netmcp.decode_step") == 1 + steps
    with pytest.raises(RuntimeError, match="drain incomplete"):
        eng.submit(Request(rid=9, tokens=prompts[0], max_new_tokens=20))
        eng.drain(max_steps=2)


def test_engine_spans_nest_and_carry_the_wait():
    """With the tracer on: one ``netmcp.admit`` per request (rid, slot,
    prompt_len, wait_ms since submit) holding its prefill and slot insert,
    and each decode step's ``decode_step`` followed by its ``decode_read``."""
    _, _, cfg, p = _models("internlm2-1.8b")
    obs = Observability(trace=True)
    eng = ServeEngine(get_model(cfg), p, n_slots=2, cap=32, device="cpu", obs=obs)
    prompts = _prompts(3, [5, 7], 4, cfg.vocab_size)
    reqs = [Request(rid=10 + i, tokens=t, max_new_tokens=3) for i, t in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
        assert r.submitted_ms is not None
    steps = eng.drain()
    ev = obs.tracer.events

    def end(e):
        return e["ts"] + e["dur"]

    admits = [e for e in ev if e["name"] == "netmcp.admit"]
    assert [a["args"]["rid"] for a in admits] == [10, 11, 12]
    assert [a["args"]["slot"] for a in admits] == [0, 1, 0]
    assert [a["args"]["prompt_len"] for a in admits] == [5, 7, 5]
    for a, r in zip(admits, reqs):
        assert a["args"]["wait_ms"] == pytest.approx(a["ts"] / 1e3 - r.submitted_ms)
        assert a["args"]["wait_ms"] >= 0.0
        inner = [e["name"] for e in ev if e is not a and a["ts"] <= e["ts"] and end(e) <= end(a)]
        assert inner == ["netmcp.prefill", "netmcp.slot_insert"], inner
    assert admits[2]["args"]["wait_ms"] > admits[0]["args"]["wait_ms"]   # waited for a slot
    decode = [e["name"] for e in ev if e["name"] in ("netmcp.decode_step", "netmcp.decode_read")]
    assert decode == ["netmcp.decode_step", "netmcp.decode_read"] * steps
    pairs = [e for e in ev if e["name"].startswith("netmcp.decode_")]
    assert all(end(a) <= b["ts"] for a, b in zip(pairs, pairs[1:]))
    # off, the engine stamps nothing
    quiet = ServeEngine(get_model(cfg), p, n_slots=2, cap=32, device="cpu")
    r = Request(rid=0, tokens=prompts[0], max_new_tokens=2)
    quiet.submit(r)
    quiet.drain()
    assert r.submitted_ms is None and quiet.obs.tracer.events == []


def test_cache_helpers_and_device_rule(monkeypatch):
    m = get_model(_models("internlm2-1.8b")[2])
    axes = m.cache_axes()
    small = {"groups": {"l0": tuple(torch.ones((2, 1, 5, 2, 16)) for _ in range(2))}}
    full = pad_cache_to_capacity(small, axes, 5)
    assert full["groups"]["l0"][0] is small["groups"]["l0"][0]          # no-op at capacity
    padded = pad_cache_to_capacity(small, axes, 9)
    assert padded["groups"]["l0"][1].shape == (2, 1, 9, 2, 16)
    assert not padded["groups"]["l0"][1][:, :, 5:].any()
    big = m.init_cache(3, 9, device="cpu")
    out = insert_slot(big, axes, padded, 1)
    assert out["groups"]["l0"][0] is big["groups"]["l0"][0]              # in place
    assert big["groups"]["l0"][0][:, 1, :5].eq(1).all()
    assert not big["groups"]["l0"][0][:, 0].any() and not big["groups"]["l0"][0][:, 2].any()
    p = _models("internlm2-1.8b")[3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(m, p, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_params(seed=0)
    eng = ServeEngine(m, p, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(0, np.arange(8)))
    with pytest.raises(ValueError, match="extras"):      # a text model takes none
        eng.submit(Request(0, np.arange(3), extras={"patches": np.zeros(3)}))
