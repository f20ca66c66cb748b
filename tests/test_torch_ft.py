"""The port's fault tolerance (`repro_torch.ft`) and the training driver's
restart path against the JAX reference, on the CPU.

The first tests mirror `tests/test_ft.py` on the port alone.  Then a
checkpoint crosses in both directions: the reference saves (params,
AdamWState) of a reduced model and the port restores it into its own
template, and the other way round, bf16 bit for bit; the manifests name
the same leaves.  The fleet monitor, fed the reference's failure draws
(equal by construction: both injectors are numpy ``default_rng``s), scores
within the QoS tolerance (rtol 2e-6 / atol 2e-7) and keeps the same
healthy set at every step.  Every file goes to ``tmp_path``; no test
changes global state, which the autouse fixture checks.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ft import checkpoint as jckpt
from repro.ft import failure as jfailure
from repro.models.api import get_model as jget_model
from repro.training import optimizer as jopt
from repro_torch import configs, tree
from repro_torch.convert import lm_params_from_arrays, model_config_from_dict
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.failure import FailureInjector, FleetMonitor, plan_elastic
from repro_torch.models.api import get_model
from repro_torch.training.optimizer import AdamW, AdamWState

QOS_TOL = dict(rtol=2e-6, atol=2e-7)


def _global_state():
    return (jax.config.jax_enable_x64, jax.config.jax_threefry_partitionable,
            torch.get_default_dtype(), torch.is_grad_enabled(),
            torch.are_deterministic_algorithms_enabled())


@pytest.fixture(autouse=True)
def _leaves_global_state_alone():
    before = _global_state()
    yield
    assert _global_state() == before


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))},
        "step": torch.tensor(7, dtype=torch.int32),
        "scale": (torch.tensor(1.5), torch.tensor([2.0, 3.0], dtype=torch.bfloat16)),
    }


# ---------------------------------------------------------------------------
# Mirrors of tests/test_ft.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t, {"next_step": 11})
    restored, extras = ckpt.restore(str(tmp_path), 10, t)
    assert extras["next_step"] == 11
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_overwrite(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 5, _tree(0))
    ckpt.save(str(tmp_path), 20, _tree(1))
    assert ckpt.latest_step(str(tmp_path)) == 20
    ckpt.save(str(tmp_path), 20, _tree(2))  # idempotent overwrite
    assert ckpt.latest_step(str(tmp_path)) == 20
    restored, _ = ckpt.restore(str(tmp_path), 20, _tree(0))
    assert torch.equal(restored["layer"]["w"], _tree(2)["layer"]["w"])


def test_incomplete_checkpoint_ignored(tmp_path):
    os.makedirs(tmp_path / "step_99")  # no manifest -> incomplete
    ckpt.save(str(tmp_path), 3, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 3


def _monitor(n_pods, **kw):
    return FleetMonitor(n_pods=n_pods, base_step_s=1.0, device="cpu", **kw)


def test_monitor_flags_crash():
    mon = _monitor(4)
    inj = FailureInjector(4, base_step_s=1.0)
    inj.crash(2)
    for _ in range(8):
        mon.record(inj.step_times())
    scores = mon.scores()
    assert scores[2] == -1.0
    assert 2 not in mon.healthy_pods()
    assert set(mon.healthy_pods()) >= {0, 1, 3}


def test_monitor_flags_straggler():
    mon = _monitor(4)
    inj = FailureInjector(4, base_step_s=1.0, seed=1)
    inj.straggle(1, factor=8.0)
    for _ in range(20):
        mon.record(inj.step_times())
    assert 1 not in mon.healthy_pods()


def test_elastic_plan_rescales_batch():
    mon = _monitor(4)
    inj = FailureInjector(4, base_step_s=1.0)
    inj.crash(0)
    for _ in range(8):
        mon.record(inj.step_times())
    plan = plan_elastic(mon, global_batch=256, prev_healthy=[0, 1, 2, 3])
    assert plan.changed and plan.n_pods == 3
    assert plan.per_pod_batch == 85


def test_healed_pod_rejoins():
    mon = _monitor(2, history=16)
    inj = FailureInjector(2, base_step_s=1.0)
    inj.crash(1)
    for _ in range(6):
        mon.record(inj.step_times())
    assert 1 not in mon.healthy_pods()
    inj.heal(1)
    for _ in range(30):
        mon.record(inj.step_times())
    assert 1 in mon.healthy_pods()


def test_never_empty_fleet():
    mon = _monitor(2)
    inj = FailureInjector(2, base_step_s=1.0)
    inj.crash(0)
    inj.crash(1)
    for _ in range(8):
        mon.record(inj.step_times())
    plan = plan_elastic(mon, global_batch=64)
    assert plan.n_pods >= 1


def test_train_loop_restart_resumes(tmp_path):
    """End-to-end: train, "restart" (a fresh loop), resume from the latest
    checkpoint instead of retraining."""
    from repro_torch.launch.train import train_loop

    cfg = configs.get_reduced("xlstm-125m")
    train_loop(cfg, steps=6, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=3,
               device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 6
    losses = train_loop(cfg, steps=8, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path),
                        ckpt_every=3, device="cpu")
    assert len(losses) == 2  # only steps 6,7 ran


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _reduced_pair(arch="deepseek-moe-16b"):
    """The reduced config in its own dtype (bf16): (reference cfg, port cfg,
    the reference's weights and AdamW state, one update in, so the moments
    and the step are not zero)."""
    jcfg = jconfigs.get_reduced(arch)
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(lambda key: jget_model(jcfg).init_params(key)[0])(jax.random.PRNGKey(0))
    jo = jopt.AdamW(warmup_steps=2)
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), jp)
    jp, js, _ = jo.update(grads, jo.init(jp), jp)
    return jcfg, cfg, jp, js


def _port_template(cfg):
    params = get_model(cfg).init_params(seed=1, device="cpu")
    return params, AdamW().init(params)


def _leaf_names(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return sorted(n for s in json.load(f)["shards"] for n in s["leaves"])


def test_reference_checkpoint_restores_into_port(tmp_path):
    """The reference saves (params, AdamWState) of reduced deepseek-moe
    (bf16 weights, f32 moments, an int32 step); the port restores it into
    its own template: every leaf equal to the converted array, bf16 bit for
    bit, and the same leaf names as a manifest the port writes."""
    jcfg, cfg, jp, js = _reduced_pair()
    jpath = jckpt.save(str(tmp_path / "ref"), 4, (jp, js), {"next_step": 5})
    like = _port_template(cfg)
    (params, state), extras = ckpt.restore(str(tmp_path / "ref"), 4, like)
    assert extras == {"next_step": 5} and isinstance(state, AdamWState)
    want = lm_params_from_arrays({"p": jax.tree.map(np.asarray, jp),
                                  "m": jax.tree.map(np.asarray, js.m),
                                  "v": jax.tree.map(np.asarray, js.v)}, "cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == int(js.step) == 1
    for got, exp, tmpl in zip(tree.leaves((params, state.m, state.v)),
                              tree.leaves((want["p"], want["m"], want["v"])),
                              tree.leaves((like[0], like[1].m, like[1].v))):
        assert got.dtype == exp.dtype == tmpl.dtype and torch.equal(got, exp)
    assert any(t.dtype == torch.bfloat16 for t in tree.leaves(params))
    path = ckpt.save(str(tmp_path / "port"), 4, (params, state))
    assert _leaf_names(path) == _leaf_names(jpath)


def test_port_checkpoint_restores_into_reference(tmp_path):
    """The port saves its (params, AdamWState) after an update; the
    reference's `restore` reads it back into its own template equal, bf16
    bit for bit."""
    jcfg, cfg, jp, js = _reduced_pair()
    params, state = _port_template(cfg)
    opt = AdamW(warmup_steps=2)
    params, state, _ = opt.update(tree.map(lambda t: torch.full_like(t, 0.01), params), state,
                                  params)
    ckpt.save(str(tmp_path), 9, (params, state), {"next_step": 10})
    (rp, rs), extras = jckpt.restore(str(tmp_path), 9, (jp, js))
    assert extras == {"next_step": 10}
    for got, exp in zip(jax.tree.leaves((rp, rs)), tree.leaves((params, state))):
        exp = exp.numpy() if exp.dtype != torch.bfloat16 else \
            exp.view(torch.int16).numpy().view(np.uint16)
        got = np.asarray(got)
        got = got.view(np.uint16) if got.dtype.name == "bfloat16" else got
        assert got.dtype == exp.dtype and np.array_equal(got, exp)


def test_fleet_monitor_matches_reference():
    """Both monitors record the same injected step times (a straggler from
    step 5, a crash from step 12, the crash healed at step 30): scores
    within the QoS tolerance and equal healthy sets and elastic plans at
    every step; the injectors' draws are equal."""
    n, steps = 6, 48
    inj, jinj = FailureInjector(n, 1.0, seed=4), jfailure.FailureInjector(n, 1.0, seed=4)
    mon, jmon = _monitor(n), jfailure.FleetMonitor(n, base_step_s=1.0)
    healthy, jhealthy = list(range(n)), list(range(n))
    for step in range(steps):
        for i in (inj, jinj):
            if step == 5:
                i.straggle(1, factor=8.0)
            if step == 12:
                i.crash(4)
            if step == 30:
                i.heal(4)
        t, jt = inj.step_times(), jinj.step_times()
        assert np.array_equal(t, jt)
        mon.record(t)
        jmon.record(jt)
        np.testing.assert_allclose(mon.scores(), jmon.scores(), **QOS_TOL, err_msg=f"{step}")
        plan = plan_elastic(mon, 64, healthy)
        jplan = jfailure.plan_elastic(jmon, 64, jhealthy)
        assert plan.healthy == [int(i) for i in jplan.healthy], step
        assert (plan.n_pods, plan.per_pod_batch, plan.changed) == \
            (jplan.n_pods, jplan.per_pod_batch, jplan.changed)
        healthy, jhealthy = plan.healthy, jplan.healthy
    assert 1 not in healthy and 4 in healthy
