"""Training driver: the port's train step on batches from the seed, back to back.

Set-up builds one training state: the weights drawn from the seed
(`perfbench.reference.lm.make_params`, in the configuration's dtype, on
the card), the program's AdamW state, its train step
(`repro_torch.training.train_step.make_train_step`) and the fleet
monitor that `repro_torch.launch.train` runs beside it (one QoS kernel
call a step).  It drives that state through the first ``checked_steps``
steps of the seed's batches with the window's own call, reading the loss
of each, the first gradient as the optimizer holds it after step one
(its first moment over 1 - b1) and the parameters' change after the
last, then hands the same state to the window.  The window runs further
steps back to back, a fresh batch each, for ``--seconds``.

After the window the program's state is freed and the plain reference
(`perfbench.reference.lm`, float32 products) trains the same weights on
the same batches for the checked steps; the losses, the per-leaf
gradient norms and the per-leaf change norms are compared (`readings`).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from perfbench.harness import core
from perfbench.harness.trace import profiled
from perfbench.reference import lm as ref
from perfbench.traffic import tokens as traffic


def program_config(ctx_config: dict, spec: dict):
    """The program's `ModelConfig` of a configuration file, run as the cell
    states (``spec["program"]``)."""
    from repro_torch.models.config import ModelConfig

    m = ctx_config["model"]
    p = spec["program"]
    return ModelConfig(
        name=ctx_config["name"], family="dense", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], head_dim=m.get("head_dim"),
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=m["torch_dtype"],
        remat=p.get("remat", "full"), attn_impl=p["attn_impl"],
        attn_chunk=p.get("attn_chunk", 512),
    )


def program_tree(model, P: dict) -> dict:
    """The benchmark's leaves (the same tensors, no copies) in the
    program's parameter tree, matched by each leaf's last key; a leaf the
    benchmark does not make, or a shape that differs, raises."""
    from repro_torch import tree

    abstract = model.init_params(abstract=True)
    leaves = []
    for path, meta in tree.flatten_with_path(abstract):
        name = path.rsplit("['", 1)[1].rstrip("']")
        if name not in P or tuple(P[name].shape) != tuple(meta.shape):
            raise ValueError(f"perfbench: the program's leaf {path} {tuple(meta.shape)} has no "
                             f"counterpart among the benchmark's weights")
        leaves.append(P[name])
    return tree.unflatten(abstract, leaves)


def _change_norms(P: dict, dm: dict, seed: int, dtype) -> dict:
    """Per leaf, the norm of its change since the seed's draw."""
    out = {}
    for name, p in P.items():
        p0 = ref.make_leaf(dm, name, seed, p.device, dtype)
        out[name] = float(torch.linalg.vector_norm(p.detach().float() - p0.float()))
        del p0
    return out


def _batch(ctx, step: int, dm: dict) -> dict:
    t = ctx.spec["mix"]
    return traffic.batch(ctx.seed, step, t["batch"], t["seq_len"], dm["vocab"], t["zipf_alpha"])


class Program:
    """The program's training state and the window's call."""

    def __init__(self, ctx, dm: dict):
        from repro_torch.ft.failure import FailureInjector, FleetMonitor
        from repro_torch.models.api import get_model
        from repro_torch.training.optimizer import AdamW
        from repro_torch.training.train_step import make_train_step

        self.ctx, self.dm = ctx, dm
        p = ctx.spec["program"]
        self.dtype = getattr(torch, ctx.config["model"]["torch_dtype"])
        model = get_model(program_config(ctx.config, ctx.spec))
        self.P = ref.make_params(dm, ctx.seed, ctx.device, self.dtype)
        self.params = program_tree(model, self.P)
        self.opt = AdamW(**p["optimizer"])
        self.opt_state = self.opt.init(self.params)
        self.step_fn = make_train_step(model, self.opt)
        self.monitor = FleetMonitor(p["n_pods"], base_step_s=1.0, device=ctx.device)
        self.injector = FailureInjector(p["n_pods"], base_step_s=1.0, seed=ctx.seed)
        self.healthy = list(range(p["n_pods"]))

    def step(self, step: int) -> float:
        """One step of `repro_torch.launch.train`'s loop: the batch to the
        card, the train step, the loss on the host, the monitor."""
        from repro_torch.ft.failure import plan_elastic

        b = {k: v.to(self.ctx.device) for k, v in _batch(self.ctx, step, self.dm).items()}
        t0 = time.monotonic()
        self.params, self.opt_state, out = self.step_fn(self.params, self.opt_state, b)
        loss = float(out["loss"])
        dt = time.monotonic() - t0
        times = self.injector.step_times()
        times[self.healthy] = np.maximum(times[self.healthy], dt)
        self.monitor.record(times)
        self.healthy = plan_elastic(self.monitor, b["tokens"].shape[0], self.healthy).healthy
        return loss

    def first_moment_norms(self) -> dict:
        """Per leaf, |m| / (1 - b1): the clipped gradient of step one."""
        from repro_torch import tree

        name_of = {id(t): n for n, t in self.P.items()}
        return {name_of[id(p)]: float(torch.linalg.vector_norm(m)) / (1.0 - self.opt.b1)
                for p, m in zip(tree.leaves(self.params), tree.leaves(self.opt_state.m))}


def reference_steps(ctx, dm: dict, n_steps: int, cast=ref.identity, half_batch: bool = False):
    """The plain reference trains the seed's weights for ``n_steps``:
    (losses, step one's clipped per-leaf gradient norms, per-leaf change
    norms).  ``half_batch``: each loss over the first half of the rows
    only (a planted fault)."""
    dev = ctx.device
    dtype = getattr(torch, ctx.config["model"]["torch_dtype"])
    opt = dict(ctx.spec["program"]["optimizer"])
    opt = {"lr": opt["lr"], "b1": opt.get("b1", 0.9), "b2": opt.get("b2", 0.95),
           "eps": opt.get("eps", 1e-8), "weight_decay": opt.get("weight_decay", 0.01),
           "grad_clip": opt.get("grad_clip", 1.0), "warmup_steps": opt["warmup_steps"]}
    P = {n: ref.make_leaf(dm, n, ctx.seed, dev, dtype).float() for n in ref.LEAVES}
    state = {"step": 0, "m": {n: torch.zeros_like(p) for n, p in P.items()},
             "v": {n: torch.zeros_like(p) for n, p in P.items()}}
    losses, grad_norms = [], None
    for s in range(n_steps):
        b = _batch(ctx, s, dm)
        tok, lab = b["tokens"].to(dev), b["labels"].to(dev)
        if half_batch:
            tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
        for p in P.values():
            p.requires_grad_(True)
        loss = ref.loss(P, tok, lab, dm, cast)
        grads = torch.autograd.grad(loss, list(P.values()))
        loss = loss.detach()
        for p in P.values():
            p.requires_grad_(False)
        G = dict(zip(P, grads))
        del grads
        losses.append(loss.item())
        with torch.no_grad():
            gnorm = ref.adamw_step(P, G, state, opt, dtype)
        if s == 0:
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) if opt["grad_clip"] else 1.0
            grad_norms = {n: float(torch.linalg.vector_norm(g)) * scale for n, g in G.items()}
        del G
    return losses, grad_norms, _change_norms(P, dm, ctx.seed, dtype)


def leaf_gaps(got, want) -> list:
    """Per leaf, the relative gaps of its gradient and change norms (as
    `readings` measures them), for the run's notes."""
    (_, g1, d1), (_, g0, d0) = got, want
    gmed, dmed = statistics.median(g0.values()), statistics.median(d0.values())
    return [f"leaf {n}: grad {g1[n]:.6g} vs {g0[n]:.6g} ({abs(g1[n] - g0[n]) / max(g0[n], gmed):.3g}),"
            f" change {d1[n]:.6g} vs {d0[n]:.6g} ({abs(d1[n] - d0[n]) / max(d0[n], dmed):.3g})"
            for n in g0]


def readings(got, want) -> dict:
    """The numbers compared: the largest relative gap of a checked step's
    loss; of a leaf's gradient norm and of a leaf's change norm, each gap
    over the larger of the reference's norm of that leaf and of the median
    leaf.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change."""
    (l1, g1, d1), (l0, g0, d0) = got, want
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    gmed, dmed = statistics.median(g0.values()), statistics.median(d0.values())
    grad_gap = max(abs(g1[n] - g0[n]) / max(g0[n], gmed) for n in g0)
    moved = [n for n in d0 if g0[n] >= 1e-3 * gmed]
    upd_gap = max(abs(d1[n] - d0[n]) / max(d0[n], dmed) for n in moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "update_norm_gap": upd_gap}


def control(ctx, name: str) -> dict:
    """The numbers compared, read from the reference put in the program's
    place: ``fp8`` computes every product in float8 (e4m3, a scale per
    tensor), the precision below the configuration's bfloat16;
    ``half_batch`` takes each loss over half of the batch's rows."""
    dm = ref.dims(ctx.config)
    n = int(ctx.spec["mix"]["checked_steps"])
    want = reference_steps(ctx, dm, n)
    if name == "fp8":
        got = reference_steps(ctx, dm, n, cast=ref.fp8_cast)
    elif name == "half_batch":
        got = reference_steps(ctx, dm, n, half_batch=True)
    else:
        raise ValueError(f"unknown control {name!r}")
    return readings(got, want)


def run(ctx) -> core.Result:
    dm = ref.dims(ctx.config)
    t = ctx.spec["mix"]
    n_check = int(t["checked_steps"])
    prog = Program(ctx, dm)
    losses, grad_norms = [], None
    for s in range(n_check):
        losses.append(prog.step(s))
        if s == 0:
            grad_norms = prog.first_moment_norms()
    change = _change_norms(prog.P, dm, ctx.seed, prog.dtype)
    setup_peak = core.peak_bytes(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    setup_s = ctx.setup_s()
    step, steps = n_check, 0
    t_start = time.monotonic()
    while time.monotonic() - t_start < ctx.seconds:
        prog.step(step)
        step += 1
        steps += 1
    window_s = time.monotonic() - t_start          # each step ends in the loss's host read
    window_peak = core.peak_bytes(ctx.device)

    trace, traced = None, 0
    if ctx.trace:
        with profiled(ctx.device) as holder:
            for _ in range(int(t["traced_steps"])):
                prog.step(step)
                step += 1
                traced += 1
        trace = holder.trace
    memory_peak = max(setup_peak, window_peak, core.peak_bytes(ctx.device))
    del prog
    core.release(ctx.device)

    got = (losses, grad_norms, change)
    t_ref = time.monotonic()
    want = reference_steps(ctx, dm, n_check)
    t_ref = time.monotonic() - t_ref
    limits = ctx.spec["limits"]
    read = readings(got, want)
    checks = [core.Check(k, v, limits[k]) for k, v in read.items() if k in limits]
    uncompared = {k: v for k, v in read.items() if k not in limits}
    tokens = t["batch"] * t["seq_len"]
    return core.Result(
        e2e={"train_tokens_per_s": steps * tokens / window_s, "setup_s": setup_s},
        attempted=steps, failed=0, checks=checks, memory_peak_bytes=memory_peak,
        values={"window_s": window_s, "steps": steps, "batch": t["batch"],
                "seq_len": t["seq_len"], "window_peak_bytes": window_peak},
        trace=trace, trace_work={"steps": traced}, dims=dm,
        notes=[f"losses {got[0]} vs {want[0]}; reference {t_ref:.1f} s"
               + (f"; not compared: {uncompared}" if uncompared else "")] + leaf_gaps(got, want))

