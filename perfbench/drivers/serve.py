"""Serving driver: open-loop arrivals into the port's continuous-batching engine.

Set-up draws the weights from the seed (`perfbench.reference.lm`), builds
the program's model with the cell's attention path and its `ServeEngine`
(``n_slots`` sequences of ``cap`` tokens, on the card), makes the
arrivals (`perfbench.traffic.requests`: one Poisson schedule of sizes and
times for the cell, the prompts' tokens from the seed) and serves one
warm-up request.

The window submits each request when it falls due, between engine
steps, and steps the engine while anything is pending.  A request's time
to first token runs from when it was due to the end of the step that
produced its first token (the host has the token then); its queue wait
from when it was due to the start of the step that admitted it.  After
the window closes nothing more is submitted and the engine runs on until
every submitted request is done (at most ``drain_s``).  A traced run
reads its host spans and work from the whole window, which it does not
profile; after the drain it starts the profiler and replays, from the now
empty and warm engine, the arrivals due between ``trace_from`` and
``trace_to`` of the window, at their own gaps, until they are done: the
device trace comes from that replay, and the profiler's start-up stall
delays no measured request.

The engine decodes every active slot at the largest active length
(`repro_torch.serving.engine`: a shorter slot writes its new K/V at that
row and attends over the rows between, zeros where nothing was written).
The harness records, from the tokens each step produced, at which row
each request's fed token was decoded.  After the drain, requests sampled
from the seed among those finished (the longest always among them) are
run by the plain reference (`perfbench.reference.lm.serve`): a causal
prefill of the prompt, then each served token fed at its recorded row.
The numbers compared are the widest gaps by which a served token's
reference logit lies below the reference's best: of the first tokens
(prefill alone) and of the decoded ones.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.drivers.train import program_config, program_tree
from perfbench.harness import core
from perfbench.harness.trace import profiled
from perfbench.reference import lm as ref
from perfbench.traffic import requests as traffic


class Log:
    """What the harness saw of each request and step."""

    def __init__(self):
        self.due, self.admit, self.first, self.done = {}, {}, {}, {}
        self.positions = {}          # rid -> rows its fed tokens were decoded at
        self.tokens_in_window = 0
        # (start, end, prompt lengths admitted, valid rows of each decoded slot)
        self.steps = []


def _step(engine, live: dict, log: Log, t_close: float):
    """One engine step; what it produced goes into ``log``."""
    before = {rid: len(r.generated) for rid, r in live.items()}
    tb = time.monotonic()
    engine.step()
    te = time.monotonic()
    decoders, admitted = [], []
    for rid, r in list(live.items()):
        after = len(r.generated)
        if after == before[rid]:
            continue
        if before[rid] == 0:
            admitted.append(len(r.tokens))
            log.admit[rid], log.first[rid] = tb, te
        # every slot holding a request decodes, the newly admitted too: its
        # fed token sat at row len(prompt) + tokens before this decode - 1
        decoders.append((rid, len(r.tokens) + after - 2))
        if te <= t_close:
            log.tokens_in_window += after - before[rid]
        if r.done:
            log.done[rid] = te
            del live[rid]
    if decoders:
        row = max(n for _, n in decoders)
        for rid, _ in decoders:
            log.positions.setdefault(rid, []).append(row)
    log.steps.append((tb, te, admitted, [n + 1 for _, n in decoders]))


def _serve(engine, arrivals: list, seconds: float, log: Log, reqs: dict, rid0: int = 0):
    """Submit each of ``arrivals`` when it falls due (between engine steps,
    up to ``seconds`` from now) and step the engine while anything is
    pending; returns the clock's start and close and the requests
    still live."""
    from repro_torch.serving.engine import Request

    live = {}
    t_start = time.monotonic()
    t_close = t_start + seconds
    i = 0
    while True:
        now = time.monotonic()
        if now >= t_close:
            break
        while i < len(arrivals) and t_start + arrivals[i].due_s <= now:
            a = arrivals[i]
            r = Request(rid=rid0 + a.rid, tokens=a.prompt, max_new_tokens=a.max_new_tokens)
            engine.submit(r)
            live[r.rid] = reqs[r.rid] = r
            log.due[r.rid] = t_start + a.due_s
            i += 1
        if engine.pending:
            with record_function("perfbench.step"):
                _step(engine, live, log, t_close)
        else:
            nxt = t_start + arrivals[i].due_s if i < len(arrivals) else t_close
            time.sleep(max(min(nxt, t_close) - time.monotonic(), 0.0))
    return t_start, t_close, live


def _drain(engine, live: dict, log: Log, t_close: float, drain_s: float) -> None:
    drain_end = time.monotonic() + drain_s
    while engine.pending and time.monotonic() < drain_end:
        _step(engine, live, log, t_close)


def run(ctx) -> core.Result:
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServeEngine

    dm = ref.dims(ctx.config)
    t = ctx.spec["mix"]
    model = get_model(program_config(ctx.config, ctx.spec))
    dtype = getattr(torch, ctx.config["model"]["torch_dtype"])
    params = program_tree(model, ref.make_params(dm, ctx.seed, ctx.device, dtype))
    engine = ServeEngine(model, params, n_slots=t["n_slots"], cap=t["cap"], device=ctx.device)
    n = traffic.enough(t["rate_per_s"] * ctx.seconds)
    arrivals = traffic.schedule(ctx.seed, n, t, dm["vocab"])
    warm = traffic.schedule(ctx.seed + 1, 1, t, dm["vocab"])[0]
    engine.submit(Request(rid=-1, tokens=warm.prompt, max_new_tokens=2))
    engine.drain()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)

    setup_s = ctx.setup_s()
    log, reqs = Log(), {}
    t_start, t_close, live = _serve(engine, arrivals, ctx.seconds, log, reqs)
    _drain(engine, live, log, t_close, t["drain_s"])
    memory_peak = core.peak_bytes(ctx.device)

    holder, replay = None, Log()
    if ctx.trace:
        lo, hi = t["trace_from"] * ctx.seconds, t["trace_to"] * ctx.seconds
        again = [dataclasses.replace(a, due_s=a.due_s - lo)
                 for a in arrivals if lo <= a.due_s < hi]
        with profiled(ctx.device) as holder:
            _, r_close, r_live = _serve(engine, again, hi - lo, replay, {}, rid0=n)
            _drain(engine, r_live, replay, r_close, t["drain_s"])
    del engine, params, model
    core.release(ctx.device)

    due = list(log.due)
    missing = [rid for rid in due if rid not in log.done]
    ttft = [log.first[rid] - log.due[rid] for rid in due if rid in log.first]
    t_ref = time.monotonic()
    checks = reference_checks(ctx, dm, reqs, log)
    waiting = sum(1 for rid in due if log.admit.get(rid, float("inf")) > t_close)
    notes = [f"{len(due)} requests due in the window, {waiting} not yet admitted at its close, "
             f"{len(missing)} unfinished after the drain; ttft p50 "
             f"{1e3 * float(np.median(ttft)) if ttft else float('nan'):.1f} ms; "
             f"reference {time.monotonic() - t_ref:.1f} s"]
    if holder is not None:
        notes.append(f"traced replay: {len(replay.due)} requests, "
                     f"{sum(1 for rid in replay.due if rid not in replay.done)} unfinished")
    window_steps = [s for s in log.steps if s[0] < t_close]
    return core.Result(
        e2e={"ttft_p90_ms": 1e3 * float(np.percentile(ttft, 90)) if ttft else float("nan"),
             "gen_tokens_per_s": log.tokens_in_window / ctx.seconds, "setup_s": setup_s},
        attempted=len(due), failed=len(missing), checks=checks, memory_peak_bytes=memory_peak,
        values={"window_s": t_close - t_start,
                "prefill_lengths": [n for s in window_steps for n in s[2]],
                "decode_rows": [s[3] for s in window_steps]},
        spans={"queue_wait": [log.admit[rid] - log.due[rid] for rid in due if rid in log.admit],
               "decode_step": [te - tb for tb, te, adm, _ in window_steps if not adm]},
        trace=holder.trace if holder is not None else None,
        trace_work={"prefill_lengths": [n for s in replay.steps for n in s[2]],
                    "decode_rows": [s[3] for s in replay.steps]},
        dims=dm, notes=notes)


def control(ctx, name: str) -> dict:
    """The numbers compared, read from the reference put in the program's
    place: ``fp8`` runs the cell and, at each position of the sampled
    requests' prompts and served tokens, takes the token a float8 (e4m3,
    a scale per tensor) reference puts first."""
    if name != "fp8":
        raise ValueError(f"unknown control {name!r}")
    ctx.spec["control"] = name
    return {c.name: c.value for c in run(ctx).checks}


def sample(ctx, log: Log, reqs: dict) -> list:
    """Finished requests to check: ``sample_requests`` drawn from the seed,
    the longest (prompt and served tokens) always among them."""
    done = sorted(log.done)
    if not done:
        return []
    longest = max(done, key=lambda rid: len(reqs[rid].tokens) + len(reqs[rid].generated))
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 13]))
    rest = [rid for rid in done if rid != longest]
    k = min(int(ctx.spec["mix"]["sample_requests"]) - 1, len(rest))
    return [longest] + [int(x) for x in rng.choice(rest, size=k, replace=False)] if k else [longest]


def gaps(logits: torch.Tensor, served: list) -> np.ndarray:
    """Per position, the reference's best logit minus the served token's."""
    tok = torch.as_tensor(served, device=logits.device)
    return (logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]).double().cpu().numpy()


def reference_checks(ctx, dm: dict, reqs: dict, log: Log) -> list:
    """The sampled requests through the plain reference in float32."""
    dtype = getattr(torch, ctx.config["model"]["torch_dtype"])
    P = ref.make_params(dm, ctx.seed, ctx.device, dtype)
    first, decoded = 0.0, 0.0
    for rid in sample(ctx, log, reqs):
        r = reqs[rid]
        gen = [int(x) for x in r.generated]
        prompt = torch.as_tensor(np.asarray(r.tokens), device=ctx.device)
        args = (P, dm, prompt, gen[:-1], log.positions.get(rid, []), ctx.spec["mix"]["cap"])
        lg = ref.serve(*args)
        if ctx.spec.get("control") == "fp8":
            # the control: at each position of the same prompt and tokens,
            # the token the float8 reference puts first
            gen = ref.serve(*args, cast=ref.fp8_cast).argmax(-1).tolist()
        g = gaps(lg, gen)
        first = max(first, float(g[0]))
        if len(g) > 1:
            decoded = max(decoded, float(g[1:].max()))
    limits = ctx.spec["limits"]
    return [core.Check("first_token_gap", first, limits["first_token_gap"]),
            core.Check("decoded_token_gap", decoded, limits["decoded_token_gap"])]
